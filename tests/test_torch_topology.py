"""The port's copies of the topology search (``core/topology_search.py``)
and the operating-point tuner (``reshard/autotune.py``) against the JAX
package's, and the assertions of ``tests/test_topology_search.py`` and of
``tests/test_wire_quant.py``'s tuner cases run against the port.

The JAX package's search reads a TPU v5e's constants, the port's an H100's
(``launch/mesh.py``), so the comparisons give the JAX module the port's
constants. Both count parameters by building the model's shapes, which
takes the JAX package ~0.15 s a call; the comparisons count each config
once."""

from __future__ import annotations

import functools

import pytest
from hypothesis import given, settings, strategies as st

from repro import configs as jax_configs
from repro.core import topology_search as JT
from repro.models import model as JM
from repro.reshard import autotune as JA
from repro_torch import configs
from repro_torch.core import topology_search as TT
from repro_torch.launch import mesh as TM
from repro_torch.models import model as TMOD
from repro_torch.reshard import OperatingPoint, tune_operating_point
from repro_torch.reshard import autotune as TA
from repro_torch.reshard.engine import DEFAULT_STAGING_BYTES

NAMES = sorted(configs.REGISTRY)
# the families whose parameters the port can count (it builds their shapes)
COUNTED = [n for n in NAMES if configs.get_config(n).family in ("dense", "ssm")]
WORLDS = range(1, 17)
BATCH, SEQ = 32, 1024


def _par(p) -> tuple:
    return (p.dp, p.pp, p.tp, p.ep) if p is not None else None


def _cands(cands) -> list:
    return [(_par(c.parallel), c.step_time_s, c.mem_per_chip, c.transition_bytes, c.score) for c in cands]


@pytest.fixture
def same_constants(monkeypatch):
    """The JAX search on the port's constants, and both packages' parameter
    counts computed once a config."""
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES", "ICI_BW"):
        monkeypatch.setattr(JT, name, getattr(TM, name))
    defaults = JT.search.__defaults__  # (current, transition_weight, hbm_bytes, max_pp)
    monkeypatch.setattr(JT.search, "__defaults__", defaults[:2] + (TM.HBM_BYTES,) + defaults[3:])
    monkeypatch.setattr(JM, "analytic_param_count", functools.lru_cache(JM.analytic_param_count))
    monkeypatch.setattr(TMOD, "analytic_param_count", functools.lru_cache(TMOD.analytic_param_count))


def test_h100_constants():
    assert (TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.HBM_BYTES, TM.ICI_BW) == (989e12, 3.35e12, 80e9, 450e9)
    assert TT.search.__defaults__[2] == TM.HBM_BYTES


@pytest.mark.parametrize("name", NAMES)
def test_feasible_and_failover_equal_jax(name):
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    for world in WORLDS:
        for batch, max_pp in ((BATCH, 8), (8, 1)):
            got = TT.feasible_configs(cfg, world, batch, max_pp=max_pp)
            assert [_par(p) for p in got] == [_par(p) for p in JT.feasible_configs(jcfg, world, batch, max_pp=max_pp)]
            for p in got:
                jp = jax_configs.ParallelConfig(dp=p.dp, pp=p.pp, tp=p.tp)
                assert _par(TT.failover_target(cfg, p, batch, max_pp=max_pp)) == _par(
                    JT.failover_target(jcfg, jp, batch, max_pp=max_pp))


@pytest.mark.parametrize("name", COUNTED)
def test_estimates_search_and_targets_equal_jax(name, same_constants):
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    assert TMOD.analytic_param_count(cfg) == JM.analytic_param_count(jcfg)
    for world in WORLDS:
        for p in TT.feasible_configs(cfg, world, BATCH):
            jp = jax_configs.ParallelConfig(dp=p.dp, pp=p.pp, tp=p.tp)
            assert TT.estimate_step_time(cfg, p, BATCH, SEQ) == JT.estimate_step_time(jcfg, jp, BATCH, SEQ)
        got = TT.search(cfg, world, BATCH, SEQ)
        assert _cands(got) == _cands(JT.search(jcfg, world, BATCH, SEQ))
        if not got:
            with pytest.raises(ValueError):
                TT.best_target(cfg, world, BATCH, SEQ)
            continue
        best = TT.best_target(cfg, world, BATCH, SEQ)
        assert _par(best) == _par(JT.best_target(jcfg, world, BATCH, SEQ))
        jbest = jax_configs.ParallelConfig(dp=best.dp, pp=best.pp, tp=best.tp)
        for max_pp in (1, 8):
            assert [_par(p) for p in TT.likely_next_targets(cfg, best, 16, BATCH, SEQ, max_pp=max_pp)] == [
                _par(p) for p in JT.likely_next_targets(jcfg, jbest, 16, BATCH, SEQ, max_pp=max_pp)]


def test_transition_aware_search_equals_jax(same_constants):
    cfg, jcfg = configs.get_config("qwen3-1.7b").reduced(), jax_configs.get_config("qwen3-1.7b").reduced()
    for world in (2, 4, 8):
        for cur in TT.feasible_configs(cfg, world, 16):
            jcur = jax_configs.ParallelConfig(dp=cur.dp, pp=cur.pp, tp=cur.tp)
            assert _cands(TT.search(cfg, world, 16, 128, current=cur, transition_weight=1.0)) == _cands(
                JT.search(jcfg, world, 16, 128, current=jcur, transition_weight=1.0))
            assert [_par(p) for p in TT.likely_next_targets(cfg, cur, 8, 16, 128, transition_weight=1e-9)] == [
                _par(p) for p in JT.likely_next_targets(jcfg, jcur, 8, 16, 128, transition_weight=1e-9)]


@pytest.mark.parametrize("name", sorted(set(NAMES) - set(COUNTED)))
def test_unported_families_refuse_an_estimate(name):
    cfg = configs.get_config(name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.estimate_step_time(cfg, configs.ParallelConfig(), BATCH, SEQ)


def test_lifecycle_phase_targets_under_the_h100_constants():
    """The likely next targets ``chip_smoke.py``'s lifecycle phase prints:
    qwen3-1.7b on dp2tp2, batch 4 x 1024, one card's 80 GB."""
    cfg = configs.get_config("qwen3-1.7b")
    got = TT.likely_next_targets(cfg, configs.ParallelConfig(dp=2, tp=2), max_world=8, global_batch=4, seq_len=1024,
                                 max_pp=1)
    assert got and all(p.pp == 1 and p.world_size in (2, 8) and 4 % p.dp == 0 for p in got)


# ---------------------------------------------------------------------------
# tests/test_topology_search.py's assertions, against the port
# ---------------------------------------------------------------------------


def test_feasible_configs_respect_divisibility():
    cfg = configs.get_config("qwen3-1.7b")  # 28 periods
    cands = TT.feasible_configs(cfg, world=16, global_batch=32)
    assert cands
    for c in cands:
        assert c.world_size == 16 and 32 % c.dp == 0 and 28 % c.pp == 0


def test_search_returns_ranked_candidates():
    cands = TT.search(configs.get_config("qwen3-1.7b"), world=16, global_batch=32, seq_len=1024)
    assert cands == sorted(cands, key=lambda c: c.score)
    assert all(c.mem_per_chip <= TM.HBM_BYTES for c in cands)


def test_memory_filter_excludes_undersharded():
    """A 34B model's state (10 bytes a parameter) does not fit dp-only on 4
    cards of 80 GB (the JAX test takes 16 chips of 16 GiB). The estimate
    spreads the state over every rank, so at one world every layout fits
    or none does: on 4 cards none (85 GB a card), on 8 all (42.5 GB)."""
    cfg = configs.get_config("chameleon-34b")
    cands = TT.search(cfg, world=4, global_batch=32, seq_len=1024)
    for c in cands:
        assert c.parallel.tp * c.parallel.pp > 1, c
    assert cands == []
    assert len(TT.search(cfg, world=8, global_batch=32, seq_len=1024)) == len(TT.feasible_configs(cfg, 8, 32)) > 0


def test_transition_aware_search_prefers_nearby_layouts():
    cfg = configs.get_config("qwen3-1.7b").reduced()
    cur = configs.ParallelConfig(dp=1, tp=4)
    weighted = TT.search(cfg, 4, 16, 128, current=cur, transition_weight=1.0)
    assert weighted and weighted[0].parallel == cur and weighted[0].transition_bytes == 0
    assert all(c.transition_bytes > 0 for c in weighted if c.parallel != cur)


def test_best_target_integration_shape():
    """A dense model in place of the JAX test's mixtral-8x7b, whose experts
    the port cannot count yet."""
    t = TT.best_target(configs.get_config("qwen2.5-14b"), world=64, global_batch=256, seq_len=4096)
    assert t.world_size == 64


def test_no_feasible_raises():
    with pytest.raises(ValueError):
        TT.best_target(configs.get_config("qwen3-1.7b"), world=13, global_batch=16, seq_len=128)


# ---------------------------------------------------------------------------
# the operating-point tuner
# ---------------------------------------------------------------------------


def test_tuner_equals_jax_over_a_grid():
    assert TA.FALLBACK.to_dict() == JA.FALLBACK.to_dict()
    for name in ("ROUND_WINDOW_FRAC", "MIN_ROUND_S", "MAX_ROUND_S", "CHUNK_WINDOW_FRAC", "MIN_CHUNK_S", "MAX_CHUNK_S",
                 "MIN_CHUNK_BYTES", "STAGING_DEPTH", "FALLBACK_STREAM_K"):
        assert getattr(TA, name) == getattr(JA, name), name
    for plan_bytes in (0, 1, 1 << 20, 3 << 28, 1 << 34):
        for layers in (0, 1, 7, 28, 64):
            for window in (0.0, 0.3, 5.0, 30.0, 600.0):
                for bw in (None, 0.0, -1.0, 1e6, 5e8, 3.35e12):
                    for step in (None, 0.4):
                        got = tune_operating_point(plan_bytes, layers, window, bw, step)
                        assert got.to_dict() == JA.tune_operating_point(plan_bytes, layers, window, bw, step).to_dict()


def test_tuner_fallback_without_bandwidth():
    for bw in (None, 0.0, -1.0):
        assert tune_operating_point(1 << 30, 10, 30.0, bw) == TA.FALLBACK
    assert TA.FALLBACK.stream_k == TA.FALLBACK_STREAM_K
    assert TA.FALLBACK.staging_bytes == DEFAULT_STAGING_BYTES
    assert TA.FALLBACK.source == "fallback"
    assert tune_operating_point(0, 10, 30.0, 1e9).source == "fallback"
    assert tune_operating_point(1 << 20, 0, 30.0, 1e9).source == "fallback"


@settings(max_examples=25, deadline=None)
@given(
    plan_mb=st.integers(1, 4096),
    layers=st.integers(1, 64),
    w1=st.floats(0.0, 600.0),
    w2=st.floats(0.0, 600.0),
    bw_mb=st.floats(1.0, 1e5),
)
def test_tuner_monotone_in_window(plan_mb, layers, w1, w2, bw_mb):
    lo, hi = sorted((w1, w2))
    a = tune_operating_point(plan_mb << 20, layers, lo, bw_mb * 1e6)
    b = tune_operating_point(plan_mb << 20, layers, hi, bw_mb * 1e6)
    assert a.source == b.source == "measured"
    assert a.stream_k <= b.stream_k and a.chunk_bytes <= b.chunk_bytes
    for op in (a, b):
        assert 1 <= op.stream_k <= layers
        assert op.chunk_bytes <= op.staging_bytes <= DEFAULT_STAGING_BYTES


def test_operating_point_to_dict_roundtrip():
    op = tune_operating_point(100 << 20, 10, 30.0, 50e6)
    d = op.to_dict()
    assert OperatingPoint(**d) == op and d["source"] == "measured"
