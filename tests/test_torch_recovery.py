"""Fail-stop recovery in the port (DESIGN.md §15), against the JAX package
and against runs never interrupted, on the CPU.

- ``elastic/redundancy.py`` against its original: survivor sets, the
  redundancy map, donor balancing and ``heal_plan`` on the same specs and
  plans (reduced qwen3, and qwen3-1.7b at full width by metadata: the
  three pairs ``chip_smoke.py``'s ``phase_recovery`` recovers), and the XOR
  parity words and repaired bytes on the same numpy-seeded arrays;
- the four recovery cases of ``phase_recovery`` at reduced size, each from
  a fresh controller, bitwise against an uninterrupted run at the same step
  (the checkpoint rung: at the checkpoint's step): DP donors, the parity
  spare with the lost rank's regions poisoned, the fault matrix (idle,
  mid-stream, mid-commit under the int8 wire, no quant kernel inside the
  recovery) and the checkpoint rung;
- the typed ``RecoveryError`` of every rung left empty, the hand-on of a
  session's and a residual shadow's destination tensors (no second set),
  ``peer_coverage``, the two prewarms' bookkeeping, and the launcher's
  ``--ckpt-dir`` / ``--failstop``."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.reshard import plan_state_transfer as jax_plan_state_transfer
from repro.core.resource_view import build_tensor_specs as jax_build_tensor_specs
from repro.elastic import redundancy as JRD
from repro_torch import configs
from repro_torch.core.controller import LiveRController
from repro_torch.core.errors import RecoveryError
from repro_torch.core.reshard import named_state_leaves, plan_state_transfer
from repro_torch.core.resource_view import build_tensor_specs
from repro_torch.core.world_pool import WorldPool
from repro_torch.elastic import FaultInjector, controller_phase
from repro_torch.elastic import redundancy as RD
from repro_torch.kernels import ops
from repro_torch.optim import AdamWConfig
from repro_torch.reshard import WirePolicy

torch.set_num_threads(2)

P = configs.ParallelConfig
JP = jax_configs.ParallelConfig
CFG = configs.get_config("qwen3-1.7b").reduced()
JCFG = jax_configs.get_config("qwen3-1.7b").reduced()
FULL, JFULL = configs.get_config("qwen3-1.7b"), jax_configs.get_config("qwen3-1.7b")
OPT = AdamWConfig(learning_rate=1e-3, warmup_steps=5)


def _tasks(plan):
    return [dataclasses.astuple(t) for t in plan.tasks]


def _specs(cfg=CFG, jcfg=JCFG):
    return (build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False),
            jax_build_tensor_specs(jcfg, include_optimizer=True, zero_sharding=False))


# ---------------------------------------------------------------------------
# The redundancy layer against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,lost,target,failed", [
    (dict(dp=2, tp=2), (1, 3), None, True),
    (dict(dp=2, tp=2), (), dict(dp=1, tp=2), True),
    (dict(dp=2, tp=2), (), dict(dp=1, tp=2), False),
    (dict(dp=1, tp=4), (3,), dict(dp=1, tp=2), True),
])
def test_survivors_equal_jax(src, lost, target, failed):
    ours = RD.survivors_for(P(**src), lost, target=target and P(**target), devices_failed=failed)
    theirs = JRD.survivors_for(JP(**src), lost, target=target and JP(**target), devices_failed=failed)
    assert ours == theirs


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("src,lost", [(dict(dp=2, tp=2), (0, 1)), (dict(dp=2, tp=2), (2, 3)), (dict(dp=1, tp=4), (3,))])
def test_redundancy_map_equals_jax(full, src, lost):
    specs, jspecs = _specs(FULL, JFULL) if full else _specs()
    ours = RD.RedundancyMap.build(specs, P(**src), RD.survivors_for(P(**src), lost))
    theirs = JRD.RedundancyMap.build(jspecs, JP(**src), JRD.survivors_for(JP(**src), lost))
    assert [dataclasses.astuple(c) for c in ours.covers] == [dataclasses.astuple(c) for c in theirs.covers]
    assert (ours.complete, ours.uncovered_bytes, ours.donor_load()) == (
        theirs.complete, theirs.uncovered_bytes, theirs.donor_load())


def _recovery_plans(cfg, jcfg, src, dst, lost):
    """The survivor-constrained plan of both packages, healed when it has
    lost cells, then donor-balanced: what ``fail_stop_recover`` runs."""
    out = []
    for mod, Pc, plan_fn, c in ((RD, P, plan_state_transfer, cfg), (JRD, JP, jax_plan_state_transfer, jcfg)):
        survivors = mod.survivors_for(Pc(**src), lost, target=Pc(**dst))
        specs, plan = plan_fn(c, Pc(**src), Pc(**dst), allowed_src=survivors)
        raw = plan
        healed, parity = mod.heal_plan(plan, specs) if plan.lost_tasks() else (plan, 0)
        out.append((raw, healed, parity, mod.balance_donors(healed, specs, survivors)))
    return out


# the three full-width pairs of phase_recovery (GB, from the JAX planner):
# lost (0, 1): every cell remote from donors 2 and 3; lost 3 at dp1tp4:
# remote, local and lost cells
FULL_PAIRS = [
    (dict(dp=2, tp=2), dict(dp=1, tp=2), (2, 3), dict(remote=0, local=0, lost=0)),
    (dict(dp=2, tp=2), dict(dp=1, tp=2), (0, 1), dict(remote=24.38, local=0, lost=0)),
    (dict(dp=1, tp=4), dict(dp=1, tp=2), (3,), dict(remote=12.19, local=6.10, lost=6.10)),
]


@pytest.mark.parametrize("src,dst,lost,gb", FULL_PAIRS)
def test_full_width_recovery_plans_equal_jax(src, dst, lost, gb):
    (raw, healed, parity, bal), (jraw, jhealed, jparity, jbal) = _recovery_plans(FULL, JFULL, src, dst, lost)
    assert _tasks(raw) == _tasks(jraw) and _tasks(healed) == _tasks(jhealed) and _tasks(bal) == _tasks(jbal)
    assert parity == jparity == raw.lost_bytes
    kinds = raw.kind_bytes()
    got = {k: round(kinds.get(k, 0) / 1e9, 2) for k in ("remote", "local", "lost")}
    assert got == gb
    if lost == (0, 1):
        assert {t.src_rank for t in bal.tasks if t.kind == "remote"} == {2, 3}


@pytest.mark.parametrize("src,dst,lost", [
    (dict(dp=4, tp=1), dict(dp=2, tp=1), ()),
    (dict(dp=2, tp=2), dict(dp=1, tp=2), (0, 1)),
    (dict(dp=1, tp=4), dict(dp=1, tp=2), (3,)),
    (dict(dp=1, tp=4), dict(dp=1, tp=2), ()),
])
def test_reduced_recovery_plans_equal_jax(src, dst, lost):
    (raw, healed, parity, bal), (jraw, jhealed, jparity, jbal) = _recovery_plans(CFG, JCFG, src, dst, lost)
    assert _tasks(raw) == _tasks(jraw) and _tasks(healed) == _tasks(jhealed) and _tasks(bal) == _tasks(jbal)
    assert parity == jparity and bal.network_bytes == healed.network_bytes


def test_full_width_parity_word_is_the_jax_width():
    """The dp1tp4 word of qwen3-1.7b's training state: 6.10 GB, by metadata."""
    specs, jspecs = _specs(FULL, JFULL)
    store = RD.ParityStore(specs, P(dp=1, tp=4))
    theirs = sum(
        max(int(np.prod([hi - lo for lo, hi in b])) * np.dtype(s.dtype).itemsize
            for b, _ in JRD._shard_groups(s, JP(dp=1, tp=4)))
        for s in jspecs
    )
    assert sum(store._width.values()) == theirs and round(theirs / 1e9, 2) == 6.10


def _named(specs, seed=0):
    rng = np.random.default_rng(seed)
    return {s.name: rng.standard_normal(s.shape).astype(np.dtype(s.dtype)) for s in specs}


def _poison(named, specs, cfg, rank, groups, set_region):
    for s in specs:
        for bounds, owners in groups(s, cfg):
            if owners == [rank]:
                set_region(named, s.name, tuple(slice(lo, hi) for lo, hi in bounds))


@pytest.mark.parametrize("src,lost", [(dict(dp=1, tp=2), 1), (dict(dp=1, tp=4), 3), (dict(dp=2, tp=2), 3)])
def test_parity_words_and_repair_equal_jax(src, lost):
    specs, jspecs = _specs()
    cfg, jcfg = P(**src), JP(**src)
    named = _named(jspecs)
    jstore, store = JRD.ParityStore(jspecs, jcfg), RD.ParityStore(specs, cfg)
    assert jstore.refresh(named, step=5) == store.refresh({k: torch.from_numpy(v.copy()) for k, v in named.items()}, 5)
    assert store.covers(5) and not store.covers(6) and store.refreshed_bytes == jstore.refreshed_bytes
    assert sorted(store._parity) == sorted(jstore._parity)
    for name, word in jstore._parity.items():
        assert store._parity[name].dtype == torch.uint8
        np.testing.assert_array_equal(store._parity[name].numpy(), word, err_msg=name)

    def np_set(d, name, sl):
        d[name][sl] = -777.0

    def t_set(d, name, sl):
        d[name][sl] = -777.0

    jpoisoned = {k: v.copy() for k, v in named.items()}
    _poison(jpoisoned, jspecs, jcfg, lost, JRD._shard_groups, np_set)
    poisoned = {k: torch.from_numpy(v.copy()) for k, v in named.items()}
    _poison(poisoned, specs, cfg, lost, RD._shard_groups, t_set)
    live = dict(poisoned)
    jpatched, jrepaired = jstore.repair(jpoisoned, frozenset({lost}), step=5)
    patched, repaired = store.repair(poisoned, frozenset({lost}), step=5)
    assert repaired == jrepaired
    assert (repaired > 0) == (src["dp"] == 1)
    for name, want in named.items():
        assert patched[name] is live[name]  # repaired in place
        np.testing.assert_array_equal(patched[name].numpy(), jpatched[name], err_msg=name)
        np.testing.assert_array_equal(patched[name].numpy(), want, err_msg=name)


def test_parity_word_is_a_copy_of_the_live_bytes():
    """A CPU state updated in place after the refresh leaves the word as it
    was (the word never shares the live tensors' storage)."""
    specs, _ = _specs()
    named = {k: torch.from_numpy(v) for k, v in _named(specs).items()}
    store = RD.ParityStore(specs, P(dp=1, tp=2))
    store.refresh(named, 1)
    words = {k: w.clone() for k, w in store._parity.items()}
    for x in named.values():
        x.add_(1.0)
    assert all(torch.equal(store._parity[k], w) for k, w in words.items())


def test_stale_parity_and_double_loss_raise_before_writing():
    specs, _ = _specs()
    named = {k: torch.from_numpy(v) for k, v in _named(specs).items()}
    before = {k: v.clone() for k, v in named.items()}
    store = RD.ParityStore(specs, P(dp=1, tp=4))
    store.refresh(named, step=3)
    with pytest.raises(RecoveryError):  # stale: the survivors moved on
        store.repair(named, frozenset({3}), step=4)
    with pytest.raises(RecoveryError):  # two groups of one tensor died
        store.repair(named, frozenset({2, 3}), step=3)
    assert all(torch.equal(named[k], v) for k, v in before.items())


# ---------------------------------------------------------------------------
# The four recovery cases at reduced size, against an uninterrupted run
# ---------------------------------------------------------------------------


def _make(parallel, **kw):
    return LiveRController(CFG, parallel, OPT, seq_len=16, global_batch=4, seed=0, device="cpu", **kw)


def _state(c) -> dict:
    named, extras = named_state_leaves(c.params, c.opt_state)
    return {**{k: v.clone() for k, v in named.items()}, "count": extras["count"].clone()}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def control():
    """The uninterrupted run: losses, and the state after each step."""
    c = _make(P(dp=2, tp=2))
    states, losses = [_state(c)], []
    for _ in range(10):
        losses += c.train_steps(1)
        states.append(_state(c))
    return losses, states


def _after(c, control, n=2):
    """The recovered state is the control's at this step, and the next
    ``n`` losses are the control's."""
    losses, states = control
    assert _equal(_state(c), states[c.step]), f"state differs from the uninterrupted run at step {c.step}"
    step = c.step
    assert c.train_steps(n) == losses[step : step + n]


def test_dp_donors_recover_bitwise(control):
    c = _make(P(dp=2, tp=2))
    c.train_steps(3)
    rep = FaultInjector(c).kill(P(dp=1, tp=2), lost_ranks=(0, 1))
    rec = c.records[-1]
    assert (rep.mode, rep.outcome, rep.step_before, rep.step_after) == ("peer_recover", "committed", 3, 3)
    assert rec.donors == 2 and rec.lost_devices == 2 and rec.parity_bytes == 0
    # every byte of the state crosses from the donors once (the plan counts
    # the replicated norms once a destination rank)
    state_bytes = sum(s.nbytes for s in build_tensor_specs(CFG, include_optimizer=True, zero_sharding=False))
    assert rec.executed_bytes == state_bytes < rec.plan_network_bytes and rec.generic_cells == 0
    assert c.world.parallel == P(dp=1, tp=2)
    _after(c, control)


def test_parity_spare_recovers_poisoned_state_bitwise(control):
    SRC, T = P(dp=1, tp=4), P(dp=1, tp=2)
    c = _make(SRC, parity_every=1)
    c.train_steps(3)
    assert c._parity.covers(3) and c._parity.last_refresh_s > 0 and c._parity.refreshed_bytes > 0
    # poison what rank 3 alone held, after the last refresh: the recovery
    # must rebuild it from the word, never read it
    specs = build_tensor_specs(CFG, include_optimizer=True, zero_sharding=False)
    named, _ = named_state_leaves(c.params, c.opt_state)
    _poison(named, specs, SRC, 3, RD._shard_groups, lambda d, n, sl: d[n][sl].fill_(-777.0))
    assert not _equal(_state(c), control[1][3])
    _, plan = plan_state_transfer(CFG, SRC, T, allowed_src=RD.survivors_for(SRC, (3,)))
    rep = FaultInjector(c).kill(T, lost_ranks=(3,))
    assert (rep.mode, rep.step_after) == ("peer_recover", 3)
    assert rep.parity_bytes == plan.lost_bytes > 0
    assert c._parity is None  # the word XORs the old layout
    _after(c, control)


@pytest.mark.parametrize("phase", ["idle", "mid_stream", "mid_commit"])
def test_fault_matrix_ends_committed_bitwise(control, phase):
    """Under the int8 moment wire, streaming toward dp2tp4 (3 rounds of 2
    layers), lose ranks 2 and 3: the recovery to dp1tp2 is lossless, moves
    no byte, and drops the session's pre-copied carries."""
    c = _make(P(dp=2, tp=2), overlap="stream", stream_k=2, wire_policy=WirePolicy())
    c.train_steps(3)
    quant = {"n": 0}
    recover = c.fail_stop_recover

    def counted(*args, **kwargs):
        calls = []
        orig = (ops.pack_quant_rows, ops.dequant_scatter_rows)
        ops.pack_quant_rows = lambda *a, **k: calls.append(1) or orig[0](*a, **k)
        ops.dequant_scatter_rows = lambda *a, **k: calls.append(1) or orig[1](*a, **k)
        try:
            return recover(*args, **kwargs)
        finally:
            ops.pack_quant_rows, ops.dequant_scatter_rows = orig
            quant["n"] = len(calls)

    c.fail_stop_recover = counted
    rep = FaultInjector(c).inject(phase, P(dp=1, tp=2), lost_ranks=(2, 3), resize_target=P(dp=2, tp=4))
    assert rep.phase == phase and controller_phase(c) == "idle"
    assert (rep.mode, rep.outcome) == ("peer_recover", "committed") and rep.step_before == rep.step_after
    assert quant["n"] == 0 and c.records[-1].moved_bytes == 0
    assert not c.reconfig_pending and c._session is None and c.world.parallel == P(dp=1, tp=2)
    _after(c, control)


def test_checkpoint_rung_rolls_back_bitwise(control, tmp_path):
    c = _make(P(dp=1, tp=4), ckpt_dir=str(tmp_path))
    c.train_steps(2)
    c.checkpoint_now()
    assert c._ckpt.last_snapshot_seconds is not None and c._ckpt.last_save_seconds is not None
    c.train_steps(2)
    rep = FaultInjector(c).kill(P(dp=1, tp=2), lost_ranks=(3,))
    rec = c.records[-1]
    assert (rep.mode, rep.outcome, rep.step_before, rep.step_after) == ("fallback", "fell_back", 4, 2)
    assert rep.demoted and rec.transfer_s > 0 and c.world.parallel == P(dp=1, tp=2)
    _after(c, control)


# ---------------------------------------------------------------------------
# Rungs left empty, hand-ons, coverage, prewarms
# ---------------------------------------------------------------------------


def test_no_rung_left_raises_typed_errors(tmp_path):
    c = _make(P(dp=1, tp=4))
    c.train_steps(1)
    with pytest.raises(RecoveryError, match="no checkpoint directory"):
        c.fail_stop_recover(P(dp=1, tp=2), lost_ranks=(3,))
    c = _make(P(dp=1, tp=4), ckpt_dir=str(tmp_path / "empty"))
    with pytest.raises(RecoveryError, match="no durable checkpoint"):
        c.fail_stop_recover(P(dp=1, tp=2), lost_ranks=(3,))
    c = _make(P(dp=1, tp=4), parity_every=1)
    c.train_steps(1)
    with pytest.raises(RecoveryError):  # one word repairs one group a tensor
        c.fail_stop_recover(P(dp=1, tp=2), lost_ranks=(2, 3))


def _pointers(tensors) -> set[int]:
    return {t.untyped_storage().data_ptr() for t in tensors}


def test_recovery_takes_the_session_tensors_mid_stream(monkeypatch):
    """Mid-stream toward dp2tp4 under the int8 moment wire, a warned loss
    recovers to dp1tp4 (every tp-split tensor moves): losslessly, by the
    row kernels and no quant kernel, into the drained session's carries and
    buffers, not a second set."""
    c = _make(P(dp=2, tp=2), overlap="stream", stream_k=2, wire_policy=WirePolicy())
    c.train_steps(1)
    c.request_resize(P(dp=2, tp=4))
    c.wait_shadow_ready()
    c.train_steps(1)
    assert controller_phase(c) == "mid_stream"
    ex = c._session.executor
    held = _pointers([*ex.dst.values(), *ex.dst_buffers.values()])
    live = _pointers(named_state_leaves(c.params, c.opt_state)[0].values())
    before = _state(c)
    calls = []
    for name in ("pack_quant_rows", "dequant_scatter_rows", "pack_rows"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _o=orig, **k: calls.append(_n) or _o(*a, **k))
    rec = c.fail_stop_recover(P(dp=1, tp=4), devices_failed=False)
    moved = _pointers(named_state_leaves(c.params, c.opt_state)[0].values()) - live
    assert rec.executed_bytes > 0 and moved and moved <= held
    assert "pack_rows" in calls and "pack_quant_rows" not in calls and "dequant_scatter_rows" not in calls
    assert _equal(_state(c), before) and rec.wire_bytes == rec.logical_bytes


def test_recovery_takes_a_residual_shadow():
    """A ready shadow built for the recovery's target is its world, and its
    destination tensors the stream's."""
    c = _make(P(dp=2, tp=2), overlap="stream")
    c.train_steps(1)
    c.request_resize(P(dp=1, tp=4))
    c.wait_shadow_ready()
    shadow = c._builder.result()
    held = _pointers(shadow.buffers.values())
    rec = c.fail_stop_recover(P(dp=1, tp=4), devices_failed=False)
    assert rec.prepare_source == "residual" and c.world is shadow and not shadow.buffers
    assert _pointers(named_state_leaves(c.params, c.opt_state)[0].values()) & held


def test_peer_coverage():
    c = _make(P(dp=1, tp=4))
    c.train_steps(1)
    assert c.peer_coverage(P(dp=1, tp=2), lost_ranks=(3,))[0] is False
    c._refresh_parity()
    covered, wire = c.peer_coverage(P(dp=1, tp=2), lost_ranks=(3,))
    _, plan = plan_state_transfer(CFG, P(dp=1, tp=4), P(dp=1, tp=2), allowed_src=frozenset({0, 1, 2}))
    assert covered and wire == plan.network_bytes + plan.lost_bytes
    assert _make(P(dp=2, tp=2)).peer_coverage(P(dp=1, tp=2)) == (True, 0)


def test_prewarms_plan_the_pair_and_the_recovery_takes_the_plan(control):
    """prewarm_transfer needs a pooled world for the target, plans the pair
    once, moves nothing; the recovery of that pair and survivor set takes
    its plan. prewarm_failover_ahead warms (incoming -> pooled) pairs that
    do not grow, nearest size first."""
    A, T = P(dp=2, tp=2), P(dp=1, tp=2)
    c = _make(A, world_pool=WorldPool(capacity=3))
    assert c.prewarm_transfer(T) is False  # no pooled world for T yet
    c.train_steps(1)
    c.prefetch_world(T)
    c._spec_builders[c.pool_key(T)].result(60)
    c._harvest_spec_builders()
    before = _state(c)
    assert c.prewarm_transfer(T) is True and c.prewarm_transfer(T) is False
    c._prewarm_thread.join(60)
    key = (A, T, RD.survivors_for(A, (), target=T))
    assert key in c._prewarmed_plans and _equal(_state(c), before)
    rec = c.fail_stop_recover(T)
    assert key not in c._prewarmed_plans and rec.prepare_source == "pool"
    _after(c, control)

    c = _make(P(dp=2, tp=2), world_pool=WorldPool(capacity=3))
    for t in (P(dp=1, tp=2), P(dp=2, tp=4), P(dp=1, tp=4)):
        c.prefetch_world(t)
        c._spec_builders[c.pool_key(t)].result(60)
        c._harvest_spec_builders()
    assert c.prewarm_failover_ahead() == 0  # no resize in flight
    c.request_resize(P(dp=1, tp=4))
    assert c.prewarm_failover_ahead() == 1
    c._prewarm_thread.join(60)
    # dp2tp4 grows past dp1tp4: only dp1tp2 is a failover pair
    assert c._prewarmed_pairs == {(P(dp=1, tp=4), P(dp=1, tp=2))}
    c.wait_shadow_ready()


@pytest.mark.parametrize("dp,tp,mode", [(2, 2, "peer_recover"), (1, 4, "fallback")])
def test_launcher_checkpoints_and_recovers(tmp_path, monkeypatch, capsys, dp, tp, mode):
    from repro_torch.launch import train

    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--dp", str(dp), "--tp", str(tp),
        "--steps", "12", "--seq", "16", "--batch", "4", "--ckpt-dir", str(tmp_path), "--ckpt-interval", "5",
        "--failstop", "8:dp1,tp2",
    ])
    train.main()
    out = capsys.readouterr().out
    assert f"recovered via {mode}" in out and "[done] 12 steps" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000005", "step_00000010"]
