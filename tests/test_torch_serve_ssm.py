"""Serving mamba2-2.7b on the port, held against the JAX package: the
SSD/conv cache specs, the serving plans task by task, the port's
LiveExecutor against the JAX byte oracle (``SimExecutor`` over per-rank
numpy shards) on ``tests/test_serve_reshard.py``'s three cache
transitions, and a generation that crosses three live resizes, token for
token equal to the port's uninterrupted run, which equals the JAX
package's ``ServeSession``.

The JAX side stays on a tp-only world: its ssm legs are pinned there
because of an XLA CPU SPMD miscompile of the mamba mixer
(``tests/test_models.py``, DESIGN.md §16). The port runs every world on
one device, so its dp-changing legs are held against its own uninterrupted
run."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.resource_view import view_of
from repro.core.streaming import allocate_destination, execute_plan, materialize_rank
from repro.models import model as JM
from repro.serve import LiveServeController as JaxController
from repro.serve import ServeSession as JaxSession
from repro.serve import cache_view as JC
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch import configs
from repro_torch.core import intersection as I
from repro_torch.core.events import ResizeEvent
from repro_torch.core.resource_view import itemsize
from repro_torch.models.convert import params_from_jax
from repro_torch.reshard import LiveExecutor, ReshardEngine
from repro_torch.serve import cache_view as C
from repro_torch.serve.controller import LiveServeController
from repro_torch.serve.driver import serve_once
from repro_torch.serve.loop import ServeSession

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ARCH = "mamba2-2.7b"
BUDGET = 8192
CPU = torch.device("cpu")
# tests/test_serve_reshard.py's cache transitions: (name, src (dp, tp), dst)
TRANSITIONS = [
    ("tp_change", (1, 2), (1, 4)),
    ("dp_change", (1, 2), (2, 2)),
    ("tp_preserve", (2, 2), (1, 2)),
]


def _astuples(items):
    return [dataclasses.astuple(x) for x in items]


def _pcs(a, b):
    return (configs.ParallelConfig(dp=a[0], tp=a[1]), configs.ParallelConfig(dp=b[0], tp=b[1])), (
        jax_configs.ParallelConfig(dp=a[0], tp=a[1]),
        jax_configs.ParallelConfig(dp=b[0], tp=b[1]),
    )


def _reduced():
    return configs.get_config(ARCH).reduced(), jax_configs.get_config(ARCH).reduced()


# ---------------------------------------------------------------------------
# Specs and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_cache_specs_equal_jax(reduced):
    """Names, shapes, dtypes (float32 whatever the cache dtype), roles and
    scopes of the ssd/conv leaves; at full width 1.375 GB for 8 slots."""
    port, ref = _reduced() if reduced else (configs.get_config(ARCH), jax_configs.get_config(ARCH))
    for batch, max_seq, dtype in [(2, 16, "float32"), (8, 544, "bfloat16")]:
        ours = C.cache_tensor_specs(port, batch, max_seq, dtype)
        assert _astuples(ours) == _astuples(JC.cache_tensor_specs(ref, batch, max_seq, cache_dtype=dtype))
        assert [s.name for s in ours] == ["cache/pos0/ssd", "cache/pos0/conv"]
        assert all(s.dtype == "float32" for s in ours)
    if not reduced:
        assert sum(s.nbytes for s in C.cache_tensor_specs(port, 8, 544, "bfloat16")) == 1_375_207_424


def test_reduced_serve_state_specs_equal_jax():
    port, ref = _reduced()
    assert _astuples(C.serve_state_specs(port, 4, 32, "float32")) == _astuples(
        JC.serve_state_specs(ref, 4, 32, cache_dtype="float32")
    )


@pytest.mark.parametrize("name,a,b", TRANSITIONS)
def test_serve_plan_equals_jax(name, a, b):
    """Params + cache, task by task (tensor, kind, ranks, bounds, offsets,
    bytes, layer), tiling every destination view once."""
    port, ref = _reduced()
    ours, theirs = _pcs(a, b)
    specs = C.serve_state_specs(port, 4, 32, "float32")
    plan = C.serve_plan(port, specs, *ours)
    want = JC.serve_plan(ref, JC.serve_state_specs(ref, 4, 32, cache_dtype="float32"), *theirs)
    assert _astuples(plan.tasks) == _astuples(want.tasks)
    assert (plan.network_bytes, plan.local_bytes, plan.resident_bytes) == (
        want.network_bytes, want.local_bytes, want.resident_bytes,
    )
    assert plan.resident_layers() == want.resident_layers()
    I.verify_completeness(specs, plan, ours[1])
    if name == "tp_preserve":
        assert plan.network_bytes == plan.local_bytes == 0 and plan.resident_layers() == plan.layers()


@pytest.mark.parametrize("a,b", [((2, 2), (1, 2)), ((1, 2), (1, 4)), ((1, 4), (2, 2))])
def test_full_width_serve_plan_matches_jax_up_to_dtype(a, b):
    """mamba2-2.7b at full width, 8 slots x 544 positions (the card's
    elastic resizes): the JAX planner's tasks, each task's bytes scaled by
    the itemsize the port serves that tensor in (bf16 matrices; the six
    fp32 mixer leaves, the norm scales and the cache stay float32)."""
    port, ref = configs.get_config(ARCH), jax_configs.get_config(ARCH)
    ours, theirs = _pcs(a, b)
    specs = C.serve_state_specs(port, 8, 544, "bfloat16")
    jspecs = JC.serve_state_specs(ref, 8, 544, cache_dtype="bfloat16")
    plan = C.serve_plan(port, specs, *ours)
    want = JC.serve_plan(ref, jspecs, *theirs)
    ours_itemsize = {s.name: itemsize(s.dtype) for s in specs}
    jax_itemsize = {s.name: np.dtype(s.dtype).itemsize for s in jspecs}
    assert {s.name for s in specs if s.dtype == "float32" and s.collection == "params"} == {
        f"params/blocks/pos0/mixer/{n}" for n in ("A_log", "dt_bias", "D", "conv_w", "conv_b", "norm_scale")
    } | {"params/blocks/pos0/ln1/scale", "params/final_norm/scale"}
    assert len(plan.tasks) == len(want.tasks)
    for got, exp in zip(plan.tasks, want.tasks):
        scaled = exp.nbytes // jax_itemsize[exp.tensor] * ours_itemsize[exp.tensor]
        assert dataclasses.astuple(got) == dataclasses.astuple(dataclasses.replace(exp, nbytes=scaled))


# ---------------------------------------------------------------------------
# The port's LiveExecutor against the JAX byte oracle (the mamba2 leg of
# tests/test_serve_reshard.py::_CACHE_PARITY_SNIPPET)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,a,b", TRANSITIONS)
def test_live_executor_delivers_the_oracle_bytes(name, a, b):
    port, ref = _reduced()
    (ca, cb), (ja, jb) = _pcs(a, b)
    specs = C.cache_tensor_specs(port, 4, 32, "float32")
    jspecs = JC.cache_tensor_specs(ref, 4, 32, cache_dtype="float32")
    rng = np.random.default_rng(0)
    g = {s.name: rng.normal(size=s.shape).astype(np.float32) for s in specs}
    plan = C.serve_plan(port, specs, ca, cb)
    src = {r: materialize_rank(jspecs, ja, r, g) for r in range(ja.world_size)}
    dst = {r: allocate_destination(jspecs, jb, r) for r in range(jb.world_size)}
    sim = execute_plan(JC.serve_plan(ref, jspecs, ja, jb), src, dst, staging_bytes=BUDGET)

    def live(delta):
        tensors = {s.name: torch.from_numpy(g[s.name].copy()) for s in specs}
        ex = LiveExecutor({s.name: s for s in specs}, tensors, [CPU] * ca.world_size, [CPU] * cb.world_size, BUDGET)
        stats = ReshardEngine(plan, ex, staging_bytes=BUDGET, delta=delta).run()
        ex.block_until_ready()
        return ex, stats

    ex, stats = live(True)
    for field in ("network_bytes", "local_bytes", "resident_bytes", "layers_streamed"):
        assert getattr(stats, field) == getattr(sim, field), field
    stats.assert_bounded(BUDGET)
    for s in specs:
        got = ex.results()[s.name].numpy()
        np.testing.assert_array_equal(got, g[s.name], err_msg=s.name)
        for r in range(jb.world_size):
            v = view_of(s, jb, r)
            if v is None or s.name not in dst[r].shards:
                continue
            sl = tuple(slice(lo, hi) for lo, hi in v.bounds)
            np.testing.assert_array_equal(got[sl], dst[r].shards[s.name], err_msg=f"{s.name}/rank{r}")
    if name == "tp_preserve":
        # resident skip: nothing planned, nothing executed, on both sides;
        # the full-copy baseline moves every cache byte
        assert plan.network_bytes == plan.local_bytes == 0
        assert sim.executed_bytes == stats.executed_bytes == 0 and ex.resident_passthroughs > 0
        base_ex, base = live(False)
        assert base.resident_bytes == 0 and base.local_bytes == plan.resident_bytes
        assert base_ex.executed_bytes == sum(s.nbytes for s in specs)
        for s in specs:
            np.testing.assert_array_equal(base_ex.results()[s.name].numpy(), g[s.name])
    else:
        assert stats.executed_bytes > 0


# ---------------------------------------------------------------------------
# Elastic serving end to end, reduced mamba2 on the CPU
# ---------------------------------------------------------------------------

N_SLOTS, PLEN, GEN, MAX_SEQ = 4, 16, 10, 32
# dp2tp2 -> dp1tp2 (tp kept: every cell resident) -> dp1tp4 -> dp2tp2
TRACE = [((1, 2), 3.0), ((1, 4), 5.0), ((2, 2), 7.0)]


@pytest.fixture(scope="module")
def runs():
    """The port's uninterrupted and resized sessions and the JAX package's
    uninterrupted one (tp-only world), all from the JAX package's seed-0
    weights."""
    cfg, jcfg = _reduced()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PLEN) for _ in range(6)]
    jparams = jax_tree_paths(JM.init_params(jcfg, jax.random.key(0)))

    def port_run(trace):
        ctrl = LiveServeController(cfg, configs.ParallelConfig(dp=2, tp=2), N_SLOTS, PLEN, MAX_SEQ,
                                   sync_prepare=True, device="cpu", params=params_from_jax(jparams, cfg, "cpu"))
        sess = ServeSession(ctrl, step_time_s=1.0)
        for p in prompts:
            sess.submit(p, GEN)
        results, metrics = sess.run(
            [ResizeEvent(time_s=t, target=configs.ParallelConfig(dp=dp, tp=tp)) for (dp, tp), t in trace]
        )
        recs = list(ctrl.records)
        ctrl.shutdown()
        return results, metrics, recs

    jctrl = JaxController(jcfg, jax_configs.ParallelConfig(dp=1, tp=1), N_SLOTS, PLEN, MAX_SEQ, sync_prepare=True,
                          seed=0)
    jsess = JaxSession(jctrl, step_time_s=1.0)
    for p in prompts:
        jsess.submit(p, GEN)
    jax_results, _ = jsess.run([])
    jctrl.shutdown()
    return {"plain": port_run([]), "resized": port_run(TRACE), "jax": jax_results, "jcfg": jcfg}


def test_uninterrupted_port_session_equals_the_jax_session(runs):
    results, metrics, recs = runs["plain"]
    assert metrics.dropped == 0 and len(results) == 6 and metrics.waves == 2 and not recs
    assert all(len(t) == GEN for t in results.values())
    assert results == runs["jax"]


def test_generation_survives_three_resizes_token_for_token(runs):
    results, metrics, _ = runs["resized"]
    assert metrics.dropped == 0 and metrics.commits == 3 and len(results) == 6
    assert results == runs["plain"][0]


def test_resize_records_move_the_ssm_cache(runs):
    _, _, recs = runs["resized"]
    assert [(r.src, r.dst) for r in recs] == [
        ("dp2xpp1xtp2", "dp1xpp1xtp2"), ("dp1xpp1xtp2", "dp1xpp1xtp4"), ("dp1xpp1xtp4", "dp2xpp1xtp2"),
    ]
    assert all(r.cut_step > 0 and r.outcome == "committed" for r in recs)
    keep, grow, back = recs
    # tp kept: the live ssd/conv cache adopted in place, nothing executed
    assert keep.cache_resident_layers > 0 and keep.executed_bytes == 0 and keep.plan_network_bytes == 0
    # tp changed: the cache streams through the engine
    for r in (grow, back):
        assert r.executed_bytes > 0 and r.cache_resident_layers == 0
    jspecs = JC.serve_state_specs(runs["jcfg"], N_SLOTS, MAX_SEQ, cache_dtype="float32")
    for rec, (a, b) in zip(recs, [((2, 2), (1, 2)), ((1, 2), (1, 4)), ((1, 4), (2, 2))]):
        _, (ja, jb) = _pcs(a, b)
        want = JC.serve_plan(runs["jcfg"], jspecs, ja, jb)
        assert (rec.plan_network_bytes, rec.plan_local_bytes, rec.skipped_bytes) == (
            want.network_bytes, want.local_bytes, want.resident_bytes,
        )


def test_serve_once_and_the_cli_serve_mamba2_on_the_cpu():
    cfg = configs.get_config(ARCH).reduced()
    a = serve_once(cfg, batch=2, prompt_len=20, gen=4, device="cpu")
    b = serve_once(cfg, batch=2, prompt_len=20, gen=4, device="cpu")
    assert a["tokens"].shape == (2, 5) and 0 <= a["tokens"].min() and a["tokens"].max() < cfg.vocab_size
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--reduced", "--device", "cpu",
           "--batch", "2", "--prompt-len", "32", "--gen", "4"]
    out = subprocess.run(cmd, env={**os.environ, "PYTHONPATH": str(REPO / "src")}, capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "[prefill] 2x32 tokens" in out.stdout and "[decode] 4 steps x batch 2" in out.stdout
