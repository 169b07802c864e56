"""Live-resized training in the port against the JAX package, on the CPU
at the reduced size:

- ``LiveExecutor`` with ``WirePolicy()`` (the Adam moments on the int8
  wire) against the JAX package's ``LiveExecutor`` on the same plan of the
  training state: the same destination bytes (the quantize -> dequantize
  round trip of the JAX refs for the moments, the exact bytes for the
  params), the same ``wire_bytes`` and ``executed_bytes``, equal
  ``StreamStats``;
- ``OverlapSession``: the cases of ``tests/test_reshard_engine.py``
  (overlapped equals stop-copy, a byte-exact dirty re-sync, an idempotent
  scattered re-stream against the byte oracle);
- ``LiveRController``: un-resized losses equal the JAX controller's over
  the same steps from the same weights; a stop-copy and a streamed resize
  with a lossless wire end bitwise equal to the port's un-resized run (one
  device: the same tensors, the same kernels, and exact byte movement), so
  within the JAX package's ``RESHAPE_PARITY_TOL``; training goes on during
  Prepare and the pause is shorter than Prepare; a ``WirePolicy()`` commit
  delivers every moment as the plain round trip of the moments at the cut;
- the training CLI on the CPU, and its refusals."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from conftest import RESHAPE_PARITY_TOL
from repro import configs as jax_configs
from repro.core.controller import LiveRController as JaxController
from repro.core.reshard import plan_state_transfer as jax_plan_state_transfer
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.reshard import LiveExecutor as JaxLiveExecutor
from repro.reshard import ReshardEngine as JaxEngine
from repro.reshard import WirePolicy as JaxWirePolicy
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch import configs
from repro_torch.core import controller as C
from repro_torch.core.controller import LiveRController
from repro_torch.core.intersection import TransferTask, plan_transfer
from repro_torch.core.reshard import named_state_leaves, plan_state_transfer, rebuild_state
from repro_torch.core.resource_view import TensorSpec
from repro_torch.kernels import ref
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.reshard import LiveExecutor, OverlapSession, ReshardEngine, SimExecutor, WirePolicy
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 8192
OPT = dict(learning_rate=1e-3, warmup_steps=5)
# The port's loss against the JAX controller's over the same steps from the
# same weights: one step agrees to ~1e-6 relative (tests/
# test_torch_optim_data.py); Adam turns last-bit gradient differences into
# a few visibly different updates each step (tests/conftest.py's
# RESHAPE_PARITY_TOL reasoning); over 6 steps a ~6.7 loss moved by up to
# 1.5e-6 when this bound was set, so it leaves a margin of ten.
JAX_LOSS_TOL = 2e-5


def _pc(dp, tp, pp=1):
    return configs.ParallelConfig(dp=dp, pp=pp, tp=tp), jax_configs.ParallelConfig(dp=dp, pp=pp, tp=tp)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# ---------------------------------------------------------------------------
# LiveExecutor on the compressed wire against the JAX executor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_state():
    cfg = configs.get_config("qwen3-1.7b").reduced()
    jcfg = jax_configs.get_config("qwen3-1.7b").reduced()
    (ca, ja), (cb, jb) = _pc(2, 2), _pc(2, 4)
    specs, plan = plan_state_transfer(cfg, ca, cb)
    jspecs, jplan = jax_plan_state_transfer(jcfg, ja, jb)
    assert [s.name for s in specs] == [s.name for s in jspecs]
    rng = np.random.default_rng(0)
    g = {s.name: (rng.normal(size=s.shape) * 10.0 ** rng.integers(-8, 1)).astype(np.float32) for s in specs}
    return specs, plan, jspecs, jplan, ca, cb, g


def _run_jax(jspecs, jplan, g, policy, budget=BUDGET):
    """The JAX package's LiveExecutor with every target on one CPU device:
    the sources are plain device arrays, so no cell takes the relayout (as
    in the port, whose two worlds have 4 and 8 ranks)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    sh = NamedSharding(mesh, PartitionSpec())
    spec_map = {s.name: s for s in jspecs}
    ex = JaxLiveExecutor(spec_map, {n: jnp.asarray(v) for n, v in g.items()}, {n: sh for n in spec_map},
                         budget, wire_policy=policy)
    stats = JaxEngine(jplan, ex, staging_bytes=budget, wire_policy=policy).run()
    ex.block_until_ready()
    return ex, stats


def _run_port(specs, plan, g, ca, cb, policy, budget=BUDGET):
    spec_map = {s.name: s for s in specs}
    src = {n: torch.from_numpy(v.copy()) for n, v in g.items()}
    ex = LiveExecutor(spec_map, src, [CPU] * ca.world_size, [CPU] * cb.world_size, budget, wire_policy=policy)
    stats = ReshardEngine(plan, ex, staging_bytes=budget, wire_policy=policy).run()
    ex.block_until_ready()
    return ex, stats, src


@pytest.mark.parametrize("budget", [BUDGET, 1 << 20], ids=["chunked", "whole_cells"])
@pytest.mark.parametrize("moments", ["int8", "fp8_e4m3"])
def test_compressed_wire_equals_the_jax_executor(train_state, moments, budget):
    """Under a budget smaller than a cell, a remote cell is chunked while
    its replica's local twin is not, and the overlapping regions take the
    lossless per-cell copy in both packages; with whole cells every moment
    row crosses the wire."""
    specs, plan, jspecs, jplan, ca, cb, g = train_state
    ex, stats, src = _run_port(specs, plan, g, ca, cb, WirePolicy(moments=moments), budget)
    jex, jstats = _run_jax(jspecs, jplan, g, JaxWirePolicy(moments=moments), budget)
    for field in ("network_bytes", "local_bytes", "resident_bytes", "resident_cells", "chunks",
                  "peak_staging_bytes", "logical_bytes", "wire_bytes", "executed_bytes", "generic_cells"):
        assert getattr(stats, field) == getattr(jstats, field), field
    assert ex.wire_bytes == jex.wire_bytes and ex.executed_bytes == jex.executed_bytes
    assert stats.wire_bytes < stats.logical_bytes
    for s in specs:
        np.testing.assert_array_equal(_bytes(ex.results()[s.name]), _bytes(jex.results()[s.name]), err_msg=s.name)
    if budget == BUDGET:
        assert ex.generic_cells > 0
        return
    assert ex.generic_cells == 0
    quantized = 0
    for s in specs:
        got = ex.results()[s.name]
        if s.collection == "params" or got is src[s.name]:
            np.testing.assert_array_equal(got.numpy(), g[s.name], err_msg=s.name)  # lossless or adopted
        else:
            want = ref.quant_round_trip_ref(torch.from_numpy(g[s.name]), moments)
            np.testing.assert_array_equal(_bytes(got), _bytes(want), err_msg=s.name)
            quantized += 1
    assert quantized == sum(s.collection in ("mu", "nu") and ex.results()[s.name] is not src[s.name] for s in specs)
    assert quantized > 0


def test_lossless_policy_equals_the_jax_executor(train_state):
    specs, plan, jspecs, jplan, ca, cb, g = train_state
    ex, stats, _ = _run_port(specs, plan, g, ca, cb, WirePolicy(moments="none"))
    jex, jstats = _run_jax(jspecs, jplan, g, JaxWirePolicy(moments="none"))
    assert stats.wire_bytes == stats.logical_bytes == jstats.wire_bytes
    assert ex.wire_bytes == jex.wire_bytes
    for s in specs:
        np.testing.assert_array_equal(ex.results()[s.name].numpy(), g[s.name], err_msg=s.name)


def test_named_state_round_trips_and_plans_like_jax(train_state):
    specs, plan, jspecs, jplan, *_ = train_state
    assert [(t.tensor, t.src_rank, t.dst_rank, t.bounds, t.kind, t.layer) for t in plan.tasks] == [
        (t.tensor, t.src_rank, t.dst_rank, t.bounds, t.kind, t.layer) for t in jplan.tasks]
    params = {"a": {"w": torch.ones(2)}, "b": torch.zeros(3)}
    opt = {"mu": {"a": {"w": torch.ones(2)}, "b": torch.zeros(3)}, "nu": {"a": {"w": torch.ones(2)}, "b": torch.zeros(3)},
           "count": torch.zeros((), dtype=torch.int32)}
    named, extras = named_state_leaves(params, opt)
    assert sorted(named) == ["mu/a/w", "mu/b", "nu/a/w", "nu/b", "params/a/w", "params/b"]
    assert list(extras) == ["count"]
    p2, o2 = rebuild_state(named, params, opt, extras)
    assert tree_paths(p2) == tree_paths(params) and tree_paths(o2) == tree_paths(opt)


# ---------------------------------------------------------------------------
# OverlapSession (tests/test_reshard_engine.py's cases)
# ---------------------------------------------------------------------------


def test_dirty_resync_is_byte_exact():
    """Pre-copy every layer at step 0, step the optimizer (every element
    changes), re-sync: the destination holds the new bytes, not the stale
    pre-copy and not their sum."""
    specs = [TensorSpec("params/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "params")]
    (ca, _), (cb, _) = _pc(2, 2), _pc(1, 2, pp=2)
    plan = plan_transfer(specs, ca, cb, num_positions=1)
    v0 = np.random.default_rng(0).normal(size=(8, 16, 32)).astype(np.float32)
    sess = OverlapSession(specs, plan, {}, [CPU] * ca.world_size, [CPU] * cb.world_size, 1 << 20, stream_k=3)
    rounds = 0
    while not sess.done_precopy:
        sess.stream_next({specs[0].name: torch.from_numpy(v0.copy())}, step=0)
        rounds += 1
    assert rounds > 1 and sess.fence is None  # nothing to wait for on the CPU
    np.testing.assert_array_equal(sess.results()[specs[0].name].numpy(), v0)
    assert sorted(sess.dirty_layers(1)) == sess.engine.layers()
    sess.resync({specs[0].name: torch.from_numpy(v0 + 1.0)}, step=1)
    np.testing.assert_array_equal(sess.results()[specs[0].name].numpy(), v0 + 1.0)
    assert not sess.dirty_layers(1) and sess.report.resync_layers == len(sess.engine.layers())
    assert sess.report.precopy_rounds == rounds and sess.report.precopy_bytes > 0


def test_scattered_restream_is_idempotent_against_the_oracle():
    """Scattered dirty rows re-streamed twice from the same post-step
    sources: overwrite semantics, so both passes give the byte oracle's
    destination."""
    from repro_torch.core.intersection import TransferPlan as Plan

    R, Cc = 32, 256
    spec = TensorSpec("params/w", (R, Cc), "float32", ("none", "none"), "all", "params")
    rows = [1, 3, 4, 8, 13, 21, 22, 30]
    plan = Plan(tasks=[TransferTask(tensor=spec.name, collection="params", src_rank=0, dst_rank=1,
                                    bounds=((r, r + 1), (0, Cc)), src_offset=(r, 0), dst_offset=(r, 0),
                                    nbytes=Cc * 4, layer=0) for r in rows], cfg_src=None, cfg_dst=None)
    budget = Cc * 4 * 3
    v0 = np.random.default_rng(0).normal(size=(R, Cc)).astype(np.float32)
    v1 = v0 + 1.0

    class Store:
        def __init__(self, x):
            self.shards = {spec.name: x}

    oracle = Store(np.zeros((R, Cc), np.float32))
    ReshardEngine(plan, SimExecutor({0: Store(v1.copy())}, {1: oracle}), staging_bytes=budget).run()
    ex = LiveExecutor({spec.name: spec}, {spec.name: torch.from_numpy(v0.copy())}, [CPU] * 2, [CPU] * 2, budget)
    eng = ReshardEngine(plan, ex, staging_bytes=budget)
    s0 = eng.run()
    assert s0.generic_cells == 0
    exp0 = np.zeros((R, Cc), np.float32)
    exp0[rows] = v0[rows]
    np.testing.assert_array_equal(ex.results()[spec.name].numpy(), exp0)
    for _ in range(2):
        ex.update_sources({spec.name: torch.from_numpy(v1.copy())})
        ex.reset_round()
        ex.begin_round()
        eng.run()
        assert ex.round_touched() == {spec.name} and ex.sync_staging() is None
        np.testing.assert_array_equal(ex.results()[spec.name].numpy(), oracle.shards[spec.name])


@pytest.mark.parametrize("policy", [None, WirePolicy()], ids=["lossless", "int8_moments"])
def test_overlapped_streaming_equals_stop_copy(train_state, policy):
    """Pre-copy rounds from an older cut plus the re-sync from the final one
    deliver the same bytes as one stop-copy reshard of the final cut, on
    either wire."""
    specs, plan, _, _, ca, cb, g = train_state
    old = {n: torch.from_numpy(v.copy()) for n, v in g.items()}
    new = {n: torch.from_numpy(v * 0.5 + 1.0) for n, v in g.items()}
    sess = OverlapSession(specs, plan, {}, [CPU] * ca.world_size, [CPU] * cb.world_size, BUDGET, stream_k=2,
                          wire_policy=policy)
    while not sess.done_precopy:
        sess.stream_next(old, step=0)
    sess.resync(new, step=1, drain=False)
    sess.drain()
    want, _, _ = _run_port(specs, plan, {n: x.numpy() for n, x in new.items()}, ca, cb, policy)
    for s in specs:
        np.testing.assert_array_equal(_bytes(sess.results()[s.name]), _bytes(want.results()[s.name]), err_msg=s.name)
    assert sess.report.wire_bytes <= sess.report.logical_bytes


# ---------------------------------------------------------------------------
# LiveRController
# ---------------------------------------------------------------------------

RESIZE = (2, 4)  # dp2tp2 -> dp2tp4: tp changes, so every moment crosses the wire


def _controller(params=None, **kw):
    cfg = configs.get_config("qwen3-1.7b").reduced()
    return LiveRController(cfg, configs.ParallelConfig(dp=2, tp=2), AdamWConfig(**OPT), seq_len=32, global_batch=8,
                           device="cpu", params=params, **kw)


def _resized_run(overlap, wire_policy=None, params=None):
    ctrl = _controller(params, overlap=overlap, stream_k=2, wire_policy=wire_policy)
    losses = ctrl.train_steps(3)
    ctrl.request_resize(configs.ParallelConfig(dp=RESIZE[0], tp=RESIZE[1]))
    during, t0 = 0, time.time()
    while not ctrl.records and time.time() - t0 < 120:
        losses += ctrl.train_steps(1)
        during += 1
    assert ctrl.records, "the resize never committed"
    losses += ctrl.train_steps(3)
    return ctrl, losses, during


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX controller, never resized, on one host device (dp1tp1), and
    its weights at the start for the port."""
    jcfg = jax_configs.get_config("qwen3-1.7b").reduced()
    jctrl = JaxController(jcfg, jax_configs.ParallelConfig(dp=1, tp=1), JaxAdamWConfig(**OPT), seq_len=32,
                          global_batch=8)
    flat = dict(jax_tree_paths(jctrl.gathered_params()))
    params = params_from_jax(flat, configs.get_config("qwen3-1.7b").reduced(), "cpu")
    return jctrl.train_steps(6), params


@pytest.fixture(scope="module")
def unresized(jax_reference):
    """The port's run that is never resized: params after each step."""
    _, params = jax_reference
    ctrl = _controller(params)
    snapshots, losses = [], []
    for _ in range(24):
        losses += ctrl.train_steps(1)
        snapshots.append(tree_paths(ctrl.gathered_params()))
    return losses, snapshots


def test_unresized_losses_equal_the_jax_controller(jax_reference, unresized):
    jax_losses, _ = jax_reference
    losses, _ = unresized
    np.testing.assert_allclose(losses[: len(jax_losses)], jax_losses, atol=JAX_LOSS_TOL, rtol=0)


@pytest.mark.parametrize("overlap", ["stop_copy", "stream"])
def test_lossless_resize_equals_the_unresized_run(jax_reference, unresized, overlap):
    _, params = jax_reference
    ctrl, losses, during = _resized_run(overlap, params=params)
    rec = ctrl.records[0]
    assert ctrl.world.parallel.tp == RESIZE[1] and rec.mode == {"stop_copy": "live", "stream": "live_overlap"}[overlap]
    assert during > 0, "training was blocked during Prepare (I1 violated)"
    if overlap == "stop_copy":
        # the reference's e2e condition, which its test asserts for
        # stop-copy; a streamed commit's pause holds the optimizer update,
        # which at this size is of the order of a Prepare that compiles
        # nothing (one parallel run measured 37.6 ms of pause, 37.2 ms of
        # Prepare)
        assert rec.total_pause_s < rec.prepare_s, (rec.total_pause_s, rec.prepare_s)
    assert rec.executed_bytes > 0 and rec.wire_bytes == rec.logical_bytes > 0 and rec.generic_cells == 0
    if overlap == "stream":
        assert rec.precopy_bytes > 0 and 0 < rec.dirty_layers <= rec.layers_total
    ref_losses, snapshots = unresized
    got, want = tree_paths(ctrl.gathered_params()), snapshots[len(losses) - 1]
    worst = max(float(np.abs(got[p] - want[p]).max()) for p in want)
    assert worst < RESHAPE_PARITY_TOL
    # one device: the same tensors through the same kernels, and the bytes
    # move exactly, so the resized run is bitwise the un-resized one
    assert worst == 0.0 and losses == ref_losses[: len(losses)]


@pytest.mark.parametrize("overlap", ["stop_copy", "stream"])
def test_int8_wire_commit_delivers_the_round_trip_of_the_cut(monkeypatch, overlap):
    seen, zeroed = [], []

    def checked(named, params_like, opt_like, extras):
        old = {f"params/{p}": x for p, x in tree_paths(params_like).items()}
        for coll in ("mu", "nu"):
            old.update({f"{coll}/{p}": x for p, x in tree_paths(opt_like[coll]).items()})
        for name, new in named.items():
            if name.startswith("params/") or new is old[name]:
                np.testing.assert_array_equal(new.numpy(), old[name].numpy(), err_msg=name)
            else:
                want = ref.quant_round_trip_ref(old[name], "int8")
                np.testing.assert_array_equal(_bytes(new), _bytes(want), err_msg=name)
                seen.append(name)
                if name.startswith("nu/"):
                    zeroed.append(int(((new == 0) & (old[name] != 0)).sum()))
        return rebuild_state(named, params_like, opt_like, extras)

    monkeypatch.setattr(C, "rebuild_state", checked)
    ctrl, losses, _ = _resized_run(overlap, wire_policy=WirePolicy())
    rec = ctrl.records[0]
    assert sorted(seen) == sorted(n for n in seen if n.split("/")[0] in ("mu", "nu")) and len(seen) > 0
    assert rec.wire_bytes < rec.logical_bytes
    assert all(np.isfinite(losses))
    # one scale per row of a stacked moment rounds some of nu's entries to
    # 0 (ROADMAP queue 3: a property of the reference's wire)
    assert sum(zeroed) > 0


def test_cancel_and_the_unported_verbs():
    ctrl = _controller()
    ctrl.train_steps(1)
    ctrl.request_resize(configs.ParallelConfig(dp=1, tp=4))
    with pytest.raises(RuntimeError, match="in flight"):
        ctrl.request_resize(configs.ParallelConfig(dp=1, tp=2))
    ctrl.wait_shadow_ready(60)
    ctrl.cancel_resize(outcome="aborted")
    assert not ctrl.reconfig_pending and ctrl.records[-1].outcome == "aborted"
    ctrl.train_steps(2)
    assert ctrl.world.parallel.tp == 2 and ctrl.step == 3
    # retarget_resize, escalate_commit and prefetch_world are ported
    # (tests/test_torch_lifecycle.py), and so are the recovery verbs
    # (tests/test_torch_recovery.py): without a pool or a checkpoint
    # directory the prewarms and checkpoint_now do nothing, and a loss the
    # DP replicas cover is recovered from them
    assert ctrl.prewarm_transfer(configs.ParallelConfig(dp=1, tp=2)) is False
    assert ctrl.prewarm_failover_ahead() == 0
    ctrl.checkpoint_now()
    rec = ctrl.fail_stop_recover(configs.ParallelConfig(dp=1, tp=2))
    assert (rec.mode, ctrl.step, ctrl.world.parallel) == ("peer_recover", 3, configs.ParallelConfig(dp=1, tp=2))
    # pipeline stages are ported: a resize into pp commits
    ctrl.request_resize(configs.ParallelConfig(pp=2, tp=2))
    ctrl.wait_shadow_ready(60)
    ctrl.train_steps(2)
    assert ctrl.world.parallel == configs.ParallelConfig(pp=2, tp=2) and ctrl.records[-1].executed_bytes > 0
    if not torch.cuda.is_available():  # the entry point runs on the card unless asked not to
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LiveRController(configs.get_config("qwen3-1.7b").reduced(), configs.ParallelConfig(), AdamWConfig(), 8, 2)


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def _train_cli(*extra, out=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--reduced", "--seq", "32",
           "--batch", "8", *extra]
    return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300, cwd=REPO)


def test_train_cli_resizes_on_cpu(tmp_path):
    out = tmp_path / "run.json"
    res = _train_cli("--device", "cpu", "--dp", "2", "--tp", "2", "--steps", "14", "--resize", "3:dp2,tp4",
                     "--resize", "9:dp1,tp4", "--overlap", "stream", "--stream-k", "2", "--out", str(out))
    assert res.returncode == 0, res.stderr
    assert "[switch]" in res.stdout and "reconfigs=2" in res.stdout
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and len(rec["losses"]) == 14 and all(np.isfinite(rec["losses"]))
    assert [r["dst"] for r in rec["reconfigs"]] == ["dp2xpp1xtp4", "dp1xpp1xtp4"]


@pytest.mark.parametrize("flags,why", [(("--pp", "2"), "pipeline stages"),
                                       (("--compression", "int8_ef"), "gradient compression")])
def test_train_cli_refuses_what_is_not_ported(flags, why, tmp_path):
    """(Named when both were refused.) The launcher now trains with
    pipeline stages, resized into a deeper pipeline, and with int8 gradient
    compression, on the CPU."""
    out = tmp_path / "run.json"
    pipeline = flags[0] == "--pp"
    resize, dst = ("3:dp1,pp4,tp1", "dp1xpp4xtp1") if pipeline else ("3:dp1,tp4", "dp1xpp1xtp4")
    res = _train_cli("--device", "cpu", "--steps", "6", *flags, "--resize", resize, "--out", str(out))
    assert res.returncode == 0, (why, res.stderr)
    assert "[switch]" in res.stdout and "reconfigs=1" in res.stdout
    assert pipeline or "compression=int8_ef" in res.stdout
    rec = json.loads(out.read_text())
    assert len(rec["losses"]) == 6 and all(np.isfinite(rec["losses"]))
    assert [r["dst"] for r in rec["reconfigs"]] == [dst]


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _train_cli("--steps", "2")
    assert res.returncode != 0 and "CUDA" in res.stderr and "[done]" not in res.stdout
