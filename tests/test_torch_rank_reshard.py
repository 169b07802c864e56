"""Resizes between per-rank worlds (``reshard/executors.py::RankExecutor``,
``core/reshard.py::rank_reshard_planned``, ``core/rank_controller.py``), in
one gloo world of 8 CPU rank processes.

The executor, on the transitions of ``tests/test_torch_streaming.py``
whose worlds are dp x tp (its tp2 -> tp4 layer cases, its residency cases,
and reduced qwen3-1.7b's whole state dp2tp2 -> dp2tp4, lossless and with
the int8 moment wire): every destination shard is the byte-level oracle's
(``core/streaming.py``'s ``SimExecutor``) bit for bit, or within the int8
rounding of the moments' tiles; each (source, destination) rank pair sends
exactly the plan's bytes; and the engine's ``StreamStats`` are what the
one-process ``LiveExecutor`` counts for the same plan on global tensors
(the executed bytes aside: the one-process executor moves a replicated
cell once for all its destination ranks, a rank moves its own).

The controller: the port's counterpart of ``tests/test_elastic_e2e.py::
test_live_reshape_parity_and_overlap``. Reduced qwen3 on dp2tp2 trains 3
steps, is resized to dp2tp4 by stop-copy while training goes on (steps
during Prepare, a pause below Prepare, the plan's bytes per rank pair),
trains 2 steps, streams back to dp2tp2 (a split-step commit, stream_k 1)
and trains 3 more; its params end within ``RESHAPE_PARITY_TOL`` of a
one-process run never resized."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core import streaming as S
from repro_torch.core.intersection import plan_transfer
from repro_torch.core.reshard import live_reshard_planned, plan_state_transfer
from repro_torch.core.resource_view import TensorSpec, build_tensor_specs
from repro_torch.launch.ranks import run_ranks
from repro_torch.optim import AdamWConfig
from repro_torch.reshard import WirePolicy

torch.set_num_threads(2)

P = ParallelConfig
W = TensorSpec("params/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "params")
REUSE_SPECS = [
    W,
    TensorSpec("params/embed/tok", (64, 32), "float32", ("tp", "none"), "first", "params"),
    TensorSpec("mu/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "mu"),
]
QWEN3 = get_config("qwen3-1.7b").reduced()
# name: (specs, source, destination, staging bytes, quantize the moments)
CASES = {
    "transition-2": ([dataclasses.replace(W, shape=(2, 32, 32))], P(tp=2), P(tp=4), 2048, False),
    "transition-8": ([dataclasses.replace(W, shape=(8, 32, 32))], P(tp=2), P(tp=4), 2048, False),
    "reuse-none": (REUSE_SPECS, P(dp=2, tp=2), P(dp=1, tp=4), 2048, False),
    "reuse-partial": (REUSE_SPECS, P(dp=1, tp=4), P(dp=2, tp=4), 2048, False),
    "reuse-full": (REUSE_SPECS, P(dp=2, tp=2), P(dp=1, tp=2), 2048, False),
    "reuse-none-int8": (REUSE_SPECS, P(dp=2, tp=2), P(dp=1, tp=4), 2048, True),
    "qwen3": (build_tensor_specs(QWEN3, zero_sharding=False), P(dp=2, tp=2), P(dp=2, tp=4), 1 << 20, False),
    "qwen3-int8": (build_tensor_specs(QWEN3, zero_sharding=False), P(dp=2, tp=2), P(dp=2, tp=4), 1 << 20, True),
}
OPT = AdamWConfig(learning_rate=1e-3, warmup_steps=5)
BEFORE, BETWEEN, AFTER = 3, 2, 3
CLOCKS = ("seconds", "dispatch_seconds", "drain_seconds")


def _global_state(specs, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {s.name: rng.normal(size=s.shape).astype(s.dtype) for s in specs}


def _rank_program(rank: int, states: dict) -> dict:
    """Every executor case, then the controller's run."""
    from repro_torch.core.rank_controller import RankController
    from repro_torch.core.reshard import rank_reshard_planned
    from repro_torch.distribution.groups import RankPool

    pool = RankPool()
    out = {}
    for name, (specs, ca, cb, staging, quant) in CASES.items():
        plan = plan_transfer(specs, ca, cb)
        shards = {}
        if rank < ca.world_size:
            shards = {k: torch.from_numpy(v) for k, v in S.materialize_rank(specs, ca, rank, states[name]).shards.items()}
        moved, stats, ex = rank_reshard_planned(specs, plan, shards, rank, pool, "cpu", staging_bytes=staging,
                                                wire_policy=WirePolicy() if quant else None)
        out[name] = {"shards": {k: v.clone() for k, v in moved.items()}, "sent": ex.sent_bytes,
                     "stats": dataclasses.asdict(stats), "wire": ex.wire_bytes, "staged": ex.peak_staged_bytes}

    ctrl = RankController(QWEN3, P(dp=2, tp=2), OPT, 32, 8, pool, worlds=[P(dp=2, tp=4)], device="cpu",
                          stream_k=1)
    losses = ctrl.train_steps(BEFORE)
    ctrl.request_resize(P(dp=2, tp=4))
    during = 0
    while not ctrl.records:
        losses += ctrl.train_steps(1)
        during += 1
        assert during < 200, "the stop-copy resize never committed"
    losses += ctrl.train_steps(BETWEEN)
    ctrl.request_resize(P(dp=2, tp=2), overlap="stream")
    while len(ctrl.records) < 2:
        losses += ctrl.train_steps(1)
        assert len(losses) < 400, "the streamed resize never committed"
    losses += ctrl.train_steps(AFTER)
    out["controller"] = {
        "losses": losses, "during": during, "params": ctrl.gathered_params(),
        "records": [dataclasses.asdict(r) for r in ctrl.records],
        "commits": [dataclasses.asdict(c) for c in ctrl.rank_commits],
        "world": ctrl.world.parallel,
    }
    return out


@pytest.fixture(scope="module")
def world():
    states = {name: _global_state(case[0], seed=i) for i, (name, case) in enumerate(CASES.items())}
    return {"states": states, "ranks": run_ranks(_rank_program, 8, states, timeout=600)}


@pytest.mark.parametrize("name", CASES)
def test_rank_executor_moves_the_oracles_bytes(world, name):
    specs, ca, cb, staging, quant = CASES[name]
    plan = plan_transfer(specs, ca, cb)
    src = {r: S.materialize_rank(specs, ca, r, world["states"][name]) for r in range(ca.world_size)}
    dst = {r: S.allocate_destination(specs, cb, r) for r in range(cb.world_size)}
    S.execute_plan(plan, src, dst, staging_bytes=staging)
    for r in range(cb.world_size):
        got = world["ranks"][r][name]["shards"]
        assert sorted(got) == sorted(dst[r].shards)
        for tensor, want in dst[r].shards.items():
            g = got[tensor].numpy()
            if quant and tensor.split("/")[0] in ("mu", "nu"):
                # int8: one scale per dim-0 row of a cell, |error| <= half a step of 1/127 of its absmax
                assert np.abs(g - want).max() <= np.abs(want).max() / 254 * 1.0001, (r, tensor)
            else:
                np.testing.assert_array_equal(g, want, err_msg=f"rank {r} {tensor}")
    for r in range(cb.world_size, 8):
        assert world["ranks"][r][name]["shards"] == {}


@pytest.mark.parametrize("name", CASES)
def test_rank_executor_pair_bytes_equal_the_plan(world, name):
    specs, ca, cb, _, _ = CASES[name]
    plan = plan_transfer(specs, ca, cb)
    want: dict[tuple, int] = {}
    for t in plan.tasks:
        if t.kind == "remote":
            want[(t.src_rank, t.dst_rank)] = want.get((t.src_rank, t.dst_rank), 0) + t.nbytes
    got = {(r, d): n for r in range(8) for d, n in world["ranks"][r][name]["sent"].items()}
    assert got == want
    # a wave's messages, sent and received, stay within the staging budget
    staged = [world["ranks"][r][name]["staged"] for r in range(8)]
    assert max(staged) <= CASES[name][3] and (max(staged) > 0) == bool(want)


@pytest.mark.parametrize("name", CASES)
def test_rank_executor_stats_equal_the_live_executor(world, name):
    specs, ca, cb, staging, quant = CASES[name]
    plan = plan_transfer(specs, ca, cb)
    policy = WirePolicy() if quant else None
    named = {k: torch.from_numpy(v) for k, v in world["states"][name].items()}
    _, live = live_reshard_planned(specs, plan, named, ["cpu"] * ca.world_size, ["cpu"] * cb.world_size,
                                   staging_bytes=staging, wire_policy=policy)
    want = dataclasses.asdict(live)
    for k in CLOCKS + ("executed_bytes", "generic_cells"):
        want.pop(k)
    for r in range(8):
        got = dict(world["ranks"][r][name]["stats"])
        for k in CLOCKS + ("executed_bytes", "generic_cells"):
            got.pop(k)
        assert got == want, r
    # the wire: what the ranks sent is what the engine counted crossing it
    assert sum(world["ranks"][r][name]["wire"] for r in range(8)) == live.wire_bytes
    assert all(world["ranks"][r][name]["stats"]["generic_cells"] == 0 for r in range(8))


def test_live_reshape_parity_and_overlap(world):
    """dp2tp2 -> dp2tp4 by stop-copy while training, back by streaming: the
    port's counterpart of the JAX e2e test."""
    from conftest import RESHAPE_PARITY_TOL

    from repro_torch.core.controller import LiveRController
    from repro_torch.utils.pytree import tree_paths

    runs = [world["ranks"][r]["controller"] for r in range(8)]
    out = runs[0]
    assert out["during"] > 0, "no overlap: training was blocked during Prepare (I1 violated)"
    assert [r["dst"] for r in out["records"]] == ["dp2xpp1xtp4", "dp2xpp1xtp2"]
    assert [r["mode"] for r in out["records"]] == ["live", "live_overlap"]
    assert out["world"] == P(dp=2, tp=2)
    for r in range(8):
        assert [x["gen_id"] for x in runs[r]["records"]] == [x["gen_id"] for x in out["records"]]
        assert runs[r]["during"] == out["during"]
    assert all(runs[r]["params"] is None for r in range(1, 8))
    steps = len(out["losses"])
    for r in range(4):  # the ranks of both dp2tp2 worlds agree on every loss
        assert runs[r]["losses"] == out["losses"]
    assert all(np.isfinite(out["losses"]))

    control = LiveRController(QWEN3, P(dp=2, tp=2), OPT, seq_len=32, global_batch=8, device="cpu")
    ref_losses = control.train_steps(steps)
    np.testing.assert_allclose(out["losses"], ref_losses, rtol=1e-5)
    ref = tree_paths(control.gathered_params())
    got = tree_paths(out["params"])
    worst = max(float(np.abs(got[p] - ref[p]).max()) for p in ref)
    assert worst < RESHAPE_PARITY_TOL, f"param divergence {worst}"


def test_stop_copy_moves_the_plans_bytes_with_pause_below_prepare(world):
    """The stop-copy commit: each rank pair carried the plan's bytes, and
    its pause is below its Prepare (stop-copy only, as the JAX test:
    ROADMAP queue 3)."""
    specs, plan = plan_state_transfer(QWEN3, P(dp=2, tp=2), P(dp=2, tp=4))
    want: dict[tuple, int] = {}
    for t in plan.tasks:
        if t.kind == "remote":
            want[(t.src_rank, t.dst_rank)] = want.get((t.src_rank, t.dst_rank), 0) + t.nbytes
    got = {(r, d): n for r in range(8) for d, n in world["ranks"][r]["controller"]["commits"][0]["sent_bytes"].items()}
    assert got == want and sum(want.values()) > 0
    rec = world["ranks"][0]["controller"]["records"][0]
    assert rec["plan_network_bytes"] == sum(want.values())
    assert rec["total_pause_s"] < rec["prepare_s"], "pause should be << prepare"
    assert rec["switch_s"] < 0.5
    # ranks 4-7 joined the world: they received and sent nothing before
    for r in range(4, 8):
        commit = world["ranks"][r]["controller"]["commits"][0]
        assert commit["sent_bytes"] == {} and sum(commit["recv_bytes"].values()) > 0


def test_streamed_commit_is_a_split_step(world):
    rec = world["ranks"][0]["controller"]["records"][1]
    assert rec["mode"] == "live_overlap" and rec["precopy_bytes"] > 0 and rec["update_s"] > 0
    assert rec["dirty_layers"] > 0 and rec["layers_total"] == QWEN3.num_layers + 1
    # ranks 4-7 left the world at the commit: they hold no state
    assert all(world["ranks"][r]["controller"]["commits"][1]["recv_bytes"] == {} for r in range(4, 8))
