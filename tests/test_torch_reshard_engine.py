"""The port's LiveExecutor on CPU tensors against the JAX package's byte
oracle (``repro.core.streaming.execute_plan`` over per-rank numpy shards):
the same plan moves the same bytes, with the same StreamStats, and the
executor routes each move to the row kernel the design names. A small
staging budget makes batches and chunks many."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.intersection import plan_transfer as jax_plan_transfer
from repro.core.resource_view import TensorSpec as JaxTensorSpec
from repro.core.resource_view import view_of
from repro.core.streaming import allocate_destination, execute_plan, materialize_rank
from repro.serve import cache_view as JC
from repro_torch import configs
from repro_torch.core.intersection import plan_transfer
from repro_torch.core.resource_view import TensorSpec
from repro_torch.kernels import ops, ref
from repro_torch.reshard import LiveExecutor, ReshardEngine, SimExecutor, WirePolicy
from repro_torch.serve import cache_view as C

torch.set_num_threads(2)

BUDGET = 8192
CPU = torch.device("cpu")
ROW_OPS = ("pack_rows", "scatter_rows", "relayout_rows", "unpack_rows")


def _pc(dp, tp, pp=1):
    return configs.ParallelConfig(dp=dp, pp=pp, tp=tp), jax_configs.ParallelConfig(dp=dp, pp=pp, tp=tp)


@pytest.fixture
def row_calls(monkeypatch):
    """Wrap the port's row ops; record each call's destination tensor."""
    calls = {name: [] for name in ROW_OPS}
    for name in ROW_OPS:
        orig = getattr(ops, name)

        def wrapped(*args, _name=name, _orig=orig):
            calls[_name].append(args[0])
            return _orig(*args)

        monkeypatch.setattr(ops, name, wrapped)
    return calls


def _touched(calls, results) -> set[str]:
    """Tensor names whose destination carry a row op wrote into."""
    ptrs = {x.data_ptr() for x in calls}
    return {name for name, t in results.items() if t.data_ptr() in ptrs}


def _run(specs, plan, g, ca, cb, delta=True):
    src = {s.name: torch.from_numpy(g[s.name].copy()) for s in specs}
    ex = LiveExecutor({s.name: s for s in specs}, src, [CPU] * ca.world_size, [CPU] * cb.world_size, BUDGET)
    stats = ReshardEngine(plan, ex, staging_bytes=BUDGET, delta=delta).run()
    ex.block_until_ready()
    return ex, stats, src


def _oracle(jspecs, jplan, g, ja, jb):
    src = {r: materialize_rank(jspecs, ja, r, g) for r in range(ja.world_size)}
    dst = {r: allocate_destination(jspecs, jb, r) for r in range(jb.world_size)}
    return execute_plan(jplan, src, dst, staging_bytes=BUDGET), dst


def _check_against_oracle(specs, jspecs, ex, stats, sim_stats, sim_dst, g, jb):
    for field in ("network_bytes", "local_bytes", "resident_bytes", "resident_cells", "layers_streamed",
                  "peak_staging_bytes", "chunks", "barriers", "logical_bytes", "wire_bytes", "per_layer_bytes"):
        assert getattr(stats, field) == getattr(sim_stats, field), field
    stats.assert_bounded(BUDGET)
    for s, js in zip(specs, jspecs):
        got = ex.results()[s.name].numpy()
        np.testing.assert_array_equal(got, g[s.name], err_msg=s.name)
        for r in range(jb.world_size):
            v = view_of(js, jb, r)
            if v is None:
                continue
            sl = tuple(slice(lo, hi) for lo, hi in v.bounds)
            np.testing.assert_array_equal(got[sl], sim_dst[r].shards[s.name], err_msg=f"{s.name}/rank{r}")


# ---------------------------------------------------------------------------
# Serving state (params + cache) of reduced qwen3 with 4 kv heads
# ---------------------------------------------------------------------------

SERVE_CASES = [
    ("tp_change", (1, 2), (1, 4)),
    ("dp_change", (1, 2), (2, 2)),
    ("tp_preserve", (2, 2), (1, 2)),
    ("tp_grow_4to4", (2, 2), (1, 4)),
    ("tp_shrink_4to4", (1, 4), (2, 2)),
]


def _serve_state():
    port = dataclasses.replace(configs.get_config("qwen3-1.7b").reduced(), num_kv_heads=4, num_heads=4)
    ref = dataclasses.replace(jax_configs.get_config("qwen3-1.7b").reduced(), num_kv_heads=4, num_heads=4)
    specs = C.serve_state_specs(port, 4, 32, "float32")
    jspecs = JC.serve_state_specs(ref, 4, 32, cache_dtype="float32")
    rng = np.random.default_rng(0)
    g = {s.name: rng.normal(size=s.shape).astype(np.float32) for s in specs}
    return port, ref, specs, jspecs, g


@pytest.mark.parametrize("name,a,b", SERVE_CASES)
def test_live_executor_matches_the_byte_oracle(name, a, b, row_calls):
    port, ref, specs, jspecs, g = _serve_state()
    (ca, ja), (cb, jb) = _pc(*a), _pc(*b)
    plan = C.serve_plan(port, specs, ca, cb)
    ex, stats, _ = _run(specs, plan, g, ca, cb)
    sim_stats, sim_dst = _oracle(jspecs, JC.serve_plan(ref, jspecs, ja, jb), g, ja, jb)
    _check_against_oracle(specs, jspecs, ex, stats, sim_stats, sim_dst, g, jb)
    relayout = _touched(row_calls["relayout_rows"], ex.results())
    packed = len(row_calls["pack_rows"])
    assert packed == len(row_calls["scatter_rows"])
    assert not row_calls["unpack_rows"]
    if name == "tp_preserve":
        # every cell resident: adopted in place, no row kernel, 0 bytes
        assert plan.network_bytes == plan.local_bytes == 0
        assert stats.executed_bytes == sim_stats.executed_bytes == 0
        assert ex.resident_passthroughs > 0 and packed == 0 and not relayout
        assert all(ex.results()[s.name] is not None for s in specs)
    elif ca.world_size == cb.world_size:
        # four ranks to the same four devices: the local rows of the
        # embedding and the final norm move by relayout, the rest by
        # pack + scatter
        assert relayout == {"params/embed/tok", "params/final_norm/scale"}
        assert packed > 0
    else:
        assert not relayout and packed > 0


@pytest.mark.parametrize("name,a,b", SERVE_CASES)
def test_unchunked_resizes_take_only_the_row_kernels(name, a, b):
    """With a budget no cell exceeds, nothing falls to box copies. (Under a
    small budget a remote cell is chunked while its replica's resident or
    local twin is not; the overlapping regions then move cell by cell, as
    in the JAX executor, and the oracle test above still holds.)"""
    port, ref, specs, jspecs, g = _serve_state()
    (ca, _), (cb, _) = _pc(*a), _pc(*b)
    plan = C.serve_plan(port, specs, ca, cb)
    src = {s.name: torch.from_numpy(g[s.name].copy()) for s in specs}
    big = 1 << 30
    ex = LiveExecutor({s.name: s for s in specs}, src, [CPU] * ca.world_size, [CPU] * cb.world_size, big)
    stats = ReshardEngine(plan, ex, staging_bytes=big).run()
    assert ex.generic_cells == 0
    moved = sum(s.nbytes for s in specs if not _all_resident(plan, s.name))
    assert stats.executed_bytes == moved
    for s in specs:
        np.testing.assert_array_equal(ex.results()[s.name].numpy(), g[s.name])


def _all_resident(plan, name) -> bool:
    return all(t.kind == "resident" for t in plan.tasks if t.tensor == name)


def test_resident_tensors_are_adopted_not_copied():
    port, ref, specs, jspecs, g = _serve_state()
    (ca, _), (cb, _) = _pc(2, 2), _pc(1, 2)
    ex, _, src = _run(specs, C.serve_plan(port, specs, ca, cb), g, ca, cb)
    assert all(ex.results()[s.name] is src[s.name] for s in specs)


def test_full_copy_baseline_moves_every_byte(row_calls):
    """delta=False demotes resident cells to local: the same tp-preserving
    resize then moves every byte through pack + scatter."""
    port, ref, specs, jspecs, g = _serve_state()
    (ca, ja), (cb, jb) = _pc(2, 2), _pc(1, 2)
    plan = C.serve_plan(port, specs, ca, cb)
    ex, stats, src = _run(specs, plan, g, ca, cb, delta=False)
    assert stats.resident_bytes == 0 and stats.local_bytes == plan.resident_bytes
    assert ex.executed_bytes == sum(s.nbytes for s in specs)
    assert ex.resident_passthroughs == 0
    assert len(row_calls["pack_rows"]) == len(row_calls["scatter_rows"]) > 0
    for s in specs:
        assert ex.results()[s.name] is not src[s.name]
        np.testing.assert_array_equal(ex.results()[s.name].numpy(), g[s.name])


# ---------------------------------------------------------------------------
# tests/test_reshard_engine.py's hand-built specs, pp resizes included, and
# a tensor whose layer axis is not the first (partial-width cells)
# ---------------------------------------------------------------------------

ENGINE_SPECS = [
    ("params/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "params"),
    ("params/blocks/pos0/b", (8, 32), "float32", ("pp", "tp"), "stages", "params"),
    ("params/embed/tok", (64, 32), "float32", ("tp", "none"), "first", "params"),
    ("mu/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "mu"),
    ("params/blocks/pos0/t", (32, 8), "float32", ("tp", "pp"), "stages", "params"),
]
ENGINE_TRANSITIONS = [
    ("tp_grow", (2, 2), (1, 4)),
    ("dp_grow", (1, 4), (2, 4)),
    ("dp_shrink", (2, 2), (1, 2)),
    ("pp_to_tp", (1, 2, 2), (1, 4)),
    ("tp_to_pp", (2, 2), (1, 2, 4)),
]


@pytest.mark.parametrize("name,a,b", ENGINE_TRANSITIONS)
def test_live_executor_matches_the_oracle_across_reshapes(name, a, b):
    specs = [TensorSpec(*s) for s in ENGINE_SPECS]
    jspecs = [JaxTensorSpec(*s) for s in ENGINE_SPECS]
    (ca, ja), (cb, jb) = _pc(*a), _pc(*b)
    rng = np.random.default_rng(0)
    g = {s.name: rng.normal(size=s.shape).astype(np.float32) for s in specs}
    plan = plan_transfer(specs, ca, cb, num_positions=1)
    ex, stats, _ = _run(specs, plan, g, ca, cb)
    sim_stats, sim_dst = _oracle(jspecs, jax_plan_transfer(jspecs, ja, jb, num_positions=1), g, ja, jb)
    _check_against_oracle(specs, jspecs, ex, stats, sim_stats, sim_dst, g, jb)
    # the transposed tensor's layer slices are partial-width: box copies,
    # unless the resize leaves it in place
    assert (ex.generic_cells > 0) == (not _all_resident(plan, "params/blocks/pos0/t"))


def test_sim_executor_copy_matches_jax():
    """The port's SimExecutor is a copy of the oracle: same stats."""
    from repro.core.streaming import RankStore

    specs = [TensorSpec(*s) for s in ENGINE_SPECS]
    jspecs = [JaxTensorSpec(*s) for s in ENGINE_SPECS]
    (ca, ja), (cb, jb) = _pc(2, 2), _pc(1, 4)
    rng = np.random.default_rng(1)
    g = {s.name: rng.normal(size=s.shape).astype(np.float32) for s in specs}
    src = {r: materialize_rank(jspecs, ja, r, g) for r in range(ja.world_size)}
    dst = {r: allocate_destination(jspecs, jb, r) for r in range(jb.world_size)}
    sim = SimExecutor(src, dst)
    stats = ReshardEngine(plan_transfer(specs, ca, cb, num_positions=1), sim, staging_bytes=BUDGET).run()
    want, want_dst = _oracle(jspecs, jax_plan_transfer(jspecs, ja, jb, num_positions=1), g, ja, jb)
    clock = ("seconds", "dispatch_seconds", "drain_seconds")
    got = {k: v for k, v in dataclasses.asdict(stats).items() if k not in clock}
    assert got == {k: v for k, v in dataclasses.asdict(want).items() if k not in clock}
    assert sim.executed_bytes == want.executed_bytes
    for r, store in dst.items():
        assert isinstance(store, RankStore)
        for name, shard in store.shards.items():
            np.testing.assert_array_equal(shard, want_dst[r].shards[name])


def _wire_run(policy, row_calls):
    specs = [TensorSpec(*s) for s in ENGINE_SPECS]
    (ca, _), (cb, _) = _pc(2, 2), _pc(1, 4)
    rng = np.random.default_rng(3)
    g = {s.name: rng.normal(size=s.shape).astype(np.float32) for s in specs}
    plan = plan_transfer(specs, ca, cb, num_positions=1)
    src = {s.name: torch.from_numpy(g[s.name].copy()) for s in specs}
    big = 1 << 30  # whole cells (the transposed tensor's are partial-width: box copies)
    ex = LiveExecutor({s.name: s for s in specs}, src, [CPU] * ca.world_size, [CPU] * cb.world_size, big,
                      wire_policy=policy)
    stats = ReshardEngine(plan, ex, staging_bytes=big, wire_policy=policy).run()
    return specs, g, ex, stats


def test_quantizing_wire_moves_moments_quantized_and_params_lossless(row_calls, monkeypatch):
    """``WirePolicy()``: rows of ``mu/*`` cross the wire through
    pack_quant_rows -> dequant_scatter_rows and arrive as their int8 round
    trip; ``params/*`` rows stay on pack_rows -> scatter_rows, byte for
    byte."""
    quant_calls = {"pack_quant_rows": [], "dequant_scatter_rows": []}
    for name in quant_calls:
        orig = getattr(ops, name)

        def wrapped(*args, _name=name, _orig=orig):
            quant_calls[_name].append(args[0])
            return _orig(*args)

        monkeypatch.setattr(ops, name, wrapped)
    specs, g, ex, stats = _wire_run(WirePolicy(), row_calls)
    assert stats.wire_bytes < stats.logical_bytes
    mu = "mu/blocks/pos0/w"
    assert _touched(quant_calls["dequant_scatter_rows"], ex.results()) == {mu}
    assert len(quant_calls["pack_quant_rows"]) == len(quant_calls["dequant_scatter_rows"]) > 0
    assert mu not in _touched(row_calls["scatter_rows"], ex.results())
    want = ref.quant_round_trip_ref(torch.from_numpy(g[mu]), "int8")
    assert torch.equal(ex.results()[mu], want) and not torch.equal(want, torch.from_numpy(g[mu]))
    for s in specs:
        if s.collection == "params":
            np.testing.assert_array_equal(ex.results()[s.name].numpy(), g[s.name], err_msg=s.name)


def test_lossless_policy_moves_every_row_byte_for_byte(row_calls):
    """``WirePolicy(moments="none")`` is the lossless wire: every tensor,
    moments too, arrives byte for byte through the row kernels, and the
    wire carries the logical bytes."""
    specs, g, ex, stats = _wire_run(WirePolicy(moments="none"), row_calls)
    assert stats.wire_bytes == stats.logical_bytes
    assert "mu/blocks/pos0/w" in _touched(row_calls["scatter_rows"], ex.results())
    for s in specs:
        np.testing.assert_array_equal(ex.results()[s.name].numpy(), g[s.name], err_msg=s.name)


def test_a_world_on_two_devices_is_refused():
    with pytest.raises(ValueError, match="one device"):
        LiveExecutor({}, {}, [CPU], [CPU, torch.device("meta")], BUDGET)
