"""The port's ``core/streaming.py`` (the simulated-rank front end of the
reshard engine) and its plan-less ``core/reshard.py::live_reshard``,
against the JAX package.

``execute_plan`` is held case by case on the cases of
``tests/test_streaming.py``, ``tests/test_reuse_accounting.py`` and
``tests/test_system.py``: the same specs, plan and numpy-seeded state go
through both packages, and every destination shard and every
``StreamStats`` field but the three clocks must be equal. The specs come
from the JAX package (the port builds no MoE model yet) and are copied
field by field into the port's ``TensorSpec``.

``live_reshard`` is held to the JAX test of it
(``tests/test_distribution.py::test_live_reshard_chunked_bounded``: a leaf
over the staging budget is chunked, the staging stays within it, the bytes
arrive) and to the JAX report's fields. On the CPU the one device is both
source and target, so a target of ``cpu:0``, which is not the leaves'
device (``cpu``), stands for another device: the leaves take the moving
path, through the row kernels' plain versions."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core import reshard as JR
from repro.core import streaming as JS
from repro.core.intersection import plan_transfer as jax_plan_transfer
from repro.core.resource_view import TensorSpec as JaxTensorSpec
from repro.core.resource_view import build_tensor_specs as jax_build_tensor_specs
from repro.models.transformer import block_program as jax_block_program
from repro_torch import configs
from repro_torch.core import streaming as S
from repro_torch.core.intersection import plan_transfer
from repro_torch.core.reshard import ReshardReport, live_reshard
from repro_torch.core.resource_view import TensorSpec
from repro_torch.kernels import ops

CLOCKS = ("seconds", "dispatch_seconds", "drain_seconds")


def _pc(**kw):
    return configs.ParallelConfig(**kw), jax_configs.ParallelConfig(**kw)


def _port_spec(s) -> TensorSpec:
    return TensorSpec(**dataclasses.asdict(s))


def _run_both(jspecs, ca, cb, staging, num_positions=1, seed=0):
    """The same plan, state and budget through both packages' front ends;
    asserts equal plans, shards and counters, returns the two stats."""
    (pa, ja), (pb, jb) = ca, cb
    specs = [_port_spec(s) for s in jspecs]
    jplan = jax_plan_transfer(jspecs, ja, jb, num_positions=num_positions)
    plan = plan_transfer(specs, pa, pb, num_positions=num_positions)
    assert [dataclasses.astuple(t) for t in plan.tasks] == [dataclasses.astuple(t) for t in jplan.tasks]
    rng = np.random.default_rng(seed)
    g = {s.name: rng.normal(size=s.shape).astype(s.dtype) for s in jspecs}
    jsrc = {r: JS.materialize_rank(jspecs, ja, r, g) for r in range(ja.world_size)}
    jdst = {r: JS.allocate_destination(jspecs, jb, r) for r in range(jb.world_size)}
    src = {r: S.materialize_rank(specs, pa, r, g) for r in range(pa.world_size)}
    dst = {r: S.allocate_destination(specs, pb, r) for r in range(pb.world_size)}
    for r in jsrc:
        assert src[r].bytes() == jsrc[r].bytes()
    jstats = JS.execute_plan(jplan, jsrc, jdst, staging_bytes=staging)
    stats = S.execute_plan(plan, src, dst, staging_bytes=staging)
    ours, theirs = dataclasses.asdict(stats), dataclasses.asdict(jstats)
    for k in CLOCKS:
        ours.pop(k), theirs.pop(k)
    assert ours == theirs
    for r, store in jdst.items():
        assert sorted(dst[r].shards) == sorted(store.shards)
        for name, want in store.shards.items():
            np.testing.assert_array_equal(dst[r].shards[name], want, err_msg=f"rank {r} {name}")
        assert dst[r].bytes() == store.bytes()
    return stats, jstats


# ---------------------------------------------------------------------------
# tests/test_streaming.py's cases
# ---------------------------------------------------------------------------


def _stream_specs():
    return [
        JaxTensorSpec(f"params/blocks/pos{i}/w", (4, 64, 32), "float32", ("pp", "none", "tp"), "stages", "params")
        for i in (0, 1)
    ]


@pytest.mark.parametrize("staging", [256, 1024, 1 << 20])
def test_bounded_memory_equals_jax(staging):
    stats, _ = _run_both(_stream_specs(), _pc(pp=2, tp=2), _pc(pp=1, tp=4), staging, num_positions=2, seed=1)
    stats.assert_bounded(staging)


@pytest.mark.parametrize("layers", [2, 8])
def test_transition_overhead_equals_jax(layers):
    jspecs = [JaxTensorSpec("params/blocks/pos0/w", (layers, 32, 32), "float32", ("pp", "none", "tp"), "stages",
                            "params")]
    stats, _ = _run_both(jspecs, _pc(tp=2), _pc(tp=4), 2048)
    assert stats.peak_staging_bytes <= 2048


# ---------------------------------------------------------------------------
# tests/test_reuse_accounting.py's cases
# ---------------------------------------------------------------------------

REUSE_SPECS = [
    JaxTensorSpec("params/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "params"),
    JaxTensorSpec("params/embed/tok", (64, 32), "float32", ("tp", "none"), "first", "params"),
    JaxTensorSpec("mu/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "mu"),
]


@pytest.mark.parametrize("ca,cb", [
    (dict(dp=2, tp=2), dict(dp=1, tp=4)),  # no residency
    (dict(dp=1, tp=4), dict(dp=2, tp=4)),  # partial residency
    (dict(dp=2, tp=2), dict(dp=1, tp=2)),  # full residency
    (dict(pp=2, tp=2), dict(pp=1, tp=4)),  # none
])
def test_reuse_accounting_equals_jax(ca, cb):
    stats, _ = _run_both(REUSE_SPECS, _pc(**ca), _pc(**cb), 2048)
    assert (stats.resident_bytes > 0) == (stats.resident_cells > 0)


# ---------------------------------------------------------------------------
# tests/test_system.py's cases: a real model's state (reduced)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,ca,cb", [
    ("qwen3-1.7b", dict(dp=2, pp=2, tp=2), dict(dp=1, pp=4, tp=2)),
    ("mixtral-8x7b", dict(dp=2, tp=2, ep=2), dict(dp=1, tp=2, ep=4)),
    ("mamba2-2.7b", dict(dp=1, pp=2, tp=4), dict(dp=4, pp=1, tp=2)),
    ("jamba-v0.1-52b", dict(dp=2, pp=2, tp=2), dict(dp=1, pp=1, tp=4)),
])
def test_model_state_reshape_equals_jax(arch, ca, cb):
    jcfg = jax_configs.get_config(arch).reduced()
    jspecs = jax_build_tensor_specs(jcfg, include_optimizer=True)
    stats, _ = _run_both(jspecs, _pc(**ca), _pc(**cb), 1 << 20, num_positions=len(jax_block_program(jcfg)))
    stats.assert_bounded(1 << 20)


# ---------------------------------------------------------------------------
# live_reshard
# ---------------------------------------------------------------------------


def test_report_has_the_jax_fields():
    assert [f.name for f in dataclasses.fields(ReshardReport)] == [
        f.name for f in dataclasses.fields(JR.ReshardReport)
    ]


def _state():
    return {
        "w": torch.arange(64 * 128, dtype=torch.float32).reshape(64, 128),
        "small": torch.ones(8),
        "count": torch.tensor(5, dtype=torch.int32),
        "one": torch.tensor([3.0]),
    }


def test_leaves_on_their_device_pass_through():
    """The delta no-op, and on one card every leaf: the step count too."""
    state = _state()
    new, rep = live_reshard(state, {k: "cpu" for k in state}, staging_bytes=8 * 128 * 4)
    assert all(new[k] is state[k] for k in state)
    assert (rep.leaves, rep.chunked_leaves, rep.moved_bytes, rep.max_inflight_bytes, rep.stats) == (4, 0, 0, 0, None)


def test_moved_leaves_are_chunked_bounded_and_row_kernels_skip_scalars(monkeypatch):
    calls = []
    for name in ("pack_rows", "scatter_rows", "relayout_rows"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda x, *a, _n=name, _o=orig: calls.append((_n, tuple(x.shape))) or _o(x, *a))
    state = _state()
    want = {k: v.clone() for k, v in state.items()}
    budget = 8 * 128 * 4  # under w's 32 KB: the chunked path
    new, rep = live_reshard(state, {k: "cpu:0" for k in state}, staging_bytes=budget, donate=False)
    assert rep.leaves == 4 and rep.chunked_leaves == 1
    assert 0 < rep.max_inflight_bytes <= budget
    assert rep.moved_bytes == sum(v.numel() * v.element_size() for v in want.values())
    for k, v in want.items():
        assert new[k] is not state[k] and new[k].dtype == v.dtype and torch.equal(new[k], v), k
        assert torch.equal(state[k], v), k  # donate=False keeps the sources
    # w in 8 batches of 8 rows and small in one, each packed and scattered;
    # the 0-d count and the one-element leaf never reach a row kernel
    assert sorted({s for _, s in calls}) == [(8, 1), (64, 128)]
    assert [n for n, _ in calls].count("pack_rows") == 9 and [n for n, _ in calls].count("scatter_rows") == 9
    assert "relayout_rows" not in {n for n, _ in calls}


def test_donated_sources_are_released():
    """donate=True frees a moved leaf's storage once it has landed, unless
    another leaf shares it or the leaf is a view of a larger storage."""
    state = _state()
    new, _ = live_reshard(state, {k: "cpu:0" for k in state})
    assert state["w"].untyped_storage().nbytes() == 0 and state["small"].untyped_storage().nbytes() == 0
    assert torch.equal(new["w"], torch.arange(64 * 128, dtype=torch.float32).reshape(64, 128))
    shared, base = torch.ones(16, 4), torch.arange(32.0)
    new, _ = live_reshard({"a": shared, "b": shared, "v": base[8:16]}, {"a": "cpu:0", "b": "cpu:0", "v": "cpu:0"})
    assert shared.untyped_storage().nbytes() == 16 * 4 * 4 and torch.equal(new["a"], new["b"])
    assert base.untyped_storage().nbytes() == 32 * 4 and torch.equal(new["v"], base[8:16])
