"""The port's copies of the resource view and the intersection planner
against the JAX package's: logical axes, tensor specs, cache specs and
transfer plans, task by task (tensor, kind, ranks, bounds, offsets, bytes,
layer), for every dense architecture the port supports."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro import configs as jax_configs
from repro.core import intersection as JI
from repro.core import resource_view as JR
from repro.models import model as JM
from repro.serve import cache_view as JC
from repro.utils.pytree import axes_paths as jax_axes_paths
from repro_torch import configs
from repro_torch.core import intersection as I
from repro_torch.core import resource_view as R
from repro_torch.models import model as M
from repro_torch.serve import cache_view as C
from repro_torch.utils.pytree import axes_paths

DENSE = sorted(n for n, c in configs.REGISTRY.items() if c.family == "dense")
PC = configs.ParallelConfig


def _tuples(items):
    return [dataclasses.astuple(x) for x in items]


def _both(name, reduced=True):
    port, ref = configs.get_config(name), jax_configs.get_config(name)
    return (port.reduced(), ref.reduced()) if reduced else (port, ref)


@pytest.mark.parametrize("name", DENSE)
def test_axes_and_specs_equal_jax(name):
    """Full width: the same logical axes and the same training and serving
    param specs (roles, scopes, shapes, float32 dtypes)."""
    port, ref = _both(name, reduced=False)
    assert axes_paths(M.param_logical_axes(port)) == jax_axes_paths(JM.param_logical_axes(ref))
    for kw in ({}, {"include_optimizer": False}, {"zero_sharding": False}):
        assert _tuples(R.build_tensor_specs(port, **kw)) == _tuples(JR.build_tensor_specs(ref, **kw))


@pytest.mark.parametrize("name", DENSE)
def test_reduced_serve_specs_equal_jax(name):
    """Reduced configs run in float32, so the serving specs (params in the
    dtype the port serves with, plus the cache) equal the JAX package's."""
    port, ref = _both(name)
    for batch, max_seq in [(2, 16), (4, 32)]:
        assert _tuples(C.cache_tensor_specs(port, batch, max_seq, "float32")) == _tuples(
            JC.cache_tensor_specs(ref, batch, max_seq, cache_dtype="float32")
        )
        assert _tuples(C.serve_state_specs(port, batch, max_seq, "float32")) == _tuples(
            JC.serve_state_specs(ref, batch, max_seq, cache_dtype="float32")
        )


def test_full_width_serve_specs_hold_the_served_dtypes():
    """At full width the port holds bfloat16 matrices and float32 norm
    scales (model.cast_params), so those specs differ from the JAX
    package's float32 ones in dtype, and in nothing else."""
    port, ref = _both("qwen3-1.7b", reduced=False)
    ours = C.serve_state_specs(port, 8, 544, "bfloat16")
    theirs = JC.serve_state_specs(ref, 8, 544, cache_dtype="bfloat16")
    assert [dataclasses.replace(s, dtype="-") for s in ours] == [
        R.TensorSpec(**{**dataclasses.asdict(t), "dtype": "-"}) for t in theirs
    ]
    norms = {s.name for s in ours if s.name.rsplit("/", 1)[-1] in ("scale", "q_norm", "k_norm")}
    assert norms and all(s.dtype == "float32" for s in ours if s.name in norms)
    assert all(s.dtype == "bfloat16" for s in ours if s.name not in norms)


def test_unported_cache_families_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        C.cache_tensor_specs(configs.get_config("mamba2-2.7b").reduced(), 2, 16)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        C.cache_tensor_specs(configs.get_config("seamless-m4t-large-v2").reduced(), 2, 16)


# ---------------------------------------------------------------------------
# Plans, task by task
# ---------------------------------------------------------------------------

# the hand-built specs and transitions of tests/test_reshard_engine.py
ENGINE_SPECS = [
    ("params/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "params"),
    ("params/blocks/pos0/b", (8, 32), "float32", ("pp", "tp"), "stages", "params"),
    ("params/embed/tok", (64, 32), "float32", ("tp", "none"), "first", "params"),
    ("mu/blocks/pos0/w", (8, 16, 32), "float32", ("pp", "none", "tp"), "stages", "mu"),
]
ENGINE_TRANSITIONS = [
    ("tp_grow", (2, 1, 2), (1, 1, 4)),
    ("dp_grow", (1, 1, 4), (2, 1, 4)),
    ("dp_shrink", (2, 1, 2), (1, 1, 2)),
    ("pp_to_tp", (1, 2, 2), (1, 1, 4)),
    ("tp_to_pp", (2, 1, 2), (1, 4, 2)),
]
# tests/test_serve_reshard.py's cache transitions, and the resizes of the
# elastic serving path
SERVE_TRANSITIONS = [
    ((1, 1, 2), (1, 1, 4)),
    ((1, 1, 2), (2, 1, 2)),
    ((2, 1, 2), (1, 1, 2)),
    ((1, 1, 4), (2, 1, 2)),
    ((2, 1, 2), (1, 1, 1)),
]


def _pcs(a, b):
    (d0, p0, t0), (d1, p1, t1) = a, b
    return (PC(dp=d0, pp=p0, tp=t0), PC(dp=d1, pp=p1, tp=t1)), (
        jax_configs.ParallelConfig(dp=d0, pp=p0, tp=t0),
        jax_configs.ParallelConfig(dp=d1, pp=p1, tp=t1),
    )


@pytest.mark.parametrize("name,a,b", ENGINE_TRANSITIONS)
@pytest.mark.parametrize("policy", ["nearest", "first", "balanced"])
def test_plan_transfer_equals_jax(name, a, b, policy):
    ours, theirs = _pcs(a, b)
    specs = [R.TensorSpec(*s) for s in ENGINE_SPECS]
    plan = I.plan_transfer(specs, *ours, source_policy=policy)
    want = JI.plan_transfer([JR.TensorSpec(*s) for s in ENGINE_SPECS], *theirs, source_policy=policy)
    assert _tuples(plan.tasks) == _tuples(want.tasks)
    assert plan.kind_bytes() == want.kind_bytes()
    I.verify_completeness(specs, plan, ours[1])


def test_survivor_constrained_plan_equals_jax():
    ours, theirs = _pcs((2, 1, 2), (1, 1, 4))
    specs = [R.TensorSpec(*s) for s in ENGINE_SPECS]
    plan = I.plan_transfer(specs, *ours, allowed_src=frozenset({0, 1}))
    want = JI.plan_transfer([JR.TensorSpec(*s) for s in ENGINE_SPECS], *theirs, allowed_src=frozenset({0, 1}))
    assert _tuples(plan.tasks) == _tuples(want.tasks)
    assert plan.lost_bytes == want.lost_bytes


@pytest.mark.parametrize("kv4", [False, True], ids=["qwen3", "qwen3-kv4"])
@pytest.mark.parametrize("a,b", SERVE_TRANSITIONS)
def test_serve_plan_equals_jax(kv4, a, b):
    """Reduced qwen3 and its 4-kv-head variant: params + cache plans equal
    the JAX planner's, and tile every destination view once."""
    port, ref = _both("qwen3-1.7b")
    if kv4:
        port = dataclasses.replace(port, num_kv_heads=4, num_heads=4)
        ref = dataclasses.replace(ref, num_kv_heads=4, num_heads=4)
    ours, theirs = _pcs(a, b)
    specs = C.serve_state_specs(port, 4, 32, "float32")
    plan = C.serve_plan(port, specs, *ours)
    want = JC.serve_plan(ref, JC.serve_state_specs(ref, 4, 32, cache_dtype="float32"), *theirs)
    assert _tuples(plan.tasks) == _tuples(want.tasks)
    assert (plan.network_bytes, plan.local_bytes, plan.resident_bytes) == (
        want.network_bytes, want.local_bytes, want.resident_bytes,
    )
    assert plan.resident_layers() == want.resident_layers()
    I.verify_completeness(specs, plan, ours[1])


@pytest.mark.parametrize("a,b", [((2, 1, 2), (1, 1, 2)), ((1, 1, 2), (1, 1, 4)), ((1, 1, 4), (2, 1, 2))])
def test_full_width_serve_plan_matches_jax_up_to_dtype(a, b):
    """qwen3-1.7b at full width, 8 slots x 544 positions (the elastic
    serving path's resizes): the same tasks as the JAX planner's, each
    task's bytes scaled by the itemsize the port serves that tensor in."""
    port, ref = _both("qwen3-1.7b", reduced=False)
    ours, theirs = _pcs(a, b)
    specs = C.serve_state_specs(port, 8, 544, "bfloat16")
    plan = C.serve_plan(port, specs, *ours)
    want = JC.serve_plan(ref, JC.serve_state_specs(ref, 8, 544, cache_dtype="bfloat16"), *theirs)
    ratio = {s.name: R.itemsize(s.dtype) for s in specs}
    jax_itemsize = {s.name: np.dtype(s.dtype).itemsize for s in JC.serve_state_specs(ref, 8, 544, cache_dtype="bfloat16")}
    assert len(plan.tasks) == len(want.tasks)
    for got, exp in zip(plan.tasks, want.tasks):
        scaled = exp.nbytes // jax_itemsize[exp.tensor] * ratio[exp.tensor]
        assert dataclasses.astuple(got) == dataclasses.astuple(dataclasses.replace(exp, nbytes=scaled))
