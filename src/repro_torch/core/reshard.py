"""Live-path resharder over torch tensors (paper §4.6.2 on the live worlds).

:func:`live_reshard_planned` executes an intersection plan (from
``core/intersection.py``) through the shared
:class:`~repro_torch.reshard.engine.ReshardEngine` and the
:class:`~repro_torch.reshard.executors.LiveExecutor`: the same protocol code
the simulated-rank oracle runs, so chunking, staging bounds and byte
accounting cannot diverge between the two paths.
:func:`plan_state_transfer`, :func:`named_state_leaves` and
:func:`rebuild_state` name the training state (params and Adam moments) as
the plan does. The plan-less pytree path of the JAX package
(``live_reshard``) is not ported yet: the state outside the resource view
(the step count) is one scalar, and on one card it stays where it is
(``core/controller.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.intersection import TransferPlan, plan_transfer
from repro_torch.core.resource_view import TensorSpec, build_tensor_specs
from repro_torch.reshard.engine import DEFAULT_STAGING_BYTES, ReshardEngine, StreamStats
from repro_torch.reshard.executors import LiveExecutor
from repro_torch.utils.pytree import tree_from_paths, tree_paths

__all__ = [
    "DEFAULT_STAGING_BYTES",
    "live_reshard_planned",
    "named_state_leaves",
    "plan_state_transfer",
    "rebuild_state",
]


def plan_state_transfer(
    cfg: ModelConfig,
    cfg_src: ParallelConfig,
    cfg_dst: ParallelConfig,
    source_policy: str = "nearest",
    allowed_src=None,
) -> tuple[list[TensorSpec], TransferPlan]:
    """Specs + intersection plan for the live training state (params, mu,
    nu). ``zero_sharding=False``: moments are laid out like their params,
    so the plan's bytes are what moves."""
    from repro_torch.models.transformer import block_program

    specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
    plan = plan_transfer(
        specs,
        cfg_src,
        cfg_dst,
        source_policy=source_policy,
        layer_granular=True,
        num_positions=len(block_program(cfg)),
        allowed_src=allowed_src,
    )
    return specs, plan


def named_state_leaves(params: dict, opt_state: dict) -> tuple[dict[str, torch.Tensor], dict]:
    """Flatten live training state into the resource view's tensor names:
    (``params/...``, ``mu/...``, ``nu/...`` leaves, leftovers such as the
    step count)."""
    named: dict[str, torch.Tensor] = {f"params/{p}": x for p, x in tree_paths(params).items()}
    extras: dict = {}
    for coll, sub in opt_state.items():
        if coll in ("mu", "nu"):
            named.update({f"{coll}/{p}": x for p, x in tree_paths(sub).items()})
        else:
            extras[coll] = sub
    return named, extras


def rebuild_state(named: dict[str, torch.Tensor], params_like: dict, opt_like: dict, extras: dict) -> tuple[dict, dict]:
    """Inverse of :func:`named_state_leaves`."""
    params = tree_from_paths({p: named[f"params/{p}"] for p in tree_paths(params_like)})
    opt: dict = {}
    for coll, sub in opt_like.items():
        if coll in ("mu", "nu"):
            opt[coll] = tree_from_paths({p: named[f"{coll}/{p}"] for p in tree_paths(sub)})
        else:
            opt[coll] = extras[coll]
    return params, opt


def live_reshard_planned(
    specs: list[TensorSpec],
    plan: TransferPlan,
    named_leaves: dict[str, torch.Tensor],
    src_devices: list,
    dst_devices: list,
    staging_bytes: int = DEFAULT_STAGING_BYTES,
    layers: Optional[list[int]] = None,
    wire_policy=None,
    dst_buffers: Optional[dict[str, torch.Tensor]] = None,
) -> tuple[dict[str, torch.Tensor], StreamStats]:
    """Execute an intersection plan on live tensors via the shared engine,
    from the world on ``src_devices`` to the world on ``dst_devices`` (rank
    -> device lists), under ``wire_policy`` (None = lossless), into
    ``dst_buffers`` where given. Returns (destination tensors by name,
    stats); the destinations are complete when it returns."""
    spec_map = {s.name: s for s in specs}
    executor = LiveExecutor(
        spec_map, named_leaves, src_devices, dst_devices, staging_bytes, wire_policy=wire_policy,
        dst_buffers=dst_buffers,
    )
    engine = ReshardEngine(plan, executor, staging_bytes=staging_bytes, wire_policy=wire_policy)
    stats = engine.run(layers)
    t1 = time.perf_counter()
    executor.block_until_ready()
    stats.drain_seconds += time.perf_counter() - t1
    return executor.results(), stats
