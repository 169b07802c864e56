"""Live-path resharder over torch tensors (paper §4.6.2 on the live worlds).

:func:`live_reshard_planned` executes an intersection plan (from
``core/intersection.py``) through the shared
:class:`~repro_torch.reshard.engine.ReshardEngine` and the
:class:`~repro_torch.reshard.executors.LiveExecutor`: the same protocol code
the simulated-rank oracle runs, so chunking, staging bounds and byte
accounting cannot diverge between the two paths. The plan-less pytree
path of the JAX package (``live_reshard``) is not ported yet.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.core.intersection import TransferPlan
from repro_torch.core.resource_view import TensorSpec
from repro_torch.reshard.engine import DEFAULT_STAGING_BYTES, ReshardEngine, StreamStats
from repro_torch.reshard.executors import LiveExecutor

__all__ = ["DEFAULT_STAGING_BYTES", "live_reshard_planned"]


def live_reshard_planned(
    specs: list[TensorSpec],
    plan: TransferPlan,
    named_leaves: dict[str, torch.Tensor],
    src_devices: list,
    dst_devices: list,
    staging_bytes: int = DEFAULT_STAGING_BYTES,
    layers: Optional[list[int]] = None,
    wire_policy=None,
) -> tuple[dict[str, torch.Tensor], StreamStats]:
    """Execute an intersection plan on live tensors via the shared engine,
    from the world on ``src_devices`` to the world on ``dst_devices`` (rank
    -> device lists). Returns (destination tensors by name, stats); the
    destinations are complete when it returns."""
    spec_map = {s.name: s for s in specs}
    executor = LiveExecutor(
        spec_map, named_leaves, src_devices, dst_devices, staging_bytes, wire_policy=wire_policy
    )
    engine = ReshardEngine(plan, executor, staging_bytes=staging_bytes, wire_policy=wire_policy)
    stats = engine.run(layers)
    t1 = time.perf_counter()
    executor.block_until_ready()
    stats.drain_seconds += time.perf_counter() - t1
    return executor.results(), stats
