"""Layer-Streaming Resharding: the simulated-rank front end (paper §4.6.2,
Algorithm 1). A copy of the JAX package's ``core/streaming.py``.

The protocol itself (layer ordering, staging-budget chunking, Theorem 1
accounting) lives in :mod:`repro_torch.reshard.engine`; this module keeps
the multi-rank simulation fixtures (``RankStore`` shard stores) and the
``execute_plan`` entry point, a thin wrapper that runs the shared
:class:`~repro_torch.reshard.engine.ReshardEngine` with a
:class:`~repro_torch.reshard.executors.SimExecutor`: the same engine the
live tensor path uses, so byte accounting agrees across backends by
construction.

Each simulated rank owns only its shard; no full tensor is ever
materialized. Used by the correctness tests and the byte-level oracle.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.intersection import TransferPlan
from repro_torch.core.resource_view import TensorSpec, view_of
from repro_torch.reshard.engine import DEFAULT_STAGING_BYTES, ReshardEngine, StreamStats
from repro_torch.reshard.executors import SimExecutor

__all__ = [
    "DEFAULT_STAGING_BYTES",
    "RankStore",
    "StreamStats",
    "allocate_destination",
    "execute_plan",
    "materialize_rank",
]


class RankStore:
    """Per-rank shard storage: {collection/tensor-path: ndarray shard}."""

    def __init__(self, rank: int):
        self.rank = rank
        self.shards: dict[str, np.ndarray] = {}

    def bytes(self) -> int:
        return sum(a.nbytes for a in self.shards.values())


def materialize_rank(
    specs: list[TensorSpec],
    cfg: ParallelConfig,
    rank: int,
    global_state: dict[str, np.ndarray],
) -> RankStore:
    """Build one rank's shard store by slicing the global reference state
    (test fixture: production state is born sharded)."""
    store = RankStore(rank)
    for spec in specs:
        v = view_of(spec, cfg, rank)
        if v is None:
            continue
        sl = tuple(slice(lo, hi) for lo, hi in v.bounds)
        store.shards[spec.name] = np.ascontiguousarray(global_state[spec.name][sl])
    return store


def allocate_destination(specs: list[TensorSpec], cfg: ParallelConfig, rank: int) -> RankStore:
    """Pre-allocated (zeroed) destination storage for a rank: required for
    training regardless, hence not counted as transfer overhead (Theorem 1,
    item 2)."""
    store = RankStore(rank)
    for spec in specs:
        v = view_of(spec, cfg, rank)
        if v is None:
            continue
        store.shards[spec.name] = np.zeros(v.shape(), dtype=spec.dtype)
    return store


def execute_plan(
    plan: TransferPlan,
    src_stores: dict[int, RankStore],
    dst_stores: dict[int, RankStore],
    staging_bytes: int = DEFAULT_STAGING_BYTES,
    zero_copy_local: bool = True,
    wire_policy=None,
) -> StreamStats:
    """Run Algorithm 1 over simulated ranks via the shared engine.

    ``wire_policy`` (None = lossless) prices remote chunks in their
    compressed wire format for the staging budget and the wire/logical
    byte counters, matching the live path's accounting."""
    engine = ReshardEngine(
        plan,
        SimExecutor(src_stores, dst_stores, wire_policy=wire_policy),
        staging_bytes=staging_bytes,
        zero_copy_local=zero_copy_local,
        wire_policy=wire_policy,
    )
    return engine.run()
