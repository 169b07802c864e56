"""Plan-driven reshard engine (paper §4.6, Algorithm 1) — one subsystem
behind both execution backends.

  * :class:`ReshardEngine` — backend-agnostic Algorithm 1 driver: layer
    ordering, staging-budget chunking (Theorem 1 accounting), barriers,
    :class:`StreamStats` byte/phase accounting (a copy of the JAX
    package's).
  * :class:`SimExecutor` — multi-rank byte-level oracle over numpy shards.
  * :class:`LiveExecutor` — the live path over torch tensors, moving rows
    with the hand-written CUDA kernels of ``kernels/reshard_pack.py``.
  * :class:`WirePolicy` — per-collection wire formats; this slice moves
    only the lossless wire.
"""

from repro_torch.reshard.chunking import chunk_task, row_batches
from repro_torch.reshard.engine import DEFAULT_STAGING_BYTES, ReshardEngine, StreamStats
from repro_torch.reshard.executors import LiveExecutor, SimExecutor
from repro_torch.reshard.wire import WirePolicy, wire_nbytes

__all__ = [
    "DEFAULT_STAGING_BYTES",
    "LiveExecutor",
    "ReshardEngine",
    "SimExecutor",
    "StreamStats",
    "WirePolicy",
    "chunk_task",
    "row_batches",
    "wire_nbytes",
]
