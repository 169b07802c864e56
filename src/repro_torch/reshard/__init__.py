"""Plan-driven reshard engine (paper §4.6, Algorithm 1) — one subsystem
behind both execution backends.

  * :class:`ReshardEngine` — backend-agnostic Algorithm 1 driver: layer
    ordering, staging-budget chunking (Theorem 1 accounting), barriers,
    :class:`StreamStats` byte/phase accounting (a copy of the JAX
    package's).
  * :class:`SimExecutor` — multi-rank byte-level oracle over numpy shards.
  * :class:`LiveExecutor` — the live path over torch tensors, moving rows
    with the hand-written CUDA kernels of ``kernels/reshard_pack.py``.
  * :class:`OverlapSession` — pre-copy rounds between training steps, the
    dirty-layer re-sync and the split-step commit's drain.
  * :class:`WirePolicy` — per-collection wire formats: lossless, or the
    moments quantized by the hand-written CUDA kernels of
    ``kernels/reshard_quant.py``.
  * :class:`OperatingPoint` / :func:`tune_operating_point` — a
    reconfiguration's tuned ``stream_k`` and staging budget.
"""

from repro_torch.reshard.autotune import OperatingPoint, tune_operating_point
from repro_torch.reshard.chunking import chunk_task, row_batches
from repro_torch.reshard.engine import DEFAULT_STAGING_BYTES, ReshardEngine, StreamStats
from repro_torch.reshard.executors import LiveExecutor, SimExecutor
from repro_torch.reshard.overlap import OverlapReport, OverlapSession
from repro_torch.reshard.wire import WirePolicy, wire_nbytes

__all__ = [
    "DEFAULT_STAGING_BYTES",
    "LiveExecutor",
    "OperatingPoint",
    "OverlapReport",
    "OverlapSession",
    "ReshardEngine",
    "SimExecutor",
    "StreamStats",
    "WirePolicy",
    "chunk_task",
    "row_batches",
    "tune_operating_point",
    "wire_nbytes",
]
