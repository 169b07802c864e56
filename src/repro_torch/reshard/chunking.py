"""The single chunking implementation shared by every reshard backend.

Oversized payloads are split into fixed-budget row batches along one dim
(paper §5: fixed-size chunks, default 512 MB). Formerly duplicated between
``core/streaming._chunk_task`` (sim) and ``core/reshard._reshard_chunked``
(live); both now call here.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.intersection import TransferTask
from repro_torch.reshard.wire import wire_nbytes


def rows_per_budget(per_row_bytes: int, budget: int) -> int:
    """Rows of ``per_row_bytes`` that fit the staging budget (≥1)."""
    return max(1, budget // max(per_row_bytes, 1))


def row_batches(
    lo: int, hi: int, per_row_bytes: int, budget: int
) -> list[tuple[int, int]]:
    """Split the index range [lo, hi) into consecutive batches whose payload
    (``per_row_bytes`` each) stays within ``budget`` (≥1 row per batch)."""
    rows = rows_per_budget(per_row_bytes, budget)
    out = []
    start = lo
    while start < hi:
        end = min(start + rows, hi)
        out.append((start, end))
        start = end
    return out


def chunk_task(
    task: TransferTask, budget: int, wire_policy=None
) -> list[TransferTask]:
    """Split a task whose payload exceeds the staging budget into sub-slices
    along its largest dim.

    The budget bounds what is physically *staged*: under a quantizing
    ``wire_policy`` a remote task's staged payload is its wire bytes
    (packed elements + sidecar scales), so chunk boundaries are computed
    from the wire size — a quantized task packs ~4× more logical rows into
    the same staging budget. The emitted chunks still carry logical
    ``nbytes`` (the plan's accounting unit); ``wire_policy=None`` preserves
    the historical lossless arithmetic exactly.
    """
    staged = wire_nbytes(wire_policy, task)
    if staged <= budget:
        return [task]
    shape = task.shape()
    d = int(np.argmax(shape))
    if (
        wire_policy is not None
        and getattr(task, "kind", "remote") == "remote"
        and wire_policy.format_for(task.collection) != "none"
        and len(shape) > 0
        and shape[0] > 1
    ):
        # sidecar scales are per dim-0 row: splitting any other dim keeps
        # the full sidecar in every chunk and overshoots the budget, so a
        # quantized task always splits along the leading dim (where
        # staged // shape[0] is its exact per-row wire cost)
        d = 0
    per_row = max(1, staged // shape[d])
    lo, hi = task.bounds[d]
    out = []
    for start, end in row_batches(lo, hi, per_row, budget):
        bounds = list(task.bounds)
        bounds[d] = (start, end)
        out.append(
            TransferTask(
                tensor=task.tensor,
                collection=task.collection,
                src_rank=task.src_rank,
                dst_rank=task.dst_rank,
                bounds=tuple(bounds),
                src_offset=tuple(
                    o + (start - lo if i == d else 0)
                    for i, o in enumerate(task.src_offset)
                ),
                dst_offset=tuple(
                    o + (start - lo if i == d else 0)
                    for i, o in enumerate(task.dst_offset)
                ),
                nbytes=task.nbytes * (end - start) // shape[d],
                layer=task.layer,
                kind=task.kind,
            )
        )
    return out
