"""Shared record fields for the classified plan IR (DESIGN.md §13).

``ReconfigRecord`` (controller), ``OverlapReport`` (session), and
``EventOutcome`` (trace scheduler) all surface the same reuse accounting;
before this mixin each re-declared ``reused_layers`` independently and the
definitions drifted. ``kw_only`` keeps the inheriting dataclasses free to
declare required positional fields of their own.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ReuseRecordMixin:
    # layers whose bytes were NOT re-streamed: resident layers plus layers
    # adopted from a prior in-flight session on retarget
    reused_layers: int = field(default=0, kw_only=True)
    # layers fully resident under the classified plan (subset of reused)
    resident_layers: int = field(default=0, kw_only=True)
    # plan CELLS classified resident — the unit skipped_bytes accrues in. A
    # partially-resident layer contributes cells (and bytes) here without
    # counting in resident_layers, so the accounting identity is
    # ``skipped_bytes > 0 iff resident_cells > 0``, NOT resident_layers
    resident_cells: int = field(default=0, kw_only=True)
    # plan bytes that never crossed a wire because they were already in place
    skipped_bytes: int = field(default=0, kw_only=True)
    # compressed wire format (DESIGN.md §14): bytes the plan says streamed
    # vs bytes that physically crossed the wire under the wire policy
    # (quantized payload + sidecar scales); equal when lossless
    logical_bytes: int = field(default=0, kw_only=True)
    wire_bytes: int = field(default=0, kw_only=True)


def reuse_identity_ok(rec) -> bool:
    """The reuse-accounting identity every emitted record must satisfy.

    ``skipped_bytes`` accrues per resident CELL, so bytes can be skipped on
    a plan with zero fully-resident layers (a partially-resident layer).
    The invariant that cannot drift is therefore cell-level: bytes were
    skipped iff some cell was resident. Works on any record carrying the
    :class:`ReuseRecordMixin` fields (ReconfigRecord, OverlapReport,
    EventOutcome) or a dict serialization of one.
    """
    if isinstance(rec, dict):
        skipped, cells = rec.get("skipped_bytes", 0), rec.get("resident_cells", 0)
    else:
        skipped, cells = rec.skipped_bytes, rec.resident_cells
    return (skipped > 0) == (cells > 0)
