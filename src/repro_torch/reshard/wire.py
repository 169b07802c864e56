"""Per-kind wire policy for the compressed reshard data plane.

A :class:`WirePolicy` decides, per state collection, which on-the-wire
format a transfer task's bytes travel in: lossless (``"none"``), symmetric
int8, or fp8-e4m3 (kernels in ``repro.kernels.reshard_quant``). The policy
rides from :class:`~repro.core.intersection.TransferTask` through chunk
budgeting (:mod:`repro.reshard.chunking`), the engine's staging accounting,
and both executors, so every byte counter can report *wire* bytes (what
crossed the interconnect, payload + sidecar scales) next to *logical* bytes
(what the plan says moved).

Defaults follow the tolerance of each collection: optimizer moments
(``mu``/``nu``) quantize to int8 — after the delta planner they dominate
remaining plan bytes and Adam's moment estimates tolerate ~1/254 relative
rounding — while parameters stay lossless unless the caller opts into a
bounded-error format. The scalar ``step`` counter and the plan-less
``state`` collection are always lossless. A policy of ``None`` anywhere in
the data plane means fully lossless (the byte-oracle default): constructing
a ``WirePolicy()`` is the opt-in.

Only remote tasks ever consult the policy: resident cells move no bytes and
local cells relayout on-device without crossing a wire.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# Mirrors repro.kernels.reshard_quant: both wire formats are 1-byte payloads
# with one float32 scale per tile (= per row in the executor's collapsed-2D
# streaming path). Kept as plain ints here so plan-time accounting never
# imports the kernel package.
WIRE_FORMATS = ("none", "int8", "fp8_e4m3")
QUANT_ITEMSIZE = 1
SIDECAR_BYTES_PER_TILE = 4


@dataclass(frozen=True)
class WirePolicy:
    """Per-collection wire formats for streamed remote bytes.

    ``moments`` applies to the ``mu``/``nu`` collections, ``params`` to
    ``params``; everything else (``step``, ``state``) is forced lossless.
    """

    moments: str = "int8"
    params: str = "none"

    def __post_init__(self):
        for fmt in (self.moments, self.params):
            if fmt not in WIRE_FORMATS:
                raise ValueError(
                    f"unknown wire format {fmt!r}; expected one of {WIRE_FORMATS}"
                )

    def format_for(self, collection: str) -> str:
        if collection in ("mu", "nu"):
            return self.moments
        if collection == "params":
            return self.params
        return "none"

    # -- byte accounting ----------------------------------------------------

    def wire_row_bytes(self, collection: str, row_elems: int, raw_row_bytes: int) -> int:
        """Wire bytes for one row (= one tile) of a remote task."""
        if self.format_for(collection) == "none":
            return raw_row_bytes
        return row_elems * QUANT_ITEMSIZE + SIDECAR_BYTES_PER_TILE

    def wire_nbytes(self, task) -> int:
        """Wire bytes for a whole remote task (payload + sidecar scales).

        Logical bytes for lossless collections; for quantized ones, one
        byte per element plus one sidecar scale per leading-dim row. Scalar
        (rank-0) tasks count as a single tile.
        """
        if self.format_for(task.collection) == "none":
            return task.nbytes
        shape = task.shape()
        elems = math.prod(shape) if shape else 1
        rows = shape[0] if shape else 1
        return elems * QUANT_ITEMSIZE + rows * SIDECAR_BYTES_PER_TILE


def wire_nbytes(policy: "WirePolicy | None", task) -> int:
    """Wire bytes under ``policy`` (``None`` = fully lossless)."""
    if policy is None or getattr(task, "kind", "remote") != "remote":
        return task.nbytes
    return policy.wire_nbytes(task)
