"""Self-tuning operating point for the streaming data plane (DESIGN.md §14).

The fallback lattice (elastic/scheduler.py) picks a *rung* — stream,
stop-copy, checkpoint — but until now the rung's *operating point* was
hand-set: ``stream_k = 4`` layers per pre-copy round (overlap.py) and the
paper's 512 MB staging budget (engine.py). Both are now documented
fallbacks: when the deadline scheduler's estimator (the JAX package's
``elastic/scheduler.py``, not ported yet: ROADMAP queue 1 item 9) has
measured bandwidth and step-time history, :func:`tune_operating_point`
derives the round size, chunk size and staging budget for a specific
(plan remote bytes, warning window) pair.

The tuning model is deliberately simple and monotone:

* A pre-copy round should take a bounded fraction of the window
  (``ROUND_WINDOW_FRAC``), so tight windows run many small rounds — each
  iteration boundary is a deadline check and an abort point — while wide
  windows amortize per-round staging syncs over more layers.
  ``stream_k = bytes_per_round / bytes_per_layer``, clamped to the plan.
* A chunk should take a bounded fraction of the window on the measured
  wire (``CHUNK_WINDOW_FRAC``), clamped between 1 MB and the fallback
  budget: backpressure granularity tracks how much slack the window has.
* The staging budget pins ``STAGING_DEPTH`` chunks (double buffering plus
  headroom), never exceeding the paper's 512 MB default.

Every derived quantity is a clamp of a function non-decreasing in
``window_s`` at fixed bytes/bandwidth, so the chosen ``stream_k`` and
chunk size are monotone non-decreasing in window size — the property the
tuner tests pin.

With no measured bandwidth (cold estimator, duck-typed test controllers)
the tuner returns the historical constants with ``source="fallback"``.

A copy of the JAX package's ``reshard/autotune.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.reshard.engine import DEFAULT_STAGING_BYTES

# fraction of the warning window one pre-copy round may spend on the wire
ROUND_WINDOW_FRAC = 0.10
MIN_ROUND_S = 0.05
MAX_ROUND_S = 30.0
# fraction of the window one staged chunk may spend on the wire
CHUNK_WINDOW_FRAC = 0.01
MIN_CHUNK_S = 0.01
MAX_CHUNK_S = 2.0
MIN_CHUNK_BYTES = 1 << 20  # 1 MB
# staged chunks the budget should hold: two pinned by double buffering,
# plus headroom so backpressure does not serialize dispatch
STAGING_DEPTH = 4
FALLBACK_STREAM_K = 4


@dataclass(frozen=True)
class OperatingPoint:
    """One rung's tuned data-plane parameters."""

    stream_k: int
    chunk_bytes: int
    staging_bytes: int
    source: str  # "measured" | "fallback"

    def to_dict(self) -> dict:
        return {
            "stream_k": self.stream_k,
            "chunk_bytes": self.chunk_bytes,
            "staging_bytes": self.staging_bytes,
            "source": self.source,
        }


FALLBACK = OperatingPoint(
    stream_k=FALLBACK_STREAM_K,
    chunk_bytes=DEFAULT_STAGING_BYTES,
    staging_bytes=DEFAULT_STAGING_BYTES,
    source="fallback",
)


def _clamp(x: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, x))


def tune_operating_point(
    plan_bytes: int,
    layers: int,
    window_s: float,
    bw_bytes_s: float | None,
    step_s: float | None = None,
) -> OperatingPoint:
    """Pick (stream_k, chunk_bytes, staging_bytes) for one reconfiguration.

    ``plan_bytes``/``layers`` describe the remote (wire-priced) work the
    plan still has to move; ``window_s`` is the warning window;
    ``bw_bytes_s`` the estimator's measured effective bandwidth (None or
    <= 0 → fallback constants). ``step_s`` is accepted for interface
    completeness (round pacing is boundary-driven, so the window fraction
    already encodes it).
    """
    del step_s
    if not bw_bytes_s or bw_bytes_s <= 0 or plan_bytes <= 0 or layers <= 0:
        return FALLBACK
    window_s = max(0.0, float(window_s))

    round_s = _clamp(window_s * ROUND_WINDOW_FRAC, MIN_ROUND_S, MAX_ROUND_S)
    bytes_per_round = bw_bytes_s * round_s
    bytes_per_layer = max(1.0, plan_bytes / layers)
    stream_k = int(_clamp(round(bytes_per_round / bytes_per_layer), 1, layers))

    chunk_s = _clamp(window_s * CHUNK_WINDOW_FRAC, MIN_CHUNK_S, MAX_CHUNK_S)
    chunk_bytes = int(
        _clamp(bw_bytes_s * chunk_s, MIN_CHUNK_BYTES, DEFAULT_STAGING_BYTES)
    )
    staging_bytes = int(
        _clamp(chunk_bytes * STAGING_DEPTH, chunk_bytes, DEFAULT_STAGING_BYTES)
    )
    return OperatingPoint(
        stream_k=stream_k,
        chunk_bytes=chunk_bytes,
        staging_bytes=staging_bytes,
        source="measured",
    )
