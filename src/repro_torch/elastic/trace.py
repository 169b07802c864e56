"""Trace -> typed elasticity events (paper §6.4/§6.5 volatility regimes).

``repro_torch.sim.volatility`` emits abstract ``(t, world[, kind, warning])``
rows; the live scheduler needs :class:`ResizeEvent`/:class:`FailStopEvent`
with concrete ``ParallelConfig`` targets. The topology choice is delegated
to ``core/topology_search`` — exactly the external-search integration the
paper defers (§2.3(D)).

A copy of the JAX package's ``elastic/trace.py``. Its targets come from the
port's topology search, which ranks on the H100's constants
(``launch/mesh.py``), so a trace can map to other targets than in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.errors import TraceError
from repro_torch.core.events import FailStopEvent, ResizeEvent

# the kinds the scheduler understands (core/events.py): every warned
# shape change replays as a ResizeEvent, unannounced losses as FailStopEvent
VALID_KINDS = ("resize", "scale_out", "scale_in", "preempt", "fail_stop")


def _validate_row(i: int, row: Sequence) -> None:
    """Typed errors at load time (TraceError, core/errors.py): a malformed
    row used to surface mid-replay as an opaque topology-search or heap
    error — long after the bad generator wrote it."""
    if len(row) < 2:
        raise TraceError(f"trace row {i}: need at least (t, world), got {row!r}")
    t, world = row[0], row[1]
    if not isinstance(t, (int, float)) or not math.isfinite(float(t)) or t < 0:
        raise TraceError(f"trace row {i}: bad timestamp {t!r}")
    if not isinstance(world, (int, float)) or int(world) != world or world <= 0:
        raise TraceError(f"trace row {i}: world must be a positive int, got {world!r}")
    if len(row) > 2 and row[2] not in VALID_KINDS:
        raise TraceError(
            f"trace row {i}: unknown event kind {row[2]!r} "
            f"(expected one of {VALID_KINDS})"
        )
    if len(row) > 3:
        w = row[3]
        # inf is fine (an unhurried resize); negative or NaN is not
        if not isinstance(w, (int, float)) or math.isnan(float(w)) or w < 0:
            raise TraceError(f"trace row {i}: bad warning window {w!r}")
    if len(row) > 4:
        if row[2] != "fail_stop":
            raise TraceError(
                f"trace row {i}: lost_ranks only valid on fail_stop rows"
            )
        try:
            lost = [int(r) for r in row[4]]
        except (TypeError, ValueError):
            raise TraceError(f"trace row {i}: bad lost_ranks {row[4]!r}") from None
        if any(r < 0 for r in lost):
            raise TraceError(f"trace row {i}: negative rank in {row[4]!r}")


def events_from_trace(
    trace: Iterable[Sequence],
    cfg: ModelConfig,
    global_batch: int,
    seq_len: int,
    compress: float = 1.0,
    default_warning_s: float = 120.0,
    max_pp: int = 8,
) -> list:
    """Convert trace rows into scheduler events.

    Rows are ``(t, world)`` (the sim's classic shape), ``(t, world, kind)``,
    ``(t, world, kind, warning_s)`` or ``(t, world, kind, warning_s,
    lost_ranks)`` with ``kind in {"resize", "fail_stop"}`` — the optional
    fifth element (an iterable of rank ids, fail-stop rows only) pins WHICH
    devices died, for fault-injection traces that need the peer-recovery
    donor geometry to be deterministic. ``compress`` divides every time and
    warning window so a multi-hour trace replays against the live
    controller in seconds (a 24 h / 47-event trace at ``compress=3600``
    fires an event roughly every half-minute of wall clock).

    Malformed rows raise :class:`~repro_torch.core.errors.TraceError` up front —
    unknown kind, non-positive world, negative/NaN warning, bad lost set.
    """
    from repro_torch.core.topology_search import best_target

    assert compress > 0, compress
    events = []
    target_cache: dict[int, object] = {}
    for i, row in enumerate(trace):
        _validate_row(i, row)
        t, world = float(row[0]), int(row[1])
        kind = row[2] if len(row) > 2 else "resize"
        warning = float(row[3]) if len(row) > 3 else default_warning_s
        if world not in target_cache:
            target_cache[world] = best_target(
                cfg, world, global_batch, seq_len, max_pp=max_pp
            )
        target = target_cache[world]
        if kind == "fail_stop":
            lost = tuple(int(r) for r in row[4]) if len(row) > 4 else ()
            events.append(
                FailStopEvent(
                    time_s=t / compress, target=target, lost_ranks=lost
                )
            )
        else:
            events.append(
                ResizeEvent(
                    time_s=t / compress,
                    target=target,
                    warning_s=warning / compress,
                    kind=kind,
                )
            )
    return events
