"""Elasticity events (paper §4.1 'Elasticity event spectrum').

Planned resizes and preemption warnings carry a warning window — use
``warning_s=float("inf")`` for a planned resize with no deadline at all
(the arithmetic is inf-safe end to end; serialized payloads render it as
the string ``"inf"``). Fail-stop events have no window; the scheduler
recovers them from peer replicas when the survivors cover the state,
falling back to the durable checkpoint (DESIGN.md §15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ParallelConfig


@dataclass(frozen=True)
class ResizeEvent:
    """Warning-based or planned elasticity event."""

    time_s: float  # when the event fires (trace time)
    target: ParallelConfig  # topology chosen by the (external) search system
    warning_s: float = 120.0  # e.g. AWS Spot's 2-minute notice
    kind: str = "resize"  # resize | scale_out | scale_in | preempt

    @property
    def deadline_s(self) -> float:
        return self.time_s + self.warning_s


@dataclass(frozen=True)
class FailStopEvent:
    """Unannounced failure: zero warning window. The scheduler routes these
    to peer-replica recovery (controller ``fail_stop_recover``), which
    demotes to the durable checkpoint only when survivors + parity cannot
    cover the state; ``target`` is the post-failure topology when the
    (external) search
    system has already chosen one, else the scheduler picks via
    :func:`repro.core.topology_search.best_target` over the surviving
    devices."""

    time_s: float
    lost_ranks: tuple[int, ...] = ()
    kind: str = "fail_stop"
    target: Optional[ParallelConfig] = None


ElasticityEvent = ResizeEvent | FailStopEvent


def sort_trace(events: list) -> list:
    """Events in firing order (stable for simultaneous arrivals, which the
    scheduler then coalesces)."""
    return sorted(events, key=lambda e: e.time_s)
