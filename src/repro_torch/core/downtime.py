"""Downtime / goodput accounting (drives Figs. 6–8 benchmarks).

Goodput here = fraction of wall-clock × allocated-GPU area spent making
training progress (the paper's 'training efficiency'), counting
reconfiguration *downtime* against it — the quantity the analytic
``sim.liver_sim.volatility_run`` predicts and Figs. 7–8 plot.

Streamed pre-copy dispatch ("reshard_overlap" intervals) is steady-state
*interference*, not downtime: the paper measures it separately (Fig. 6d,
``benchmarks/bench_interference.py``) and its analytic goodput model
excludes it. On this container's host devices the transfer compute is
serial with training, so folding it into the goodput denominator would
double-count fig-6d overhead at a magnitude real interconnects never see
(documented deviation, DESIGN.md §11). It stays a first-class interval
kind — ``gpu_seconds("reshard_overlap")`` and the bench payloads report
it — it just isn't a pause.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Interval:
    start: float
    end: float
    kind: str  # "train" | "pause" | "idle" | "reshard_overlap"
    gpus: int


@dataclass
class GoodputLedger:
    intervals: list[Interval] = field(default_factory=list)

    def record(self, start: float, end: float, kind: str, gpus: int) -> None:
        assert end >= start
        self.intervals.append(Interval(start, end, kind, gpus))

    def gpu_seconds(self, kind: str | None = None) -> float:
        return sum(
            (iv.end - iv.start) * iv.gpus
            for iv in self.intervals
            if kind is None or iv.kind == kind
        )

    @property
    def goodput(self) -> float:
        """train / (train + downtime): pauses and idle count against
        goodput; streamed-transfer interference does not (module doc)."""
        down = self.gpu_seconds("pause") + self.gpu_seconds("idle")
        train = self.gpu_seconds("train")
        total = train + down
        return train / total if total else 0.0

    @property
    def pause_seconds(self) -> float:
        return sum(iv.end - iv.start for iv in self.intervals if iv.kind == "pause")

    def wasted_gpu_hours(self) -> float:
        return (self.gpu_seconds("pause") + self.gpu_seconds("idle")) / 3600.0
