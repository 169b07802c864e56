"""Wall-clock timing utilities used by benchmarks and the controller —
the measurement substrate behind the paper's §6 latency breakdowns
(``ReconfigRecord`` phase timings, Figs. 6a–6d).

A copy of the JAX package's ``utils/timing.py`` (it imports no JAX).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def now() -> float:
    return time.perf_counter()


@dataclass
class Timer:
    """Accumulating named-phase timer.

    >>> t = Timer()
    >>> with t.phase("compile"): ...
    >>> t.totals["compile"]
    """

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    class _Phase:
        def __init__(self, timer: "Timer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = now()
            return self

        def __exit__(self, *exc):
            dt = now() - self.t0
            self.timer.totals[self.name] = self.timer.totals.get(self.name, 0.0) + dt
            self.timer.counts[self.name] = self.timer.counts.get(self.name, 0) + 1
            return False

    def phase(self, name: str) -> "Timer._Phase":
        return Timer._Phase(self, name)

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals):
            lines.append(f"{k:<32s} {self.totals[k]*1e3:10.2f} ms  x{self.counts[k]}")
        return "\n".join(lines)
