"""Minimal deterministic discrete-event simulation engine — the substrate
under the paper's §5 simulator (``sim/liver_sim.py``, Figs. 10–11).

(SimPy — used by the paper — is not installed here; this heapq-based engine
provides the same primitives we need: scheduled callbacks, processes as
generators yielding delays, and resources with FIFO queues.)

A copy of the JAX package's ``sim/des.py``.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Generator, Optional


class Simulator:
    def __init__(self):
        self.now: float = 0.0
        self._heap: list = []
        self._counter = itertools.count()

    def schedule(self, delay: float, fn: Callable, *args) -> None:
        assert delay >= 0
        heapq.heappush(self._heap, (self.now + delay, next(self._counter), fn, args))

    def process(self, gen: Generator) -> None:
        """Run a generator-style process: ``yield delay`` suspends."""

        def step(g):
            try:
                delay = next(g)
            except StopIteration:
                return
            self.schedule(float(delay), step, g)

        step(gen)

    def run(self, until: Optional[float] = None) -> float:
        while self._heap:
            t, _, fn, args = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return self.now
            heapq.heappop(self._heap)
            self.now = t
            fn(*args)
        if until is not None:
            self.now = until
        return self.now
