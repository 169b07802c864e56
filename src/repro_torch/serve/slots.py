"""Continuous-batching bookkeeping: FIFO request queue + slot allocator.

Slots are cache rows (the batch axis of the decode cache). The allocator
reuses the most-recently-freed slot first (LIFO free list — its cache row
is the one most likely still warm) and counts evictions separately from
voluntary frees: an eviction is a dropped in-flight request, the quantity
the serving benchmark gates at zero across resizes.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["Request", "RequestQueue", "SlotAllocator", "plan_admission"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    submitted_s: float = 0.0
    frames: Optional[np.ndarray] = None  # (frames_len, d_model) — encdec only
    # filled by the serve loop
    slot: int = -1
    tokens: list = field(default_factory=list)  # emitted token ids
    finished: bool = False


class RequestQueue:
    """Strict-FIFO admission queue."""

    def __init__(self):
        self._q: list[Request] = []
        self._ids = itertools.count()

    def submit(
        self, prompt: np.ndarray, max_new_tokens: int, now_s: float = 0.0, frames=None
    ) -> Request:
        req = Request(
            rid=next(self._ids),
            prompt=np.asarray(prompt, dtype=np.int32),
            max_new_tokens=int(max_new_tokens),
            submitted_s=now_s,
            frames=None if frames is None else np.asarray(frames),
        )
        self._q.append(req)
        return req

    def pop(self, n: int) -> list[Request]:
        """Admit up to ``n`` requests, oldest first."""
        taken, self._q = self._q[:n], self._q[n:]
        return taken

    def __len__(self) -> int:
        return len(self._q)


class SlotAllocator:
    """Fixed pool of cache rows with LIFO reuse and eviction accounting."""

    def __init__(self, n_slots: int):
        assert n_slots > 0
        self.n_slots = n_slots
        # LIFO free list: seeded so first-ever allocations come out 0,1,2,...
        self._free: list[int] = list(range(n_slots - 1, -1, -1))
        self._in_use: set[int] = set()
        self.evictions = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> frozenset:
        return frozenset(self._in_use)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        """Voluntary release (request completed)."""
        assert slot in self._in_use, f"slot {slot} not allocated"
        self._in_use.discard(slot)
        self._free.append(slot)

    def evict(self, slot: int) -> None:
        """Forced release (in-flight request dropped) — counted."""
        self.free(slot)
        self.evictions += 1


def plan_admission(
    queue: RequestQueue, slots: SlotAllocator, now_s: float = 0.0
) -> list[Request]:
    """Admit queued requests into free slots, FIFO over requests, LIFO over
    slots. Pure bookkeeping (no device work) so admission-order policy is
    unit-testable without a model."""
    admitted = queue.pop(slots.free_count)
    for req in admitted:
        slot = slots.alloc()
        assert slot is not None
        req.slot = slot
        req.submitted_s = req.submitted_s or now_s
    return admitted
