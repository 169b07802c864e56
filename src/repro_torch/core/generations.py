"""Generation state machine (paper §4.5.1, Fig. 4).

States: Stable → Prepare → Ready → Switch → Cleanup → Stable. Each world
configuration carries a monotonic generation id; at most two generations
coexist (invariant I2) and stale references to an old generation are
rejected after the switch. Thread-safe: the Companion Manager's background
thread drives Prepare→Ready while the training loop polls.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Optional


class GenState(enum.Enum):
    STABLE = "stable"
    PREPARE = "prepare"
    READY = "ready"
    SWITCH = "switch"
    CLEANUP = "cleanup"


_ALLOWED = {
    GenState.STABLE: {GenState.PREPARE},
    GenState.PREPARE: {GenState.READY, GenState.STABLE},  # STABLE = cancel
    GenState.READY: {GenState.SWITCH, GenState.STABLE},  # STABLE = cancel
    GenState.SWITCH: {GenState.CLEANUP},
    GenState.CLEANUP: {GenState.STABLE},
}


class InvalidTransition(RuntimeError):
    pass


class StaleGeneration(RuntimeError):
    pass


@dataclass
class Generation:
    gen_id: int
    description: str = ""
    payload: object = None  # world handle (mesh + compiled step + shardings)


class GenerationMachine:
    """Tracks the active and (at most one) shadow generation."""

    def __init__(self):
        self._lock = threading.RLock()
        self._state = GenState.STABLE
        self._active = Generation(gen_id=0, description="initial")
        self._shadow: Optional[Generation] = None
        self._next_id = 1
        self.history: list[tuple[str, int]] = [("stable", 0)]

    # -- introspection ----------------------------------------------------
    @property
    def state(self) -> GenState:
        with self._lock:
            return self._state

    @property
    def active(self) -> Generation:
        with self._lock:
            return self._active

    @property
    def shadow(self) -> Optional[Generation]:
        with self._lock:
            return self._shadow

    def generations_alive(self) -> int:
        with self._lock:
            return 1 + (self._shadow is not None)

    # -- transitions -------------------------------------------------------
    def _to(self, new: GenState) -> None:
        if new not in _ALLOWED[self._state]:
            raise InvalidTransition(f"{self._state.value} -> {new.value}")
        self._state = new
        self.history.append((new.value, self._active.gen_id))

    def begin_prepare(self, description: str = "") -> Generation:
        with self._lock:
            self._to(GenState.PREPARE)
            assert self._shadow is None, "invariant I2: at most two generations"
            self._shadow = Generation(gen_id=self._next_id, description=description)
            self._next_id += 1
            return self._shadow

    def mark_ready(self, gen_id: int, payload: object = None) -> None:
        with self._lock:
            self._check_shadow(gen_id)
            if payload is not None:
                self._shadow.payload = payload
            self._to(GenState.READY)

    def begin_switch(self, gen_id: int) -> Generation:
        with self._lock:
            self._check_shadow(gen_id)
            self._to(GenState.SWITCH)
            return self._shadow

    def commit_switch(self, gen_id: int) -> Generation:
        """Atomic swap: shadow becomes active; old world enters Cleanup."""
        with self._lock:
            self._check_shadow(gen_id)
            if self._state != GenState.SWITCH:
                raise InvalidTransition(f"commit from {self._state.value}")
            old = self._active
            self._active = self._shadow
            self._shadow = None
            self._to(GenState.CLEANUP)
            return old

    def finish_cleanup(self) -> None:
        with self._lock:
            self._to(GenState.STABLE)

    def cancel(self) -> None:
        """Abandon a pending shadow (e.g. target topology became stale,
        paper §7 'Concurrent reconfiguration events')."""
        with self._lock:
            if self._state not in (GenState.PREPARE, GenState.READY):
                raise InvalidTransition(f"cancel from {self._state.value}")
            self._shadow = None
            self._to(GenState.STABLE)

    def _check_shadow(self, gen_id: int) -> None:
        if self._shadow is None or self._shadow.gen_id != gen_id:
            raise StaleGeneration(
                f"generation {gen_id} is not the pending shadow "
                f"(shadow={self._shadow.gen_id if self._shadow else None})"
            )
