"""Speculative warm world pool (DESIGN.md §12).

Every resize that reaches the controller cold pays a full Prepare —
``build_train_world``'s lower + compile — even when the job has already
visited the target configuration (spot capacity oscillates between a few
world sizes) or when an idle gap gave us time to build it ahead of the
warning. DynaTrain and ElasWave (PAPERS.md) both show that pre-building
likely target configurations off the critical path is what makes fast
parallelism switching pay off under *repeated* elasticity events; this
module is that cache.

A :class:`WorldPool` holds completed :class:`~repro.core.shadow.WorldHandle`s
keyed by everything that shapes the compiled executables — model config,
``ParallelConfig``, the device-set fingerprint, batch/sequence shapes,
compression and hint versions (``LiveRController.pool_key``). Warm worlds
enter the pool from three producers:

  * **retired active worlds** — after a commit, the old world's mesh and
    executables are still valid for its configuration; resizing back is
    the single most common elasticity pattern (walk-down then walk-up);
  * **abandoned shadows** — a retargeted/cancelled builder's world
    completes in its orphaned thread and would otherwise pin device memory
    until GC; the pool keeps it warm instead (bounded, LRU-released);
  * **speculative prefetch** — ``LiveRController.prefetch_world`` builds
    the topology search's likely next targets while the controller is idle
    (driven by ``repro.elastic.scheduler.PrefetchPolicy``).

Consumers: ``request_resize``/``retarget_resize`` ``take()`` a matching
world and skip straight past lower+compile to transfer planning (the
record's ``warm_hit`` flag feeds the ``DeadlineEstimator``'s separate
warm/cold prepare estimates), and ``fail_stop_recover`` uses a warm world
the way it uses residual shadow work.

Ownership discipline: ``take`` transfers ownership OUT of the pool (the
handle is about to become the live shadow/active world — the pool must
never release it underneath the controller); ``put`` transfers ownership
IN (eviction calls :meth:`WorldHandle.release`, dropping the executable,
mesh and sharding references so device memory is reclaimable immediately
rather than at GC's leisure). The pool is thread-safe: abandoned builders
deposit from their daemon threads while the training loop takes/puts.

On a per-rank world (``core/rank_controller.py``) every rank process has
its own pool of its own handles, each with its functions and no tensor
(the controller deposits a world without its destination shards). The
keys are the same on every rank, and so are the puts, takes and
invalidations: the controller agrees over the rank pool which speculative
builds are harvested, whether a prefetch starts and whether a take is
used (a world on every rank or on none), so the ranks' pools evict alike.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.shadow import WorldHandle

# a pool key is an opaque hashable tuple built by the owning controller
PoolKey = tuple


@dataclass
class PoolStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    duplicate_puts: int = 0

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class WorldPool:
    """LRU cache of warm :class:`WorldHandle`s with explicit release.

    ``capacity`` bounds how many compiled worlds stay resident — each entry
    pins its executables (and their device constants), so the pool is the
    memory/latency knob: 2–3 covers the walk-down/walk-up oscillation that
    dominates spot traces.
    """

    def __init__(self, capacity: int = 2):
        assert capacity >= 1, "a zero-capacity pool is just a release()"
        self.capacity = capacity
        self._lock = threading.RLock()
        self._entries: "OrderedDict[PoolKey, WorldHandle]" = OrderedDict()
        self.stats = PoolStats()

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def contains(self, key: PoolKey) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def peek(self, key: PoolKey) -> Optional[WorldHandle]:
        """Borrow the resident handle without transferring ownership.

        Read-only uses (e.g. grabbing target shardings to pre-warm the
        transfer executables, DESIGN.md §15): the entry stays pooled, is
        not counted as a hit/miss, and may still be evicted later — the
        caller must not retain the handle past the borrow."""
        with self._lock:
            return self._entries.get(key)

    # -- consume ----------------------------------------------------------
    def take(self, key: PoolKey) -> Optional[WorldHandle]:
        """Remove and return the warm world for ``key``, or None.

        Ownership transfers to the caller: a taken world is about to become
        a live generation, and the pool must never ``release()`` it behind
        the controller's back (which LRU eviction would eventually do)."""
        with self._lock:
            handle = self._entries.pop(key, None)
            if handle is None:
                self.stats.misses += 1
            else:
                self.stats.hits += 1
            return handle

    # -- produce ----------------------------------------------------------
    def put(self, key: PoolKey, handle: WorldHandle) -> None:
        """Deposit a completed world; evicts (and releases) LRU overflow.

        A duplicate key keeps the resident entry — it is equivalent by
        construction of the key — and releases the incoming handle, so a
        retired world never silently pins a second copy of the same
        executables."""
        if handle is None or handle.released:
            return
        evicted: list[WorldHandle] = []
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                self._entries.move_to_end(key)
                self.stats.duplicate_puts += 1
                if existing is not handle:
                    evicted.append(handle)
            else:
                self._entries[key] = handle
                self.stats.puts += 1
                while len(self._entries) > self.capacity:
                    _, old = self._entries.popitem(last=False)
                    self.stats.evictions += 1
                    evicted.append(old)
        # release outside the lock: .delete()/dereference may be slow
        for h in evicted:
            h.release()

    # -- explicit invalidation --------------------------------------------
    def evict(self, key: PoolKey) -> bool:
        """Release and drop one entry (device-memory release is immediate,
        not deferred to GC). Returns True when something was evicted."""
        with self._lock:
            handle = self._entries.pop(key, None)
            if handle is not None:
                self.stats.evictions += 1
        if handle is None:
            return False
        handle.release()
        return True

    def invalidate(self, predicate: Callable[[PoolKey, WorldHandle], bool]) -> int:
        """Evict every entry matching ``predicate`` — the hook for device
        health: a real deployment drops pooled worlds whose fingerprint
        includes a failed device (this repo's host-device fingerprints
        never fail, so only tests and external integrations call this)."""
        with self._lock:
            doomed = [
                (k, h) for k, h in self._entries.items() if predicate(k, h)
            ]
            for k, _ in doomed:
                self._entries.pop(k)
                self.stats.evictions += 1
        for _, h in doomed:
            h.release()
        return len(doomed)

    def clear(self) -> int:
        return self.invalidate(lambda k, h: True)
