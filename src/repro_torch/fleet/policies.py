"""Capacity-partitioning policies for the fleet arbiter (DESIGN.md §18).

Each policy answers one question: given ``capacity`` devices right now
and N jobs with feasible world sizes and throughput curves, who gets how
many? Three ship:

* :class:`StaticPolicy` — the cluster-ops default being argued against:
  shares fixed at admission; growth capacity idles, forced shrinks scale
  everyone down proportionally.
* :class:`FairSharePolicy` — naive equal split, snapped down to each
  job's feasible world sizes; the leftover idles.
* :class:`MarginalThroughputPolicy` — greedy water-filling on the
  marginal-samples-per-device curve (``roofline/analysis.py``): every
  job starts at its floor, then the next feasible growth step always
  goes to the job whose curve pays the most per device. For concave
  per-job curves this greedy is the exact optimum of the discrete
  allocation problem.

All policies are deterministic (ties break on job name) and total
functions of (views, capacity): no internal state except StaticPolicy's
frozen shares.

A copy of the JAX package's ``fleet/policies.py``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class JobView:
    """What a policy may know about a job: no endpoint access, just the
    curve and the current placement (for churn accounting)."""

    name: str
    current: int  # current world size (0 = not running)
    feasible: tuple[int, ...]  # ascending, >= 1 each
    weight: float
    throughput: Callable[[int], float]  # world -> samples/s

    @property
    def floor(self) -> int:
        return self.feasible[0]

    @property
    def cap(self) -> int:
        return self.feasible[-1]

    def snap_down(self, limit: int) -> int:
        """Largest feasible world <= limit (the floor when none fits)."""
        best = self.feasible[0]
        for w in self.feasible:
            if w <= limit:
                best = w
            else:
                break
        return best

    def next_step(self, world: int) -> Optional[int]:
        for w in self.feasible:
            if w > world:
                return w
        return None


def _check(views: List[JobView], capacity: int) -> None:
    floors = sum(v.floor for v in views)
    if capacity < floors:
        raise ValueError(
            f"capacity {capacity} cannot hold the fleet's floors "
            f"({floors} devices across {len(views)} jobs); admission "
            "control must suspend jobs before arbitration"
        )


def _shrink_to_fit(alloc: Dict[str, int], views: List[JobView],
                   capacity: int) -> None:
    """Walk the largest allocations down one feasible step at a time until
    the total fits — deterministic (size then name), floors preserved."""
    by_name = {v.name: v for v in views}
    while sum(alloc.values()) > capacity:
        candidates = sorted(
            (n for n in alloc if alloc[n] > by_name[n].floor),
            key=lambda n: (-alloc[n], n),
        )
        if not candidates:  # unreachable after _check
            raise ValueError("cannot shrink below floors")
        n = candidates[0]
        feas = by_name[n].feasible
        alloc[n] = max(w for w in feas if w < alloc[n])


class Policy:
    name = "abstract"

    def allocate(self, views: List[JobView], capacity: int) -> Dict[str, int]:
        raise NotImplementedError


class StaticPolicy(Policy):
    """Shares frozen at admission (first allocate call, equal split of
    that moment's capacity). Extra capacity later is never claimed;
    capacity loss shrinks everyone proportionally."""

    name = "static"

    def __init__(self, shares: Optional[Dict[str, int]] = None):
        self.shares = dict(shares) if shares else None

    def allocate(self, views: List[JobView], capacity: int) -> Dict[str, int]:
        _check(views, capacity)
        if self.shares is None:
            per = capacity // len(views)
            self.shares = {v.name: max(v.floor, v.snap_down(per)) for v in views}
            _shrink_to_fit(self.shares, views, capacity)
        total = sum(self.shares.values())
        if capacity >= total:
            return dict(self.shares)  # growth capacity idles — the point
        scale = capacity / total
        alloc = {
            v.name: max(v.floor, v.snap_down(int(self.shares[v.name] * scale)))
            for v in views
        }
        _shrink_to_fit(alloc, views, capacity)
        return alloc


class FairSharePolicy(Policy):
    """Equal split of the *current* capacity, snapped down to feasible
    worlds; whatever the snapping strands idles. Adapts to capacity (so
    it beats static on growth) but ignores the curves entirely."""

    name = "fair_share"

    def allocate(self, views: List[JobView], capacity: int) -> Dict[str, int]:
        _check(views, capacity)
        per = capacity // len(views)
        alloc = {v.name: max(v.floor, v.snap_down(per)) for v in views}
        _shrink_to_fit(alloc, views, capacity)
        return alloc


class MarginalThroughputPolicy(Policy):
    """Greedy water-filling on weighted marginal samples/s per device.

    Start every job at its floor; repeatedly grant the feasible growth
    step with the highest ``weight * (T(next) - T(cur)) / (next - cur)``
    that still fits the remaining capacity. Deterministic: gain ties
    break on job name.
    """

    name = "marginal"

    def allocate(self, views: List[JobView], capacity: int) -> Dict[str, int]:
        _check(views, capacity)
        alloc = {v.name: v.floor for v in views}
        left = capacity - sum(alloc.values())
        by_name = {v.name: v for v in views}
        heap: list = []

        def push(v: JobView) -> None:
            cur = alloc[v.name]
            nxt = v.next_step(cur)
            if nxt is None:
                return
            gain = v.weight * (v.throughput(nxt) - v.throughput(cur))
            heapq.heappush(heap, (-gain / (nxt - cur), v.name, cur, nxt))

        for v in views:
            push(v)
        while heap and left > 0:
            neg_gain, name, cur, nxt = heapq.heappop(heap)
            if alloc[name] != cur:  # stale entry
                continue
            if nxt - cur > left or neg_gain >= 0:
                continue  # unaffordable (or worthless) step; drop it
            alloc[name] = nxt
            left -= nxt - cur
            push(by_name[name])
        return alloc


_POLICIES = {
    p.name: p for p in (StaticPolicy, FairSharePolicy, MarginalThroughputPolicy)
}


def make_policy(name: str) -> Policy:
    try:
        return _POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r} (have {sorted(_POLICIES)})"
        ) from None
