"""The fleet arbiter: one shared capacity trace, N jobs, one decision
maker (DESIGN.md §18; EasyDL's "Brain"; ROADMAP item 4).

The arbiter owns no job internals — every interaction is an
``elastic/protocol.py`` message against the job's endpoint (live
controller, serving controller, or DES model). Per trace event it

  1. re-partitions the surviving capacity across jobs via its policy
     (``policies.py``), value function = calibrated analytic
     marginal-throughput curves (``roofline/analysis.py``);
  2. applies a churn guard to voluntary grows: ``query_estimate`` prices
     the resize pause, and a grow whose pause costs more samples than the
     throughput gain earns over ``horizon_s`` is skipped (the
     DeadlineEstimator-feasibility check at fleet scope);
  3. emits the per-job resize as protocol commands, picking the rung via
     the same ``choose_mode`` lattice the single-job scheduler uses —
     ``retarget_resize`` when a reconfig is already in flight,
     ``fail_stop_recover`` for unannounced capacity loss.

Cluster-wide goodput is achieved useful work over the best achievable on
the same volatile capacity: ``total samples / ideal samples``, the ideal
being a zero-reconfig-cost marginal allocation of each capacity
interval. Idle devices a policy strands (static's unclaimed growth,
fair-share's snapping losses) therefore count against it — the metric
the benchmark gate compares policies on.

A copy of the JAX package's ``fleet/arbiter.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.events import FailStopEvent, ResizeEvent
from repro_torch.elastic import protocol as p
from repro_torch.elastic.endpoint import Endpoint
from repro_torch.elastic.scheduler import choose_mode
from repro_torch.fleet.policies import JobView, MarginalThroughputPolicy, Policy
from repro_torch.sim.des import Simulator


@dataclass
class FleetJob:
    """One arbitrated job: an endpoint plus what the value function needs
    to price it (size, batch, feasible worlds, weight)."""

    name: str
    endpoint: Endpoint
    params: float
    global_batch: int
    feasible_worlds: tuple[int, ...]
    weight: float = 1.0
    cluster: Optional[object] = None  # sim.cluster.ClusterModel
    # maps a device count to a concrete topology; pure-dp by default,
    # live jobs pass a topology_search-backed callable
    target_fn: Optional[object] = None
    _scale: float = 1.0

    def __post_init__(self) -> None:
        if self.cluster is None:
            from repro_torch.sim.cluster import PAPER_TESTBED

            self.cluster = PAPER_TESTBED
        self.feasible_worlds = tuple(sorted(set(self.feasible_worlds)))
        assert self.feasible_worlds and self.feasible_worlds[0] >= 1

    def target_for(self, world: int) -> ParallelConfig:
        if self.target_fn is not None:
            return self.target_fn(world)
        return ParallelConfig(dp=world)

    def throughput(self, world: int) -> float:
        from repro_torch.roofline.analysis import analytic_throughput

        return self._scale * analytic_throughput(
            self.params, world, self.cluster, self.global_batch
        )

    def calibrate(self, world: int, measured_step_s: float) -> None:
        """Anchor the analytic curve to a measured step time at the
        current world, so live jobs are priced on their real throughput
        (the curve keeps the analytic *shape*, rescaled through the
        measured point)."""
        from repro_torch.roofline.analysis import analytic_throughput

        if measured_step_s <= 0 or world <= 0:
            return
        analytic = analytic_throughput(
            self.params, world, self.cluster, self.global_batch
        )
        if analytic > 0:
            self._scale = (self.global_batch / measured_step_s) / analytic

    def view(self, current: int) -> JobView:
        return JobView(
            name=self.name,
            current=current,
            feasible=self.feasible_worlds,
            weight=self.weight,
            throughput=self.throughput,
        )


@dataclass
class ArbitratedEvent:
    """One per-job decision the arbiter took at a trace event."""

    time_s: float
    capacity: int
    kind: str  # resize | fail_stop | initial
    job: str
    world_before: int
    world_after: int
    decision: str  # stream | stop_copy | peer_recover | checkpoint | skip_churn
    est_pause_s: float = 0.0

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class FleetReport:
    policy: str
    jobs: List[dict]
    events: List[ArbitratedEvent]
    rounds: int
    duration_s: float
    capacity_device_s: float
    total_samples: float
    ideal_samples: float

    @property
    def arbitrated_events(self) -> int:
        return len(self.events)

    @property
    def cluster_goodput(self) -> float:
        """Achieved / ideally-achievable samples on the same capacity
        profile (zero-cost marginal allocation as the oracle). Stranded
        idle devices and reconfiguration pauses both count against it."""
        return self.total_samples / self.ideal_samples if self.ideal_samples else 0.0

    def to_dict(self) -> dict:
        return {
            "policy": self.policy,
            "jobs": self.jobs,
            "rounds": self.rounds,
            "arbitrated_events": self.arbitrated_events,
            "duration_s": self.duration_s,
            "capacity_device_s": self.capacity_device_s,
            "total_samples": self.total_samples,
            "ideal_samples": self.ideal_samples,
            "cluster_goodput": self.cluster_goodput,
            "events": [e.to_dict() for e in self.events],
        }


class FleetArbiter:
    """Drives N endpoints from one capacity trace.

    ``run`` executes the whole fleet on the shared DES clock — endpoints
    must advance on ``sim`` (i.e. :class:`SimEndpoint` s constructed with
    it). For mixed fleets (a live controller in the mix),
    :meth:`plan_assignments` computes the same per-job decisions as pure
    event lists; the live job replays its list through an
    ``ElasticScheduler`` on the wall clock while the sim jobs run here.
    """

    def __init__(
        self,
        jobs: Sequence[FleetJob],
        policy: Policy,
        sim: Optional[Simulator] = None,
        safety: float = 1.25,
        horizon_s: float = 1800.0,
        calibrate: bool = True,
    ):
        assert len({j.name for j in jobs}) == len(jobs), "duplicate job names"
        self.jobs = list(jobs)
        self.policy = policy
        self.sim = sim or Simulator()
        self.safety = safety
        self.horizon_s = horizon_s
        self.calibrate = calibrate
        self.alloc: Dict[str, int] = {}
        self.events: List[ArbitratedEvent] = []
        self._rate_cache: Dict[int, float] = {}

    # -- protocol helpers ------------------------------------------------
    def _status(self, job: FleetJob) -> p.StatusResponse:
        resp = job.endpoint.handle(p.QueryStatus())
        assert isinstance(resp, p.StatusResponse), resp
        return resp

    def _estimate(self, job: FleetJob, target: ParallelConfig):
        resp = job.endpoint.handle(p.QueryEstimate(target=target))
        return resp.estimate if isinstance(resp, p.EstimateResponse) else None

    # -- value function plumbing -----------------------------------------
    def _views(self) -> List[JobView]:
        return [j.view(self.alloc.get(j.name, 0)) for j in self.jobs]

    def _ideal_rate(self, capacity: int) -> float:
        """Best cluster samples/s for ``capacity`` devices, reconfig-free:
        the oracle the cluster-goodput metric divides by. Cacheable per
        capacity because the oracle ignores current placements."""
        if capacity not in self._rate_cache:
            oracle = MarginalThroughputPolicy()
            alloc = oracle.allocate(self._views(), capacity)
            by_name = {j.name: j for j in self.jobs}
            self._rate_cache[capacity] = sum(
                by_name[n].throughput(w) for n, w in alloc.items()
            )
        return self._rate_cache[capacity]

    # -- decisions --------------------------------------------------------
    def _churn_guard(
        self, job: FleetJob, w_old: int, w_new: int, est
    ) -> bool:
        """True = skip this voluntary grow: the resize pause costs more
        samples than the extra devices earn back over the horizon."""
        if w_new <= w_old or est is None:
            return False
        gain = job.throughput(w_new) - job.throughput(w_old)
        pause_cost = est.stop_copy_pause_s * job.throughput(w_old)
        return pause_cost >= gain * self.horizon_s

    def _dispatch(
        self,
        job: FleetJob,
        w_old: int,
        w_new: int,
        t: float,
        capacity: int,
        kind: str,
        warning_s: float,
    ) -> None:
        target = job.target_for(w_new)
        status = self._status(job)
        forced = kind == "fail_stop" and w_new < w_old
        if forced:
            if status.reconfig_pending:
                job.endpoint.handle(p.CancelResize(outcome="retargeted"))
            resp = job.endpoint.handle(
                p.FailStopRecover(
                    target=target,
                    devices_failed=True,
                    lost_ranks=tuple(range(w_new, w_old)),
                )
            )
            pause = (
                resp.record.total_pause_s
                if isinstance(resp, p.RecoverResult)
                else 0.0
            )
            self.events.append(
                ArbitratedEvent(t, capacity, kind, job.name, w_old, w_new,
                                "peer_recover", pause)
            )
            self.alloc[job.name] = w_new
            return
        est = self._estimate(job, target)
        if self._churn_guard(job, w_old, w_new, est):
            self.events.append(
                ArbitratedEvent(t, capacity, kind, job.name, w_old, w_old,
                                "skip_churn",
                                est.stop_copy_pause_s if est else 0.0)
            )
            return
        mode = (
            choose_mode(est, warning_s, self.safety)
            if est is not None
            else "stop_copy"
        )
        if mode in ("stream", "stop_copy"):
            cmd_cls = (
                p.RetargetResize if status.reconfig_pending else p.RequestResize
            )
            job.endpoint.handle(cmd_cls(target=target, overlap=mode))
        else:
            # window already gone: recover across (survivors cover state
            # by construction — the shrink keeps a prefix of devices)
            if status.reconfig_pending:
                job.endpoint.handle(p.CancelResize(outcome="retargeted"))
            job.endpoint.handle(
                p.FailStopRecover(
                    target=target,
                    devices_failed=False,
                    lost_ranks=tuple(range(min(w_old, w_new), w_old)),
                )
            )
            mode = "peer_recover"
        self.events.append(
            ArbitratedEvent(
                t, capacity, kind, job.name, w_old, w_new, mode,
                est.stop_copy_pause_s if est is not None else 0.0,
            )
        )
        self.alloc[job.name] = w_new

    def _rebalance(self, t: float, capacity: int, kind: str,
                   warning_s: float) -> None:
        alloc = self.policy.allocate(self._views(), capacity)
        # shrink first: under a capacity drop the grow targets only have
        # room once the shrinking jobs release their devices
        changes = sorted(
            (
                (name, self.alloc.get(name, 0), w)
                for name, w in alloc.items()
                if w != self.alloc.get(name, 0)
            ),
            key=lambda c: (c[2] - c[1], c[0]),
        )
        by_name = {j.name: j for j in self.jobs}
        for name, w_old, w_new in changes:
            self._dispatch(
                by_name[name], w_old, w_new, t, capacity, kind, warning_s
            )

    # -- entry points -----------------------------------------------------
    def _start(self, initial_capacity: int, warning_s: float) -> None:
        for job in self.jobs:
            status = self._status(job)
            self.alloc[job.name] = status.world_size
            if self.calibrate:
                est = self._estimate(job, job.target_for(status.world_size))
                if est is not None:
                    job.calibrate(status.world_size, est.step_s)
        self._rebalance(self.sim.now, initial_capacity, "initial", warning_s)

    def run(
        self,
        trace: Sequence[Sequence],
        duration_s: float,
        initial_capacity: int,
        default_warning_s: float = 120.0,
    ) -> FleetReport:
        """Execute the fleet over a shared trace of ``(t, capacity[,
        kind[, warning_s]])`` rows on the DES clock (all endpoints must
        share ``self.sim``)."""
        self._start(initial_capacity, default_warning_s)
        capacity = initial_capacity
        cap_t, cap_device_s, ideal = 0.0, 0.0, 0.0
        for row in sorted(trace, key=lambda r: r[0]):
            t = float(row[0])
            if t >= duration_s:
                break
            rate = self._ideal_rate(capacity)
            self.sim.run(until=t)
            cap_device_s += (t - cap_t) * capacity
            ideal += (t - cap_t) * rate
            cap_t = t
            capacity = int(row[1])
            kind = row[2] if len(row) > 2 else "resize"
            warning = float(row[3]) if len(row) > 3 else default_warning_s
            self._rebalance(t, capacity, kind, warning)
        rate = self._ideal_rate(capacity)
        self.sim.run(until=duration_s)
        cap_device_s += (duration_s - cap_t) * capacity
        ideal += (duration_s - cap_t) * rate
        jobs = []
        total = 0.0
        for job in self.jobs:
            ledger = job.endpoint.handle(p.QueryLedger())
            ok = isinstance(ledger, p.LedgerResponse)
            samples = ledger.samples if ok else 0.0
            total += samples
            jobs.append(
                {
                    "name": job.name,
                    "params": job.params,
                    "world": self.alloc.get(job.name, 0),
                    "samples": samples,
                    "goodput": ledger.goodput if ok else 0.0,
                    "pause_seconds": ledger.pause_seconds if ok else 0.0,
                    "steps": ledger.steps if ok else 0,
                }
            )
        return FleetReport(
            policy=self.policy.name,
            jobs=jobs,
            events=list(self.events),
            rounds=len(trace),
            duration_s=duration_s,
            capacity_device_s=cap_device_s,
            total_samples=total,
            ideal_samples=ideal,
        )

    def plan_assignments(
        self,
        trace: Sequence[Sequence],
        initial_capacity: int,
        default_warning_s: float = 120.0,
    ) -> Dict[str, list]:
        """Pure planning for mixed live+sim fleets: the same policy
        decisions as :meth:`run`, returned as per-job
        ResizeEvent/FailStopEvent lists (no endpoint commands, no churn
        guard — the per-job scheduler applies its own lattice when it
        replays them). Times stay in trace seconds."""
        current = {}
        for job in self.jobs:
            current[job.name] = self._status(job).world_size
        out: Dict[str, list] = {j.name: [] for j in self.jobs}
        by_name = {j.name: j for j in self.jobs}

        def rebalance(t: float, capacity: int, kind: str, warning: float):
            views = [by_name[n].view(w) for n, w in current.items()]
            alloc = self.policy.allocate(views, capacity)
            for name, w_new in sorted(
                alloc.items(), key=lambda c: (c[1] - current[c[0]], c[0])
            ):
                w_old = current[name]
                if w_new == w_old:
                    continue
                target = by_name[name].target_for(w_new)
                if kind == "fail_stop" and w_new < w_old:
                    out[name].append(
                        FailStopEvent(
                            time_s=t,
                            target=target,
                            lost_ranks=tuple(range(w_new, w_old)),
                        )
                    )
                else:
                    out[name].append(
                        ResizeEvent(time_s=t, target=target, warning_s=warning)
                    )
                current[name] = w_new

        rebalance(0.0, initial_capacity, "initial", default_warning_s)
        for row in sorted(trace, key=lambda r: r[0]):
            rebalance(
                float(row[0]),
                int(row[1]),
                row[2] if len(row) > 2 else "resize",
                float(row[3]) if len(row) > 3 else default_warning_s,
            )
        return out
