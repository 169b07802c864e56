"""Deadline-aware elasticity scheduler over a control-plane endpoint
(DESIGN.md §10, §17; paper §2.3 event streams, §4.1 warning windows).

The paper's volatility numbers assume every event lands inside its warning
window; this module is the event loop that makes that true. It used to
call ``LiveRController`` methods directly — it now speaks ONLY the typed
protocol of ``elastic/protocol.py`` against an ``elastic/endpoint.py``
endpoint, so the same loop drives a live controller, a serving
controller, or a calibrated DES model, locally or (eventually) across a
real transport. For each event it

  1. estimates trigger-to-safe time for each rung of the fallback lattice
     (overlapped streaming -> stop-copy -> peer-recovery -> durable
     checkpoint) via ``query_estimate`` (or a driver-side estimator),
  2. picks the highest rung whose estimate (x safety margin) fits the
     warning window,
  3. coalesces duplicate events and retargets the in-flight reconfiguration
     when a newer event supersedes it (``retarget_resize`` adopts the
     already-streamed intersection state so the stream continues instead of
     restarting), and
  4. escalates mid-stream to stop-copy (``escalate_commit``) when the
     remaining window no longer covers the pre-copy schedule.

Trace times run on a *virtual clock*: ``clock += wall_dt * time_scale``
against live endpoints; endpoints that own a simulated clock report it in
``StepResult.clock_s`` and the trace clock follows that instead. Measured
goodput comes from the endpoint's ``query_ledger`` — real pauses, not
modeled ones — which ``benchmarks/bench_goodput.py`` reports next to the
analytic ``sim.liver_sim.volatility_run`` prediction.

A copy of the JAX package's ``elastic/scheduler.py``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.errors import ProtocolError
from repro_torch.core.events import FailStopEvent, ResizeEvent, sort_trace
from repro_torch.core.records import ReuseRecordMixin
from repro_torch.elastic import protocol as p
from repro_torch.elastic.endpoint import (
    DeadlineEstimator,
    Endpoint,
    PrefetchPolicy,
    as_endpoint,
)
from repro_torch.elastic.protocol import ErrorResponse, ReconfigEstimate, RecordView
from repro_torch.reshard.autotune import tune_operating_point


# ---------------------------------------------------------------------------
# The fallback-lattice decision (pure; unit-testable)
# ---------------------------------------------------------------------------


def choose_mode(
    est: ReconfigEstimate,
    window_s: float,
    safety: float = 1.25,
    time_scale: float = 1.0,
    lossless: bool = False,
) -> str:
    """The fallback lattice: highest rung whose estimate fits the window.

    overlap ("stream") completes slowest but pauses least; stop-copy
    completes right after Prepare at the price of one long pause;
    peer_recover (DESIGN.md §15) needs nothing inside the window at all —
    the survivors retain the state in device memory past the deadline and
    the donor stream runs after it — so like checkpoint it always *fits*,
    but it is only *available* when the survivor set covers the state
    (``est.peer_ok``); the checkpoint rung (durable save, restart on the
    target) is the unconditional last resort beneath it.

    ``lossless=True`` re-ranks the lattice on the uncompressed transfer
    estimates — the counterfactual decision the scheduler reports so the
    benchmark can show which events the compressed wire promoted a rung.
    """
    stream_s = est.stream_total_lossless_s if lossless else est.stream_total_s
    stop_s = (
        est.stop_copy_total_lossless_s if lossless else est.stop_copy_total_s
    )
    if stream_s * safety * time_scale <= window_s:
        return "stream"
    if stop_s * safety * time_scale <= window_s:
        return "stop_copy"
    if est.peer_ok:
        return "peer_recover"
    return "checkpoint"


# ---------------------------------------------------------------------------
# Per-event bookkeeping
# ---------------------------------------------------------------------------


@dataclass
class EventOutcome(ReuseRecordMixin):
    # reused_layers / resident_layers / skipped_bytes come from the shared
    # ReuseRecordMixin (classified plan IR, DESIGN.md §13)
    index: int
    kind: str  # resize | fail_stop
    time_s: float
    window_s: float
    target: str
    # stream | stop_copy | peer_recover | checkpoint | coalesce | cancel | noop
    decision: str = ""
    # the counterfactual rung the lattice would have picked on the
    # uncompressed transfer estimate — differs from ``decision`` exactly
    # when the compressed wire promoted this event a rung (DESIGN.md §14)
    decision_lossless: str = ""
    outcome: str = ""  # committed | retargeted | fell_back | aborted | coalesced
    gen_id: int = -1
    mode: str = ""  # ReconfigRecord.mode of the commit, when one happened
    est_stream_total_s: float = 0.0
    est_stop_copy_total_s: float = 0.0
    commit_clock_s: float = -1.0
    met_deadline: Optional[bool] = None
    pause_s: float = 0.0
    operating_point: Optional[dict] = None  # tuned data-plane parameters

    def to_dict(self) -> dict:
        # non-finite floats (infinite warning windows) render as "inf" —
        # ``json.dumps(float("inf"))`` emits non-standard ``Infinity``
        d = dict(self.__dict__)
        for k, v in d.items():
            if isinstance(v, float) and not math.isfinite(v):
                d[k] = "inf" if v > 0 else "-inf"
        return d


@dataclass
class _Pending:
    outcome: EventOutcome
    target: Any
    gen_id: int
    deadline: float
    mode: str
    est: ReconfigEstimate


@dataclass
class ScheduleReport:
    outcomes: list[EventOutcome]
    steps: int
    duration_s: float  # virtual trace time covered
    wall_s: float
    goodput: float
    pause_seconds: float

    def count(self, outcome: str) -> int:
        return sum(1 for o in self.outcomes if o.outcome == outcome)

    @property
    def aborted(self) -> int:
        return self.count("aborted")

    def to_dict(self) -> dict:
        return {
            "events": [o.to_dict() for o in self.outcomes],
            "steps": self.steps,
            "duration_s": self.duration_s,
            "wall_s": self.wall_s,
            "goodput": self.goodput,
            "pause_seconds": self.pause_seconds,
            "outcome_counts": {
                k: self.count(k)
                for k in (
                    "committed", "retargeted", "fell_back", "aborted", "coalesced",
                )
            },
        }


# ---------------------------------------------------------------------------
# The event loop
# ---------------------------------------------------------------------------


class ElasticScheduler:
    """Replays an elasticity-event trace against a control-plane endpoint.

    Accepts either an :class:`~repro_torch.elastic.endpoint.Endpoint` or a bare
    controller (auto-wrapped in a :class:`ControllerEndpoint`). Every
    interaction with the job is a protocol message — this class holds no
    reference to the controller and never touches its attributes, which
    is what lets the fleet arbiter swap in serialized transports and
    simulated jobs.

    ``time_scale`` converts wall seconds into virtual trace seconds
    (``clock += dt * time_scale``); estimates are scaled the same way before
    deadline comparisons. ``sync_prepare`` blocks on shadow builds so replay
    is step-deterministic (parity tests / ``--check`` gates); the default
    keeps Prepare fully overlapped with training, as in the paper.
    ``estimator`` keeps rung decisions driver-side (a calibrated
    :class:`DeadlineEstimator` or a test stub); without one the scheduler
    asks the endpoint via ``query_estimate``.
    """

    def __init__(
        self,
        controller,
        time_scale: float = 1.0,
        safety: float = 1.25,
        estimator: Optional[DeadlineEstimator] = None,
        sync_prepare: bool = False,
        mode_override: Optional[str] = None,
        tail_steps: int = 2,
        max_steps: int = 5000,
        on_event: Optional[Callable[[EventOutcome], None]] = None,
        prefetch_k: int = 0,
        prefetch: Optional[PrefetchPolicy] = None,
    ):
        self.endpoint: Endpoint = as_endpoint(
            controller, prefetch=prefetch, prefetch_k=prefetch_k
        )
        self.time_scale = time_scale
        self.safety = safety
        self.estimator = estimator
        self.sync_prepare = sync_prepare
        self.mode_override = mode_override
        self.tail_steps = tail_steps
        self.max_steps = max_steps
        self.on_event = on_event
        # speculative warm-pool prefetch runs endpoint-side; the scheduler
        # only decides WHEN to tick (idle steps / mid-reconfig stream-ahead)
        self._prefetch_enabled = (
            getattr(self.endpoint, "prefetch", None) is not None
        )
        self.clock = 0.0
        self.total_steps = 0
        self.outcomes: list[EventOutcome] = []
        self._pending: Optional[_Pending] = None
        self._seen = self._status().records

    # -- protocol plumbing ----------------------------------------------
    def _send(self, cmd, allow_error: bool = False):
        resp = self.endpoint.handle(cmd)
        if isinstance(resp, ErrorResponse) and not allow_error:
            raise ProtocolError(
                f"{type(cmd).__name__} -> {resp.kind}: {resp.message}"
            )
        return resp

    def _status(self) -> p.StatusResponse:
        return self._send(p.QueryStatus())

    def _estimate(self, target) -> ReconfigEstimate:
        if self.estimator is not None:
            return self.estimator.estimate(target)
        return self._send(p.QueryEstimate(target=target)).estimate

    @property
    def prefetch(self):
        """The endpoint-side prefetch policy (bench/report convenience)."""
        return getattr(self.endpoint, "prefetch", None)

    # -- clock ----------------------------------------------------------
    def _clocked(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.clock += (time.perf_counter() - t0) * self.time_scale
        return out

    def _step(self) -> None:
        if self.total_steps >= self.max_steps:
            raise RuntimeError(
                f"scheduler exceeded max_steps={self.max_steps} "
                "(runaway trace or a reconfiguration that never commits)"
            )
        t0 = time.perf_counter()
        resp = self._send(p.TrainSteps(n=1))
        if resp.clock_s >= 0.0:
            # the endpoint owns a (simulated) clock: trace time follows it
            self.clock = max(self.clock, resp.clock_s)
        else:
            self.clock += (time.perf_counter() - t0) * self.time_scale
        self.total_steps += 1
        self._absorb()
        self._enforce_deadline()
        if self._prefetch_enabled and (
            self._pending is None or self._status().reconfig_pending
        ):
            # idle between events: warm the pool for the likely next
            # targets (speculative build threads; never during a real
            # reconfiguration — the controller refuses then). Mid-
            # reconfiguration the tick still runs, but only stream-ahead
            # prewarms the INCOMING world's failover pairs — that window
            # is exactly when those pairs must compile for a window-0
            # event right after the commit to find them warm
            self._send(p.PrefetchTick())

    def _advance_to(self, t: float) -> None:
        while self.clock < t:
            self._step()
        self.clock = max(self.clock, t)

    # -- record bookkeeping ---------------------------------------------
    def _absorb(self) -> None:
        """Match freshly-appended reconfig records to the pending event."""
        resp = self._send(p.QueryRecords(since=self._seen))
        self._seen = resp.total
        for rec in resp.records:
            pend = self._pending
            if (
                pend is not None
                and rec.gen_id == pend.gen_id
                and rec.outcome != "retargeted"
            ):
                o = pend.outcome
                o.outcome = rec.outcome
                o.mode = rec.mode
                o.commit_clock_s = self.clock
                o.met_deadline = self.clock <= pend.deadline
                o.reused_layers = rec.reused_layers
                o.resident_layers = rec.resident_layers
                o.skipped_bytes = rec.skipped_bytes
                o.resident_cells = rec.resident_cells
                o.wire_bytes = rec.wire_bytes
                o.logical_bytes = rec.logical_bytes
                if rec.operating_point is not None:
                    o.operating_point = rec.operating_point
                o.pause_s = rec.total_pause_s
                self._pending = None

    def _skip_records(self) -> None:
        """Fast-forward the absorb cursor past records the scheduler has
        already accounted for through a direct command's response."""
        self._seen = self._status().records

    def _enforce_deadline(self) -> None:
        """Escalate down the lattice when the window stops covering the
        remaining schedule (graceful degradation, paper §4.1)."""
        pend = self._pending
        if pend is None:
            return
        margin = (
            self.safety
            * (pend.est.stop_copy_pause_s + pend.est.step_s)
            * self.time_scale
        )
        if pend.mode == "stream" and self.clock >= pend.deadline - margin:
            resp = self._clocked(lambda: self._send(p.EscalateCommit()))
            if resp.escalated:
                self._absorb()
                return
        if self.clock > pend.deadline:
            # window missed with the shadow still building: drop down the
            # lattice — peer_recover when coverage holds, else checkpoint
            if pend.est.peer_ok or self._status().durable:
                self._send(p.CancelResize(outcome="aborted"))
                self._restore(pend.target, pend.outcome, save_first=True)
                pend.outcome.met_deadline = False
                self._skip_records()
                self._pending = None
            # else: keep trying — the reconfig will land late (met_deadline
            # False) but the run survives; aborting gains nothing

    # -- recovery rungs ---------------------------------------------------
    def _restore(self, target, o: EventOutcome, save_first: bool) -> None:
        """Below-stop-copy rungs for a *warned* event past its window:
        durable save inside the window (belt, when a ckpt_dir exists),
        then recover — the endpoint streams from peers when they cover
        the state and demotes to the checkpoint restore itself.

        ``save_first`` doubles as the device-health signal: a warned event
        saves inside the window and its devices are fine (warm worlds stay
        valid); an unannounced fail-stop cannot save and its devices are
        suspect (``devices_failed`` purges overlapping pool entries)."""
        if save_first and self._status().durable:
            self._clocked(lambda: self._send(p.CheckpointNow()))
        self._recover(target, o, devices_failed=not save_first)

    def _recover(
        self,
        target,
        o: EventOutcome,
        devices_failed: bool,
        lost_ranks: tuple = (),
    ) -> None:
        """The peer_recover rung (DESIGN.md §15), checkpoint demoted.

        For a warned event (``devices_failed=False``) the lost set is the
        prefix-allocation complement of the target — the same geometry the
        estimator priced — so the donor stream never reads a rank that is
        about to vanish. The endpoint internally demotes to the durable
        checkpoint when peers + parity cannot cover the state, and answers
        ``ErrorResponse("recovery")`` when no rung is left (retired as
        ``aborted``)."""
        if not devices_failed and not lost_ranks:
            cur = self._status().world_size
            lost_ranks = tuple(range(target.world_size, cur))
        resp = self._clocked(
            lambda: self._send(
                p.FailStopRecover(
                    target=target,
                    devices_failed=devices_failed,
                    lost_ranks=tuple(lost_ranks),
                ),
                allow_error=True,
            )
        )
        if isinstance(resp, ErrorResponse):
            if resp.kind != "recovery":
                raise ProtocolError(
                    f"FailStopRecover -> {resp.kind}: {resp.message}"
                )
            # no surviving replica, no fresh parity, no durable checkpoint:
            # the honest outcome is an abort
            o.decision = o.decision or "peer_recover"
            o.outcome = "aborted"
            return
        rec: RecordView = resp.record
        o.decision = (
            "peer_recover" if rec.mode == "peer_recover" else "checkpoint"
        )
        o.outcome = rec.outcome
        o.mode = rec.mode
        o.commit_clock_s = self.clock
        o.pause_s = rec.total_pause_s
        self._skip_records()

    # -- event handling ---------------------------------------------------
    def _handle_resize(self, ev: ResizeEvent, o: EventOutcome) -> None:
        target = ev.target
        pend = self._pending
        window = max(0.0, ev.deadline_s - self.clock)
        o.window_s = window
        current = self._status().parallel

        if pend is not None and target == pend.target:
            # duplicate warning for the in-flight target: coalesce, keeping
            # the tighter deadline
            o.decision, o.outcome = "coalesce", "coalesced"
            pend.deadline = min(pend.deadline, ev.deadline_s)
            return
        if pend is None and target == current:
            o.decision, o.outcome = "noop", "coalesced"  # already there
            return
        if pend is not None and target == current:
            # the newer event returns to the CURRENT config: cancel the
            # in-flight reconfiguration outright (paper §7 stale target)
            pend.outcome.outcome = "retargeted"
            self._send(p.CancelResize(outcome="retargeted"))
            self._skip_records()
            self._pending = None
            o.decision, o.outcome = "cancel", "committed"
            return

        est = self._estimate(target)
        o.est_stream_total_s = est.stream_total_s
        o.est_stop_copy_total_s = est.stop_copy_total_s
        mode = self.mode_override or choose_mode(
            est, window, self.safety, self.time_scale
        )
        o.decision = mode
        o.decision_lossless = self.mode_override or choose_mode(
            est, window, self.safety, self.time_scale, lossless=True
        )

        # tune the rung's operating point for this (plan, window) pair —
        # measured bandwidth only; a cold estimator yields the fallback
        # constants (source="fallback") and the controller keeps its own
        if self.estimator is not None:
            bw = getattr(self.estimator, "measured_bandwidth", lambda: None)()
        else:
            bw = est.measured_bw or None
        op = tune_operating_point(
            est.wire_bytes,
            est.layers,
            window / self.time_scale if self.time_scale > 0 else window,
            bw,
            step_s=est.step_s,
        )
        o.operating_point = op.to_dict()

        if pend is not None:
            # a newer event supersedes the in-flight reconfiguration
            pend.outcome.outcome = "retargeted"
            if mode in ("checkpoint", "peer_recover"):
                self._send(p.CancelResize(outcome="retargeted"))
                self._pending = None
                if mode == "peer_recover":
                    self._recover(target, o, devices_failed=False)
                else:
                    self._restore(target, o, save_first=True)
                return
            gen = self._clocked(
                lambda: self._send(
                    p.RetargetResize(
                        target=target, overlap=mode,
                        operating_point=op.to_dict(),
                    )
                )
            ).gen_id
        elif mode == "peer_recover":
            # no pre-deadline work needed: the survivors keep the state in
            # memory — recover onto the target now, no disk round-trip
            self._recover(target, o, devices_failed=False)
            return
        elif mode == "checkpoint":
            self._restore(target, o, save_first=True)
            return
        else:
            gen = self._clocked(
                lambda: self._send(
                    p.RequestResize(
                        target=target, overlap=mode,
                        operating_point=op.to_dict(),
                    )
                )
            ).gen_id
        if self.sync_prepare:
            self._send(p.WaitShadowReady())
        o.gen_id = gen
        self._skip_records()
        self._pending = _Pending(
            outcome=o, target=target, gen_id=gen,
            deadline=ev.deadline_s, mode=mode, est=est,
        )

    def _handle_failstop(self, ev: FailStopEvent, o: EventOutcome) -> None:
        if self._pending is not None:
            # supersede the in-flight reconfiguration on BOTH sides: the
            # controller must drop its shadow too, or the orphaned build
            # commits later to a target the event stream already abandoned
            self._pending.outcome.outcome = "retargeted"
            self._send(p.CancelResize(outcome="retargeted"))
            self._skip_records()
            self._pending = None
        target = ev.target
        if target is None:
            target = self._send(
                p.QuerySurvivorTarget(lost_ranks=tuple(ev.lost_ranks))
            ).target
            if target is None:
                o.outcome = "aborted"  # no feasible surviving topology
                return
        o.target = target.describe()
        # unannounced: no pre-deadline save — source the survivor world's
        # state from peer replicas (DESIGN.md §15); the durable checkpoint
        # is the last-resort rung the endpoint demotes to on its own
        self._recover(
            target, o, devices_failed=True, lost_ranks=tuple(ev.lost_ranks)
        )

    def _handle(self, ev) -> None:
        o = EventOutcome(
            index=len(self.outcomes),
            kind=getattr(ev, "kind", "resize"),
            time_s=ev.time_s,
            window_s=getattr(ev, "warning_s", 0.0),
            target=ev.target.describe() if ev.target is not None else "?",
        )
        self.outcomes.append(o)
        if isinstance(ev, FailStopEvent):
            self._handle_failstop(ev, o)
        else:
            self._handle_resize(ev, o)
        self._absorb()
        if self.on_event:
            self.on_event(o)

    # -- entry point ------------------------------------------------------
    def run(self, events: list) -> ScheduleReport:
        wall0 = time.perf_counter()
        for ev in sort_trace(events):
            self._advance_to(ev.time_s)
            self._handle(ev)
        while self._pending is not None:
            self._step()
        for _ in range(self.tail_steps):
            self._clocked(lambda: self._send(p.TrainSteps(n=1)))
            self.total_steps += 1
        self._absorb()
        ledger = self._send(p.QueryLedger())
        return ScheduleReport(
            outcomes=self.outcomes,
            steps=self.total_steps,
            duration_s=self.clock,
            wall_s=time.perf_counter() - wall0,
            goodput=ledger.goodput,
            pause_seconds=ledger.pause_seconds,
        )
