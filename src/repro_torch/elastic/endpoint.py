"""Control-plane endpoints: what a driver's protocol messages land on
(DESIGN.md §17).

An :class:`Endpoint` is the server side of ``elastic/protocol.py`` — it
owns a controller-like object plus the controller-facing helpers
(:class:`DeadlineEstimator`, :class:`PrefetchPolicy`, both moved here
from ``scheduler.py``: they read controller internals, so they belong
behind the protocol boundary, not in the driver). Adapters ship for
every controller species:

* :class:`ControllerEndpoint` — the live training controller
  (``LiveRController``, or any duck-typed fake with the same verbs);
* :class:`ServeEndpoint` — the elastic serving controller
  (``LiveServeController``), answering the status/record/resize subset;
* :class:`SimEndpoint` — no devices at all: answers the full protocol
  from the calibrated ``sim/cluster.py`` model on the ``sim/des.py``
  virtual clock, which is what lets the fleet arbiter drive 100 jobs in
  milliseconds;
* :class:`WireEndpoint` — a transparent wrapper that forces every
  command *and* response through ``encode → JSON text → decode``, so a
  test or bench running through it has proven the whole conversation is
  serializable (the local stand-in for a real RPC transport);
* :class:`RankEndpoint` — a per-rank world's endpoint
  (``core/rank_controller.py``): the driver (the ``ElasticScheduler``, its
  ``WireEndpoint``) runs on rank 0, each command's frame is broadcast to
  every rank of the pool before any rank acts on it, and every rank's
  ``ControllerEndpoint`` handles the same command sequence, so the verbs'
  collectives meet. Rank 0's response is the response; the other ranks'
  are dropped, and so is what their ``DeadlineEstimator`` reads of their
  own records and iteration times. ``PrefetchPolicy.tick`` runs on every
  rank, and the controller agrees what it starts.

The adapter contract: ``handle(cmd)`` always returns a protocol
response, mapping :class:`RecoveryError` to ``ErrorResponse("recovery")``
and unsupported verbs to ``ErrorResponse("unsupported")``; any other
exception is a bug and propagates.

A copy of the JAX package's ``elastic/endpoint.py``, over the port's
controllers: :class:`ControllerEndpoint` fronts the port's
``LiveRController`` and :class:`ServeEndpoint` its ``LiveServeController``.
Two properties of the port's controller show through, with the JAX code
kept as it is:

* the rank pool :class:`PrefetchPolicy` plans within is
  ``len(controller.devices)``, the controller's ``devices=`` (8 ranks of
  the one card by default, where the JAX controller takes every device it
  sees);
* the port's world build records no ``mesh_s``, ``lower_s`` or
  ``compile_s`` (eager PyTorch compiles nothing ahead: it records
  ``warm_s``), so :meth:`DeadlineEstimator.prepare_estimate` has no seed
  from the gen-0 world, and a cold estimate is ``default_prepare_s`` until
  a reconfiguration record exists, as over a controller without timings
  in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Optional

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.downtime import GoodputLedger
from repro_torch.core.errors import RecoveryError
from repro_torch.elastic import protocol as p
from repro_torch.elastic.protocol import (
    Ack,
    EscalateResult,
    EstimateResponse,
    ErrorResponse,
    LedgerResponse,
    PrefetchResult,
    ReconfigEstimate,
    RecordView,
    RecordsResponse,
    RecoverResult,
    ResizeStarted,
    StatusResponse,
    StepResult,
    TargetResponse,
)
from repro_torch.reshard.autotune import OperatingPoint


def _median(xs: list) -> Optional[float]:
    xs = sorted(x for x in xs if x > 0)
    return xs[len(xs) // 2] if xs else None


# ---------------------------------------------------------------------------
# Controller-side helpers (moved from scheduler.py — they read controller
# internals, which drivers may no longer do)
# ---------------------------------------------------------------------------


class DeadlineEstimator:
    """prepare+stream estimates from plan metadata and reconfig history.

    Bytes come from the same ``plan_state_transfer`` machinery that fills
    the shadow world's ``plan_bundle`` (a ready bundle for the right target
    is used as-is); seconds come from the recent ``ReconfigRecord``s —
    median prepare time and effective transfer bandwidth — falling back to
    the constructor defaults until history exists.
    """

    def __init__(
        self,
        controller,
        default_prepare_s: float = 20.0,
        default_warm_prepare_s: float = 1.0,
        default_bw_bytes_s: float = 1e9,
        default_step_s: float = 0.25,
        history: int = 8,
    ):
        self.ctrl = controller
        self.default_prepare_s = default_prepare_s
        self.default_warm_prepare_s = default_warm_prepare_s
        self.default_bw = default_bw_bytes_s
        self.default_step_s = default_step_s
        self.history = history

    # -- history --------------------------------------------------------
    def _recent(self, warm: Optional[bool] = None) -> list:
        # every record whose Prepare actually completed is a valid sample,
        # not just committed ones: after a retarget-heavy stretch the
        # committed subset can be empty and a committed-only filter made
        # the estimator silently fall back to its defaults. ``fell_back``
        # on a live mode means an escalated commit (prepare finished);
        # ``retargeted`` records count only when their prepare finished
        # before supersession (prepare_s > 0 — mid-prepare retargets
        # carry no timing).
        recs = [
            r
            for r in self.ctrl.records
            if r.mode in ("live", "live_overlap")
            and (r.outcome in ("committed", "fell_back") or r.prepare_s > 0)
        ]
        if warm is not None:
            if warm:
                recs = [r for r in recs if getattr(r, "warm_hit", False)]
            else:
                # a speculative join measures neither a warm Prepare (the
                # compile ran) nor a cold one (only the residual wait was
                # timed) — sampling it as cold would drag the cold median
                # toward zero and mis-rank the lattice for true cold events
                recs = [
                    r
                    for r in recs
                    if not getattr(r, "warm_hit", False)
                    and getattr(r, "prepare_source", "cold")
                    != "speculative_join"
                ]
        return recs[-self.history :]

    def prepare_estimate(self, warm: bool = False) -> float:
        """Median prepare time over recent records of the requested kind:
        warm (pool hit — lower+compile skipped) and cold prepares differ by
        orders of magnitude, so one blended median would make the lattice
        reject the overlap rung exactly when a warm world makes it cheap."""
        m = _median([r.prepare_s for r in self._recent(warm=warm)])
        if m is not None:
            return m
        if warm:
            # no warm history yet: a pool hit skips lower+compile, leaving
            # planning + bookkeeping — bounded above by the cold estimate
            return min(self.prepare_estimate(warm=False),
                       self.default_warm_prepare_s)
        # cold start: the gen-0 world's own build timings are the best proxy
        t = self.ctrl.world.timings
        seed = sum(t.get(k, 0.0) for k in ("mesh_s", "lower_s", "compile_s"))
        return seed or self.default_prepare_s

    def measured_bandwidth(self) -> Optional[float]:
        """Median transfer bandwidth over recent records, or ``None`` with
        no history yet (the operating-point tuner treats None as "fall back
        to the hand-set constants").

        With a wire policy on the controller, bandwidth is measured in
        PHYSICAL wire bytes per second so that pricing ``est.wire_bytes``
        and the lossless counterfactual against it stay on one scale;
        lossless controllers keep the historical moved-bytes measure."""
        compressed = getattr(self.ctrl, "wire_policy", None) is not None
        bws = []
        for r in self._recent():
            moved = r.moved_bytes
            if compressed:
                moved = getattr(r, "wire_bytes", 0) or r.moved_bytes
            secs = r.transfer_s + r.resync_s + r.precopy_s
            if moved > 0 and secs > 0:
                bws.append(moved / secs)
        return _median(bws)

    def bandwidth_estimate(self) -> float:
        return self.measured_bandwidth() or self.default_bw

    def step_estimate(self) -> float:
        return _median(list(self.ctrl.iteration_times)[-16:]) or self.default_step_s

    # -- the estimate ---------------------------------------------------
    def _price_plan(self, plan) -> tuple[int, int, int]:
        """(logical bytes, wire bytes, streaming layers) of a plan.

        Priced on the classified plan IR (DESIGN.md §13): bytes are REMOTE
        only — resident cells never move and local relayouts never cross a
        wire — and fully-resident layers need no pre-copy rounds. This is
        what lets a tp-preserving resize fit the overlap rung inside a
        warning window its full-copy byte count would have blown. Wire
        bytes price the same remote tasks under the controller's WirePolicy
        (DESIGN.md §14); equal to logical bytes when lossless."""
        from repro_torch.reshard.wire import wire_nbytes

        policy = getattr(self.ctrl, "wire_policy", None)
        logical = plan.network_bytes
        if policy is None:
            wire = logical
        else:
            wire = sum(
                wire_nbytes(policy, t)
                for t in plan.tasks
                if getattr(t, "kind", "remote") == "remote"
            )
        return logical, wire, len(plan.layers()) - len(plan.resident_layers())

    def _plan_for(self, target) -> tuple[int, int, int]:
        """(logical bytes, wire bytes, layers) for current-world -> target."""
        b = getattr(self.ctrl, "_builder", None)
        if b is not None and b.ready and not b.abandoned:
            handle = b.result()
            bundle = handle.plan_bundle
            if (
                handle.parallel == target
                and bundle is not None
                and bundle[0] == self.ctrl.world.parallel
            ):
                return self._price_plan(bundle[2])
        from repro_torch.core.reshard import plan_state_transfer

        _, plan = plan_state_transfer(
            self.ctrl.cfg, self.ctrl.world.parallel, target,
            source_policy=self.ctrl.source_policy,
        )
        return self._price_plan(plan)

    def _pool_warm(self, target) -> bool:
        """True when the controller's warm pool holds a ready world for
        ``target`` (Prepare will skip lower+compile)."""
        pool = getattr(self.ctrl, "world_pool", None)
        if pool is None or not hasattr(self.ctrl, "pool_key"):
            return False
        return pool.contains(self.ctrl.pool_key(target))

    def estimate(self, target) -> ReconfigEstimate:
        plan_bytes, wire_bytes, layers = self._plan_for(target)
        bw = self.bandwidth_estimate()
        step_s = self.step_estimate()
        rounds = math.ceil(layers / max(1, self.ctrl.stream_k))
        # the rungs are priced on what actually crosses the wire under the
        # controller's WirePolicy; the lossless figure is kept alongside so
        # the decision can be compared to its uncompressed counterfactual
        transfer_s = wire_bytes / bw
        warm = self._pool_warm(target)
        # peer_recover rung pricing (DESIGN.md §15): coverage from the
        # controller's survivor-constrained plan (fail-stop geometry — the
        # ranks beyond the target prefix die), donor bytes at measured
        # bandwidth, lossless (the recovery stream never compresses).
        # Duck-typed controllers without peer recovery price it
        # unavailable and keep the checkpoint rung.
        peer_ok, peer_bytes = False, 0
        cov = getattr(self.ctrl, "peer_coverage", None)
        if cov is not None:
            peer_ok, peer_bytes = cov(target)
        return ReconfigEstimate(
            prepare_s=self.prepare_estimate(warm=warm),
            warm=warm,
            # one pre-copy round per iteration boundary, each hiding its
            # bytes under a training step (dispatch rides the boundary)
            precopy_s=rounds * step_s,
            # dense-optimizer worst case: every layer is dirty at commit,
            # so the commit pause re-moves the plan (overlap.py's honest
            # limit) — minus nothing we can promise in advance
            stream_pause_s=transfer_s,
            stop_copy_pause_s=transfer_s,
            plan_bytes=plan_bytes,
            rounds=rounds,
            step_s=step_s,
            wire_bytes=wire_bytes,
            layers=layers,
            lossless_transfer_s=plan_bytes / bw,
            peer_ok=peer_ok,
            peer_bytes=peer_bytes,
            peer_pause_s=self.prepare_estimate(warm=warm) + peer_bytes / bw,
            measured_bw=self.measured_bandwidth() or 0.0,
        )


class PrefetchPolicy:
    """Fills the controller's warm world pool while the event loop is idle.

    Each ``tick`` (called by the scheduler on steps with no pending event)
    asks the topology search for the likely next targets — the failover
    standby (:func:`failover_target`, the prefix-survivor world a
    fail-stop would recover into, DESIGN.md §15) first, then the best
    feasible configurations at the walk-down/walk-up neighbor device
    counts of the current world (:func:`likely_next_targets`) — and starts
    speculative builds via ``controller.prefetch_world``. Targets already
    pooled get their transfer executables pre-compiled instead
    (``controller.prewarm_transfer``), so a recovery into a warm world
    pays neither the Prepare nor the first-pair reshard compiles. The
    controller enforces the guardrails: never while a real reconfiguration
    is in flight, at most ``max_spec_builds`` concurrent compiles, skip
    targets already pooled or building. Candidate enumeration is
    re-planned per tick because the current world (and hence its
    neighbors) changes with every commit; the search itself is
    metadata-only and cheap.
    """

    def __init__(
        self,
        controller,
        k: int = 2,
        factors: tuple[float, ...] = (0.5, 2.0),
        max_pp: int = 8,
    ):
        self.ctrl = controller
        self.k = k
        self.factors = factors
        # must cover the pp range of the event stream's own targets (e.g.
        # events_from_trace's max_pp) or a prefetched pp=1 world can never
        # match a pp>1 event's pool key — wasted builds that evict genuinely
        # useful entries. Pass the same bound you give the trace mapper.
        self.max_pp = max_pp
        self.started = 0
        # candidates only change when the active world does (a commit);
        # cache them so idle ticks don't re-run the topology search
        self._cands_for = None
        self._cands: list = []

    def candidates(self) -> list:
        from repro_torch.core.topology_search import (
            failover_target,
            likely_next_targets,
        )

        ctrl = self.ctrl
        cands = likely_next_targets(
            ctrl.cfg,
            ctrl.world.parallel,
            len(ctrl.devices),
            ctrl.global_batch,
            ctrl.seq_len,
            k=self.k,
            factors=self.factors,
            max_pp=self.max_pp,
        )
        # failover standbys (DESIGN.md §15): the prefix-survivor worlds an
        # unannounced fail-stop would recover into, chained one level (a
        # failure can take more than one replica group). Keeping them warm
        # ahead of the walk-down/walk-up guesses bounds the fail-stop
        # pause to the transfer itself, never a cold Prepare — except a
        # world_size-1 standby, which protects only against losing all but
        # one device: it queues BEHIND the walk candidates so it cannot
        # hog the single speculative-build slot right before a walk-up.
        front: list = []
        back: list = []
        cur = ctrl.world.parallel
        for _ in range(2):
            cur = failover_target(
                ctrl.cfg, cur, ctrl.global_batch, max_pp=self.max_pp
            )
            if cur is None or cur == ctrl.world.parallel:
                break
            (front if cur.world_size > 1 else back).append(cur)
        seen = set(front) | set(back)
        return front + [c for c in cands if c not in seen] + back

    def tick(self) -> int:
        """Start speculative builds for the current candidates; returns
        how many were started (0 when pooled/building/busy)."""
        if getattr(self.ctrl, "reconfig_pending", False):
            # builds would be refused mid-resize, but the INCOMING world's
            # failover pairs can (and should) warm now: a window-0 event
            # right after the commit pays any cold transfer compile inside
            # its pause, and the post-commit gap is shorter than a compile
            getattr(self.ctrl, "prewarm_failover_ahead", lambda: 0)()
            return 0
        current = self.ctrl.world.parallel
        # warm transfer pairs into already-pooled worlds FIRST: a window-0
        # recovery pays any cold transfer compile inside its pause, while
        # a standby world build overlaps training — the prewarm is
        # pause-critical, the build is not. (pool_key index 1 is the
        # ParallelConfig; keys built for another device fingerprint
        # peek-miss inside prewarm_transfer)
        pool = getattr(self.ctrl, "world_pool", None)
        if pool is not None:
            # only non-growing pairs: the zero-warning consumers of these
            # executables are fail-stops, shrinks and same-size
            # retopologies — grows come with warning windows and stream,
            # so warming them here would spend the compile budget the
            # standby build needs. Nearest-size first: a same-size
            # retopology has zero capacity slack and is the likeliest
            # window-0 target, deeper-shrink pairs only matter after
            # deeper failures (prewarms run one at a time, so order is
            # priority)
            keys = sorted(
                (
                    k
                    for k in pool.keys()
                    if k[1] != current
                    and k[1].world_size <= current.world_size
                ),
                key=lambda k: current.world_size - k[1].world_size,
            )
            for key in keys:
                self.ctrl.prewarm_transfer(key[1])
        # while a prewarm is compiling, hold off on starting new cold
        # builds — two concurrent XLA compiles contend for the same host
        # cores and both slow down, and only the prewarm is on the
        # recovery-pause path
        thread = getattr(self.ctrl, "_prewarm_thread", None)
        # a per-rank controller agrees the hold-off (``_all``): the builds
        # it would start are agreed over its pool
        if getattr(self.ctrl, "_all", bool)(thread is not None and thread.is_alive()):
            return 0
        if current != self._cands_for:
            self._cands_for = current
            self._cands = self.candidates()
        started = 0
        for target in self._cands:
            if self.ctrl.prefetch_world(target):
                started += 1
            else:
                # already pooled (or building): warm the TRANSFER
                # executables for (current → target) too, so a recovery
                # into this world pays neither compile (DESIGN.md §15)
                self.ctrl.prewarm_transfer(target)
        self.started += started
        return started


# ---------------------------------------------------------------------------
# The endpoint contract
# ---------------------------------------------------------------------------


class Endpoint:
    """Dispatches protocol commands to ``_on_<type-tag>`` methods.

    Subclasses implement the verbs they support; the rest answer
    ``ErrorResponse("unsupported")`` so a driver can probe capabilities
    without try/except. :class:`RecoveryError` maps to
    ``ErrorResponse("recovery")`` — the one failure the scheduler
    handles as a normal outcome (``aborted``) rather than a crash.
    """

    kind = "generic"

    def handle(self, cmd: Any) -> Any:
        tag = p._TYPE_OF.get(type(cmd))
        if tag is None:
            return ErrorResponse(
                kind="invalid", message=f"not a command: {type(cmd).__name__}"
            )
        fn = getattr(self, "_on_" + tag, None)
        if fn is None:
            return ErrorResponse(kind="unsupported", message=tag)
        try:
            return fn(cmd)
        except RecoveryError as e:
            return ErrorResponse(kind="recovery", message=str(e))


class ControllerEndpoint(Endpoint):
    """``LiveRController`` (or any duck-typed training controller) behind
    the protocol. Owns the server-side estimator and prefetch policy so
    `query_estimate` / `prefetch_tick` stay one round-trip."""

    kind = "train"

    def __init__(
        self,
        controller,
        estimator: Optional[DeadlineEstimator] = None,
        prefetch: Optional[PrefetchPolicy] = None,
        prefetch_k: int = 0,
    ):
        self.ctrl = controller
        self.estimator = estimator or DeadlineEstimator(controller)
        self.prefetch = prefetch
        if (
            self.prefetch is None
            and prefetch_k > 0
            and getattr(controller, "world_pool", None) is not None
        ):
            self.prefetch = PrefetchPolicy(controller, k=prefetch_k)

    # -- verbs ----------------------------------------------------------
    def _on_train_steps(self, cmd: p.TrainSteps) -> StepResult:
        self.ctrl.train_steps(cmd.n)
        return StepResult(steps=cmd.n, clock_s=-1.0)

    @staticmethod
    def _op(cmd) -> Optional[OperatingPoint]:
        return (
            None
            if cmd.operating_point is None
            else OperatingPoint(**cmd.operating_point)
        )

    def _on_request_resize(self, cmd: p.RequestResize) -> ResizeStarted:
        gen = self.ctrl.request_resize(
            cmd.target, overlap=cmd.overlap, operating_point=self._op(cmd)
        )
        return ResizeStarted(gen_id=int(gen if gen is not None else -1))

    def _on_retarget_resize(self, cmd: p.RetargetResize) -> ResizeStarted:
        gen = self.ctrl.retarget_resize(
            cmd.target, overlap=cmd.overlap, operating_point=self._op(cmd)
        )
        return ResizeStarted(gen_id=int(gen if gen is not None else -1))

    def _on_escalate_commit(self, cmd: p.EscalateCommit) -> EscalateResult:
        rec = self.ctrl.escalate_commit()
        return EscalateResult(
            escalated=rec is not None,
            record=None if rec is None else RecordView.from_record(rec),
        )

    def _on_cancel_resize(self, cmd: p.CancelResize) -> Ack:
        self.ctrl.cancel_resize(outcome=cmd.outcome)
        return Ack(ok=True)

    def _on_fail_stop_recover(self, cmd: p.FailStopRecover) -> RecoverResult:
        rec = self.ctrl.fail_stop_recover(
            cmd.target,
            devices_failed=cmd.devices_failed,
            lost_ranks=tuple(cmd.lost_ranks),
        )
        return RecoverResult(record=RecordView.from_record(rec))

    def _on_checkpoint_now(self, cmd: p.CheckpointNow) -> Ack:
        self.ctrl.checkpoint_now()
        return Ack(ok=True)

    def _on_prefetch_world(self, cmd: p.PrefetchWorld) -> PrefetchResult:
        return PrefetchResult(
            started=int(bool(self.ctrl.prefetch_world(cmd.target)))
        )

    def _on_prefetch_tick(self, cmd: p.PrefetchTick) -> PrefetchResult:
        if self.prefetch is None:
            return PrefetchResult(started=0)
        return PrefetchResult(started=self.prefetch.tick())

    def _on_wait_shadow_ready(self, cmd: p.WaitShadowReady) -> Ack:
        self.ctrl.wait_shadow_ready(
            **({} if cmd.timeout is None else {"timeout": cmd.timeout})
        )
        return Ack(ok=True)

    # -- queries --------------------------------------------------------
    def _on_query_status(self, cmd: p.QueryStatus) -> StatusResponse:
        ctrl = self.ctrl
        par = ctrl.world.parallel
        return StatusResponse(
            parallel=par,
            world_size=par.world_size,
            step=int(getattr(ctrl, "step", 0)),
            reconfig_pending=bool(getattr(ctrl, "reconfig_pending", False)),
            durable=bool(getattr(ctrl, "ckpt_dir", None)),
            records=len(ctrl.records),
            kind=self.kind,
        )

    def _on_query_records(self, cmd: p.QueryRecords) -> RecordsResponse:
        recs = self.ctrl.records
        return RecordsResponse(
            records=tuple(
                RecordView.from_record(r) for r in recs[cmd.since :]
            ),
            total=len(recs),
        )

    def _on_query_estimate(self, cmd: p.QueryEstimate) -> EstimateResponse:
        return EstimateResponse(estimate=self.estimator.estimate(cmd.target))

    def _on_query_ledger(self, cmd: p.QueryLedger) -> LedgerResponse:
        ctrl = self.ctrl
        ledger = ctrl.ledger
        steps = int(getattr(ctrl, "step", 0))
        return LedgerResponse(
            goodput=ledger.goodput,
            pause_seconds=ledger.pause_seconds,
            train_gpu_seconds=ledger.gpu_seconds("train"),
            steps=steps,
            samples=float(steps * getattr(ctrl, "global_batch", 0)),
        )

    def _on_query_survivor_target(
        self, cmd: p.QuerySurvivorTarget
    ) -> TargetResponse:
        """Largest feasible topology over the surviving devices: the naive
        ``world - lost`` count is usually infeasible (divisibility), so
        walk down until the search finds one (same geometry the scheduler
        used to compute in-process)."""
        ctrl = self.ctrl
        cfg = getattr(ctrl, "cfg", None)
        if cfg is None:
            return TargetResponse(target=None)
        from repro_torch.core.topology_search import best_target

        survivors = max(
            1,
            ctrl.world.parallel.world_size - max(1, len(cmd.lost_ranks)),
        )
        for world in range(survivors, 0, -1):
            try:
                return TargetResponse(
                    target=best_target(
                        cfg, world, ctrl.global_batch, ctrl.seq_len, max_pp=1
                    )
                )
            except ValueError:
                continue
        return TargetResponse(target=None)


class ServeEndpoint(Endpoint):
    """``LiveServeController`` behind the same protocol: the fleet
    arbiter addresses training and serving jobs uniformly. Serving has no
    train loop or fallback lattice — the decode loop owns commit timing —
    so this adapter answers the resize/status/record subset and reports
    the rest unsupported."""

    kind = "serve"

    def __init__(self, controller):
        self.ctrl = controller

    def _on_request_resize(self, cmd: p.RequestResize) -> ResizeStarted:
        self.ctrl.request_resize(cmd.target)
        return ResizeStarted(gen_id=int(self.ctrl.gen_id + 1))

    # a newer target simply supersedes the pending one (the serve
    # controller discards internally on the next request)
    def _on_retarget_resize(self, cmd: p.RetargetResize) -> ResizeStarted:
        self.ctrl.request_resize(cmd.target)
        return ResizeStarted(gen_id=int(self.ctrl.gen_id + 1))

    def _on_cancel_resize(self, cmd: p.CancelResize) -> Ack:
        self.ctrl._discard_pending()
        return Ack(ok=True)

    def _on_query_status(self, cmd: p.QueryStatus) -> StatusResponse:
        par = self.ctrl.active.parallel
        return StatusResponse(
            parallel=par,
            world_size=par.world_size,
            step=int(self.ctrl.gen_id),
            reconfig_pending=bool(self.ctrl.resize_pending),
            durable=False,
            records=len(self.ctrl.records),
            kind=self.kind,
        )

    def _on_query_records(self, cmd: p.QueryRecords) -> RecordsResponse:
        recs = self.ctrl.records
        return RecordsResponse(
            records=tuple(
                RecordView.from_record(r) for r in recs[cmd.since :]
            ),
            total=len(recs),
        )


class SimEndpoint(Endpoint):
    """A whole job as a calibrated closed-form model on the DES clock.

    Answers the full training protocol with zero devices: training
    progress accrues lazily — any command first syncs the ledger from the
    last-touched virtual time to ``sim.now`` (train vs pause intervals,
    samples at the calibrated step time) — so a 100-job fleet costs one
    O(1) update per command, not per step. Reconfigurations follow the
    cluster model: ``prepare_s`` of shadow build ahead of an atomic
    commit whose pause is priced like ``sim/liver_sim.py`` (drain +
    remote transfer + switch for stop-copy; dirty-window re-sync + switch
    for the overlapped rung).

    With no ``sim`` argument the endpoint owns a private
    :class:`~repro_torch.sim.des.Simulator` and ``train_steps`` advances it —
    an ``ElasticScheduler`` can drive a SimEndpoint directly, its trace
    clock following the returned ``StepResult.clock_s``. With a shared
    ``sim`` (the fleet arbiter's), time is advanced by the owner and
    ``train_steps`` only syncs.
    """

    kind = "sim"

    def __init__(
        self,
        name: str = "sim-job",
        params: float = 1.4e9,
        global_batch: int = 256,
        parallel: Optional[ParallelConfig] = None,
        cluster=None,
        sim=None,
        move_fraction: float = 0.5,
        layers: int = 24,
        stream_k: int = 4,
    ):
        from repro_torch.sim.cluster import PAPER_TESTBED
        from repro_torch.sim.des import Simulator

        self.name = name
        self.params = float(params)
        self.global_batch = int(global_batch)
        self.parallel = parallel or ParallelConfig(dp=8)
        self.cluster = cluster or PAPER_TESTBED
        self._owns_clock = sim is None
        self.sim = sim or Simulator()
        self.move_fraction = move_fraction
        self.layers = layers
        self.stream_k = stream_k
        self.ledger = GoodputLedger()
        self.records: list[RecordView] = []
        self._gen = 0
        self._t = self.sim.now  # ledger accrued up to here
        self._pause_until = self.sim.now
        self._pause_world = self.parallel.world_size
        self._pending: Optional[dict] = None
        self.step_count = 0.0
        self.samples = 0.0

    # -- calibrated model ------------------------------------------------
    def _step_time(self, world: int) -> float:
        from repro_torch.roofline.analysis import analytic_step_time

        return analytic_step_time(self.params, world, self.cluster)

    def _moved_bytes(self) -> float:
        from repro_torch.sim.cluster import model_state_bytes

        return model_state_bytes(self.params) * self.move_fraction

    def _pause_for(self, mode: str, world: int) -> float:
        c = self.cluster
        moved = self._moved_bytes()
        if mode == "stream":
            # overlapped rung: pre-copy rounds ride iteration boundaries;
            # the commit pause re-syncs the dirty window (~10% of the
            # plan) and swaps metadata
            return c.transfer_s(0.1 * moved, world) + c.switch_s
        # stop-copy (and the peer-recovery stream): the whole transfer
        # lands inside one pause after the drain
        return c.drain_s + c.transfer_s(moved, world) + c.switch_s

    # -- lazy time accrual ----------------------------------------------
    def _accrue(self, upto: float) -> None:
        t = self._t
        if upto <= t:
            return
        if self._pause_until > t:
            pe = min(self._pause_until, upto)
            self.ledger.record(t, pe, "pause", self._pause_world)
            t = pe
        if upto > t:
            w = self.parallel.world_size
            self.ledger.record(t, upto, "train", w)
            st = self._step_time(w)
            self.step_count += (upto - t) / st
            self.samples += (upto - t) / st * self.global_batch
        self._t = upto

    def _sync(self) -> None:
        now = self.sim.now
        pend = self._pending
        if pend is not None and pend["ready_at"] <= now:
            self._accrue(pend["ready_at"])
            self._commit(pend, outcome="committed")
        self._accrue(now)

    def _commit(self, pend: dict, outcome: str, pause: Optional[float] = None,
                mode: Optional[str] = None) -> RecordView:
        self._pending = None
        src, dst = self.parallel, pend["target"]
        world = max(src.world_size, dst.world_size)
        m = mode or pend["mode"]
        if pause is None:
            pause = self._pause_for(m, world)
        now = self._t
        self._pause_until = max(self._pause_until, now) + pause
        self._pause_world = dst.world_size
        self.parallel = dst
        rec = RecordView(
            gen_id=pend["gen"],
            src=src.describe(),
            dst=dst.describe(),
            mode="live_overlap" if m == "stream" else "live",
            outcome=outcome,
            prepare_s=pend["prepare_s"],
            total_pause_s=pause,
        )
        self.records.append(rec)
        return rec

    def _retire_pending(self, outcome: str) -> None:
        if self._pending is None:
            return
        pend, self._pending = self._pending, None
        self.records.append(
            RecordView(
                gen_id=pend["gen"],
                src=self.parallel.describe(),
                dst=pend["target"].describe(),
                mode="live_overlap" if pend["mode"] == "stream" else "live",
                outcome=outcome,
                prepare_s=0.0,
                total_pause_s=0.0,
            )
        )

    def _begin(self, target: ParallelConfig, overlap: Optional[str]) -> int:
        self._sync()
        self._gen += 1
        world = max(self.parallel.world_size, target.world_size)
        prepare = self.cluster.prepare_s(world)
        self._pending = {
            "gen": self._gen,
            "target": target,
            "mode": overlap or "stream",
            "t0": self.sim.now,
            "prepare_s": prepare,
            "ready_at": self.sim.now + prepare,
        }
        return self._gen

    # -- verbs ----------------------------------------------------------
    def _on_train_steps(self, cmd: p.TrainSteps) -> StepResult:
        if self._owns_clock:
            st = self._step_time(self.parallel.world_size)
            self.sim.run(until=self.sim.now + cmd.n * st)
        self._sync()
        return StepResult(steps=cmd.n, clock_s=self.sim.now)

    def _on_request_resize(self, cmd: p.RequestResize) -> ResizeStarted:
        self._retire_pending("retargeted")
        return ResizeStarted(gen_id=self._begin(cmd.target, cmd.overlap))

    def _on_retarget_resize(self, cmd: p.RetargetResize) -> ResizeStarted:
        self._retire_pending("retargeted")
        return ResizeStarted(gen_id=self._begin(cmd.target, cmd.overlap))

    def _on_escalate_commit(self, cmd: p.EscalateCommit) -> EscalateResult:
        self._sync()
        if self._pending is None:
            return EscalateResult(escalated=False)
        # an early escalation pays the un-overlapped remainder of the
        # prepare inside the pause, then the full stop-copy transfer
        pend = self._pending
        remaining = max(0.0, pend["ready_at"] - self.sim.now)
        world = max(self.parallel.world_size, pend["target"].world_size)
        pause = remaining + self._pause_for("stop_copy", world)
        rec = self._commit(pend, outcome="fell_back", pause=pause,
                           mode="stop_copy")
        return EscalateResult(escalated=True, record=rec)

    def _on_cancel_resize(self, cmd: p.CancelResize) -> Ack:
        self._sync()
        self._retire_pending(cmd.outcome or "canceled")
        return Ack(ok=True)

    def _on_fail_stop_recover(self, cmd: p.FailStopRecover) -> RecoverResult:
        self._sync()
        self._retire_pending("retargeted")
        self._gen += 1
        src, dst = self.parallel, cmd.target
        # peers stream the survivor shards: transfer at the DST world's
        # aggregate bandwidth (the survivors), plus drain + switch
        pause = self._pause_for("stop_copy", dst.world_size)
        now = self._t
        self._pause_until = max(self._pause_until, now) + pause
        self._pause_world = dst.world_size
        self.parallel = dst
        rec = RecordView(
            gen_id=self._gen,
            src=src.describe(),
            dst=dst.describe(),
            mode="peer_recover",
            outcome="committed",
            total_pause_s=pause,
        )
        self.records.append(rec)
        return RecoverResult(record=rec)

    def _on_checkpoint_now(self, cmd: p.CheckpointNow) -> Ack:
        from repro_torch.sim.cluster import model_state_bytes

        self._sync()
        w = self.parallel.world_size
        bw = self.cluster.storage_bw_gbps_per_gpu * 1e9 / 8 * w
        pause = model_state_bytes(self.params, with_optimizer=True) / bw
        self._pause_until = max(self._pause_until, self._t) + pause
        self._pause_world = w
        return Ack(ok=True, detail="checkpointed")

    def _on_prefetch_world(self, cmd: p.PrefetchWorld) -> PrefetchResult:
        return PrefetchResult(started=0)  # warm pool not modeled

    def _on_prefetch_tick(self, cmd: p.PrefetchTick) -> PrefetchResult:
        return PrefetchResult(started=0)

    def _on_wait_shadow_ready(self, cmd: p.WaitShadowReady) -> Ack:
        if self._owns_clock and self._pending is not None:
            self.sim.run(until=max(self.sim.now, self._pending["ready_at"]))
            self._sync()
        return Ack(ok=True)

    # -- queries --------------------------------------------------------
    def _on_query_status(self, cmd: p.QueryStatus) -> StatusResponse:
        self._sync()
        return StatusResponse(
            parallel=self.parallel,
            world_size=self.parallel.world_size,
            step=int(self.step_count),
            reconfig_pending=self._pending is not None,
            durable=True,
            records=len(self.records),
            kind=self.kind,
        )

    def _on_query_records(self, cmd: p.QueryRecords) -> RecordsResponse:
        self._sync()
        return RecordsResponse(
            records=tuple(self.records[cmd.since :]),
            total=len(self.records),
        )

    def _on_query_estimate(self, cmd: p.QueryEstimate) -> EstimateResponse:
        self._sync()
        c = self.cluster
        world = max(self.parallel.world_size, cmd.target.world_size)
        moved = self._moved_bytes()
        step_s = self._step_time(self.parallel.world_size)
        rounds = math.ceil(self.layers / max(1, self.stream_k))
        transfer = c.transfer_s(moved, world)
        return EstimateResponse(
            estimate=ReconfigEstimate(
                prepare_s=c.prepare_s(world),
                precopy_s=rounds * step_s,
                stream_pause_s=self._pause_for("stream", world),
                stop_copy_pause_s=self._pause_for("stop_copy", world),
                plan_bytes=int(moved),
                rounds=rounds,
                step_s=step_s,
                wire_bytes=int(moved),
                layers=self.layers,
                lossless_transfer_s=transfer,
                peer_ok=True,
                peer_bytes=int(moved),
                peer_pause_s=self._pause_for("stop_copy",
                                             cmd.target.world_size),
                measured_bw=c.interconnect_gbps_per_gpu * 1e9 / 8 * world,
            )
        )

    def _on_query_ledger(self, cmd: p.QueryLedger) -> LedgerResponse:
        self._sync()
        return LedgerResponse(
            goodput=self.ledger.goodput,
            pause_seconds=self.ledger.pause_seconds,
            train_gpu_seconds=self.ledger.gpu_seconds("train"),
            steps=int(self.step_count),
            samples=self.samples,
        )

    def _on_query_survivor_target(
        self, cmd: p.QuerySurvivorTarget
    ) -> TargetResponse:
        survivors = max(
            1, self.parallel.world_size - max(1, len(cmd.lost_ranks))
        )
        return TargetResponse(target=ParallelConfig(dp=survivors))


class WireEndpoint(Endpoint):
    """Round-trips every command AND response through the JSON wire
    format before/after the inner endpoint sees them. Functionally a
    no-op — which is the point: a driver that works through a
    WireEndpoint has proven its whole conversation serializes, making
    this the local stand-in for a real RPC transport. Tests and the
    fleet bench run through it by default."""

    def __init__(self, inner: Endpoint):
        self.inner = inner
        self.kind = inner.kind
        self.commands = 0
        self.bytes_tx = 0
        self.bytes_rx = 0

    @property
    def prefetch(self):
        # surfaced for drivers/benches that report prefetch stats; the
        # policy itself still lives (and runs) endpoint-side
        return getattr(self.inner, "prefetch", None)

    def handle(self, cmd: Any) -> Any:
        wire = p.dumps(cmd)
        self.commands += 1
        self.bytes_tx += len(wire)
        resp = self.inner.handle(p.loads(wire))
        wire_back = p.dumps(resp)
        self.bytes_rx += len(wire_back)
        return p.loads(wire_back)


class RankEndpoint(Endpoint):
    """One rank's side of a per-rank world's control plane (the module
    docstring): on rank 0 :meth:`handle` broadcasts the command's frame
    (``protocol.dumps``) over ``pool`` and handles it; on the others
    :meth:`serve` receives and handles frames until rank 0's :meth:`close`.
    ``frames`` counts the frames handled and ``digest`` hashes them in
    order, the same on every rank that handled the same sequence."""

    def __init__(self, inner: Endpoint, pool):
        import hashlib

        self.inner = inner
        self.kind = inner.kind
        self.pool = pool
        self.frames = 0
        self._hash = hashlib.sha256()

    @property
    def prefetch(self):
        return getattr(self.inner, "prefetch", None)

    @property
    def digest(self) -> str:
        return self._hash.hexdigest()

    def _run(self, frame: bytes) -> Any:
        self.frames += 1
        self._hash.update(len(frame).to_bytes(8, "little") + frame)
        return self.inner.handle(p.loads(frame.decode()))

    def handle(self, cmd: Any) -> Any:
        if self.pool.rank != 0:
            raise RuntimeError("only rank 0 drives a per-rank world; the other ranks serve()")
        frame = p.dumps(cmd).encode()
        self.pool.broadcast_bytes(frame)
        return self._run(frame)

    def serve(self) -> int:
        """Handle rank 0's frames until it closes; returns how many."""
        while True:
            frame = self.pool.broadcast_bytes(None)
            if not frame:
                return self.frames
            self._run(frame)

    def close(self) -> None:
        """Rank 0: end every other rank's :meth:`serve`."""
        if self.pool.rank == 0:
            self.pool.broadcast_bytes(b"")


def as_endpoint(obj: Any, **kw) -> Endpoint:
    """Coerce a controller-like object to an endpoint: endpoints pass
    through (kw must be empty then), everything else wraps in a
    :class:`ControllerEndpoint`."""
    if isinstance(obj, Endpoint):
        if kw and any(v for v in kw.values()):
            raise ValueError(
                "estimator/prefetch config belongs to the endpoint; "
                "configure the endpoint you pass in"
            )
        return obj
    return ControllerEndpoint(obj, **kw)
