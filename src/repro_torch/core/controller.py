"""LiveR training controller (paper §4.3 end-to-end workflow, §4.7 switch).

The port of ``repro/core/controller.py``'s live-resize lifecycle on torch
state:

  trigger -> Prepare (shadow thread: world, plan, destination buffers)  [overlapped, I1]
          -> Ready   (await iteration boundary)                         [deterministic, I3]
          -> Switch  (drain -> live reshard -> pointer swap)            [the only pause]
          -> Cleanup (drop the old world)
          -> Stable

with both transfer modes: stop-copy (the whole plan inside the pause) and
overlapped streaming (pre-copy rounds between steps, then a split-step
commit whose gradients are computed on the old world while the dirty
layers re-sync, and whose optimizer update lands on the new world).
``wire_policy`` (None = lossless; ``WirePolicy()`` sends the Adam moments
as int8) shapes every reshard of the state and of the split step's
gradients, as in the JAX controller.

Around the commit, the event-stream verbs the deadline scheduler drives
(DESIGN.md §10, §12): the warm world pool (``world_pool=``: retired,
abandoned and speculatively built worlds, taken by the next Prepare for
their configuration; ``prefetch_world`` builds one ahead), the per-event
transfer mode and operating point (``request_resize(overlap=,
operating_point=)``), ``retarget_resize`` (supersede the in-flight
reconfiguration, adopting what its session already streamed) and
``escalate_commit`` (deadline pressure: commit now by stop-copy).

Device memory at full width is the constraint these verbs keep: the
destination tensors of a resize are as large as the training state (24.4
GB for qwen3-1.7b), so none of them makes a second set. A pooled world
keeps its functions and no tensor; a retarget hands the superseded
session's carries and unused buffers to the new Prepare, which allocates
only what is missing; an escalation gives them back to the stop-copy as
its destination. A carry that aliases a live tensor is never handed on.
A build superseded before it ended (a retarget or cancel during Prepare)
allocates nothing once it sees that, and the next Prepare allocates only
after it has ended and dropped whatever it held.

The JAX API, with ``device=`` in place of its device list: every rank of
every world maps to that one device (the card by default; a CUDA request
without one raises), and ``params=`` (a param tree to train in place of
the seeded init, e.g. the JAX package's weights through
``models.convert.params_from_jax``). The step count, the one piece of
state outside the resource view, stays where it is on one device.

Not ported, each raising ``NotImplementedError`` with its ROADMAP item
(queue 1 item 9): fail-stop recovery, the checkpoint rung, the parity
spare, and the two transfer prewarms (``prewarm_transfer``,
``prewarm_failover_ahead``), which compile a throwaway transfer mirroring
``fail_stop_recover``'s survivor-constrained plan.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.downtime import GoodputLedger
from repro_torch.core.generations import GenerationMachine, GenState
from repro_torch.core.intersection import TransferPlan
from repro_torch.core.records import ReuseRecordMixin
from repro_torch.core.reshard import (
    DEFAULT_STAGING_BYTES,
    live_reshard_planned,
    named_state_leaves,
    plan_state_transfer,
    rebuild_state,
)
from repro_torch.core.shadow import ShadowBuilder, WorldHandle, build_train_world, state_buffers
from repro_torch.core.world_pool import WorldPool
from repro_torch.data import SyntheticLM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.reshard import OperatingPoint, OverlapSession
from repro_torch.reshard.overlap import shares_storage
from repro_torch.utils.pytree import tree_from_paths, tree_map_with_path, tree_paths

__all__ = ["LiveRController", "ReconfigRecord"]

# speculative world builds in flight at once (``prefetch_world``)
MAX_SPEC_BUILDS = 1

_RECOVERY = "fail-stop recovery, the checkpoint rung and the parity spare are not ported yet (ROADMAP queue 1 item 9)"
_PREWARM = (
    "the transfer prewarms mirror fail_stop_recover's survivor-constrained plan, which is not ported "
    "yet (ROADMAP queue 1 item 9)"
)


@dataclass
class ReconfigRecord(ReuseRecordMixin):
    """One reconfiguration (the JAX record's fields; those of the unported
    recovery path keep their defaults).

    ``outcome``: committed | retargeted (superseded before its commit; its
    streamed state may have been adopted by the successor) | fell_back
    (committed by stop-copy under deadline pressure) | aborted.
    ``prepare_source``: cold (a full build) | pool (a warm world;
    ``warm_hit``) | speculative_join (joined an in-flight prefetch)."""

    gen_id: int
    src: str
    dst: str
    prepare_s: float = 0.0
    drain_s: float = 0.0
    transfer_s: float = 0.0
    switch_s: float = 0.0
    total_pause_s: float = 0.0
    moved_bytes: int = 0
    # live (stop-copy) | live_overlap (stream)
    mode: str = "live"
    outcome: str = "committed"
    warm_hit: bool = False
    prepare_source: str = "cold"
    plan_network_bytes: int = 0
    plan_local_bytes: int = 0
    executed_bytes: int = 0
    plan_s: float = 0.0  # planning time inside the pause (0.0 when planned during Prepare)
    # overlapped-streaming phases (zero under stop-copy)
    precopy_s: float = 0.0
    precopy_bytes: int = 0
    resync_s: float = 0.0
    resync_bytes: int = 0
    update_s: float = 0.0
    dirty_layers: int = 0
    layers_total: int = 0
    stream_dispatch_s: float = 0.0
    stream_drain_s: float = 0.0
    generic_cells: int = 0
    operating_point: Optional[dict] = None
    donors: int = 0
    lost_devices: int = 0
    parity_bytes: int = 0


def _resolve(device) -> torch.device:
    from repro_torch.models.model import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class LiveRController:
    def __init__(
        self,
        cfg: ModelConfig,
        parallel: ParallelConfig,
        opt_cfg: AdamWConfig,
        seq_len: int,
        global_batch: int,
        data: Optional[SyntheticLM] = None,
        ckpt_dir: Optional[str] = None,
        staging_bytes: int = DEFAULT_STAGING_BYTES,
        device="cuda",
        microbatches: int = 1,
        compression: str = "none",
        seed: int = 0,
        overlap: str = "stop_copy",  # "stop_copy" | "stream"
        stream_k: int = 4,
        source_policy: str = "nearest",
        world_pool: Optional[WorldPool] = None,
        wire_policy=None,
        parity_every: int = 0,
        params: Optional[dict] = None,
    ):
        if ckpt_dir is not None or parity_every:
            raise NotImplementedError(_RECOVERY)
        if overlap not in ("stop_copy", "stream"):
            raise ValueError(f"overlap={overlap!r}: want 'stop_copy' or 'stream'")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.staging_bytes = staging_bytes
        self.device = _resolve(device)
        self.microbatches = microbatches
        self.compression = compression
        self.overlap = overlap
        # per-reconfiguration override (request_resize(..., overlap=...));
        # resets to the constructor default when the reconfig retires
        self._overlap_mode = overlap
        self.stream_k = stream_k
        self.source_policy = source_policy
        # compressed wire format (DESIGN.md §14): None = fully lossless
        self.wire_policy = wire_policy
        # per-reconfiguration tuned operating point (reshard.autotune),
        # installed by request_resize/retarget_resize; None = the constants
        self._operating_point: Optional[OperatingPoint] = None
        # streamed state captured from a superseded session at retarget
        # (carries by name, streamed_at), consumed by the next session
        self._reuse: Optional[tuple] = None
        # speculative warm world pool (DESIGN.md §12)
        self.world_pool = world_pool
        self._spec_builders: dict[tuple, ShadowBuilder] = {}
        self._builder: Optional[ShadowBuilder] = None
        # builders abandoned before they ended (retarget, cancel): each may
        # still allocate, or still hold, a set of destination tensors
        self._orphans: list[ShadowBuilder] = []
        self._session: Optional[OverlapSession] = None
        self._session_specs = None
        self._session_plan = None
        self._pending_rec: Optional[ReconfigRecord] = None
        self._commit_armed = False
        self._plan_seconds = 0.0
        self.machine = GenerationMachine()
        self.ledger = GoodputLedger()
        self.records: list[ReconfigRecord] = []
        self.iteration_times: list[float] = []
        self.step = 0
        self.data = data or SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed)

        # Active World (generation 0)
        world = self._build_world(parallel)
        world.gen_id = 0
        self.machine.active.payload = world
        if params is None:
            from repro_torch.distribution.step import init_train_state

            self.params, self.opt_state = init_train_state(cfg, seed, compression, self.device)
        else:
            self.params = tree_map_with_path(lambda _, x: x.to(self.device, copy=True), params)
            self.opt_state = adamw_init(self.params)

    # ------------------------------------------------------------------
    @property
    def world(self) -> WorldHandle:
        return self.machine.active.payload

    def _device_subset(self, parallel: ParallelConfig) -> list:
        """The world's rank -> device list: every rank on the one device."""
        return [self.device] * parallel.world_size

    def _build_world(self, target: ParallelConfig) -> WorldHandle:
        return build_train_world(
            self.cfg, target, self.opt_cfg, self.global_batch, self.seq_len,
            microbatches=self.microbatches, devices=self._device_subset(target),
            compression=self.compression,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # Warm world pool (DESIGN.md §12)
    # ------------------------------------------------------------------
    def pool_key(self, target: ParallelConfig) -> tuple:
        """Pool identity of the world this controller would build for
        ``target``: everything that shapes its functions, plus the device
        (its type and index) its ranks map to."""
        fingerprint = (self.device.type, self.device.index)
        return (self.cfg, target, fingerprint, self.global_batch, self.seq_len, self.microbatches, self.compression)

    def _deposit(self, handle: WorldHandle) -> None:
        """Put a world into the pool with its functions only: its plan is
        source-dependent, and its destination tensors, as large as the
        training state, must not stay pinned by an idle world."""
        handle.gen_id = -1
        handle.plan_bundle = None
        handle.buffers = {}
        self.world_pool.put(self.pool_key(handle.parallel), handle)

    def _refresh_pooled(self, handle: WorldHandle, source: str = "pool") -> WorldHandle:
        """Revalidate a warm world for use as the pending shadow, and tag
        its timings so the record tells warm from cold."""
        assert not handle.released, "warm world was released while pooled"
        handle.timings = {"warm_hit": source == "pool", "prepare_source": source}
        handle.plan_bundle = None  # src-dependent: always replanned
        return handle

    def _discard_world(self, handle: WorldHandle) -> None:
        """An abandoned builder's completed world: kept warm, without its
        buffers, when a pool exists; released otherwise. Runs on the
        orphaned build thread when the abandon preceded completion; the
        pool is thread-safe."""
        if self.world_pool is not None and not handle.released:
            self._deposit(handle)
        else:
            handle.release()

    def _retire_world(self, old_gen) -> None:
        """Post-switch cleanup of the outgoing generation. With a pool the
        old world stays warm (resizing back to a recently left
        configuration is the dominant elasticity pattern); otherwise its
        functions and buffers drop (its state went with the last
        references)."""
        world, old_gen.payload = old_gen.payload, None
        if world is None or world.released:
            return
        if self.world_pool is None:
            world.release()
        else:
            self._deposit(world)

    def _harvest_spec_builders(self) -> None:
        """Deposit completed speculative builds into the pool. Build errors
        are swallowed: speculation must never take down training (the same
        target requested for real rebuilds, and re-raises, on the normal
        path)."""
        for key in [k for k, b in self._spec_builders.items() if b.ready]:
            builder = self._spec_builders.pop(key)
            try:
                handle = builder.result(0)
            except Exception:
                continue
            self.world_pool.put(key, handle)

    def prefetch_world(self, target: ParallelConfig) -> bool:
        """Speculatively build ``target``'s world into the warm pool, off
        the critical path (a background thread, as a real Prepare). Never
        while a reconfiguration is in flight, never for the active
        configuration, and at most ``MAX_SPEC_BUILDS`` at once. Returns
        True when a build was started."""
        if self.world_pool is None or self.reconfig_pending:
            return False
        if target == self.world.parallel:
            return False
        key = self.pool_key(target)
        self._harvest_spec_builders()
        if self.world_pool.contains(key) or key in self._spec_builders:
            return False
        if len(self._spec_builders) >= MAX_SPEC_BUILDS:
            return False
        self._spec_builders[key] = ShadowBuilder(lambda: self._build_world(target), gen_id=-1).start()
        return True

    # ------------------------------------------------------------------
    # Trigger / Prepare
    # ------------------------------------------------------------------
    def request_resize(
        self,
        target: ParallelConfig,
        overlap: Optional[str] = None,
        operating_point: Optional[OperatingPoint] = None,
    ) -> int:
        """Trigger: start preparing the Shadow World in a background thread.
        Non-blocking. ``overlap`` overrides the transfer mode for this
        reconfiguration only, and ``operating_point``
        (``reshard.autotune.OperatingPoint``) its ``stream_k`` and staging
        budget; None keeps the constructor's.

        The warm pool is consulted first: a warm world for the target (or
        an in-flight speculative build of it, which the Prepare thread
        joins) skips the build. The Prepare thread then plans the transfer
        (metadata only, so the pause never pays it) and allocates the
        destination tensors the plan writes into."""
        return self._prepare(target, overlap, operating_point, reuse=None)

    def _prepare(self, target, overlap, operating_point, reuse: Optional[dict]) -> int:
        if self._builder is not None:
            raise RuntimeError("a resize is already in flight; retarget_resize supersedes it")
        if overlap is not None:
            if overlap not in ("stop_copy", "stream"):
                raise ValueError(f"overlap={overlap!r}: want 'stop_copy' or 'stream'")
            self._overlap_mode = overlap
        if operating_point is not None:
            self._operating_point = operating_point
        gen = self.machine.begin_prepare(description=target.describe())
        src_parallel = self.world.parallel
        warm = join = None
        if self.world_pool is not None:
            # take before any harvest, which could evict the entry; a
            # ready but unharvested speculative build is caught by the join
            warm = self.world_pool.take(self.pool_key(target))
            if warm is None:
                join = self._spec_builders.pop(self.pool_key(target), None)
        self._orphans = [b for b in self._orphans if b.running]
        orphans = list(self._orphans)

        def build():
            nonlocal reuse
            handle = None
            t0 = time.perf_counter()
            try:
                if warm is not None:
                    handle = self._refresh_pooled(warm)
                elif join is not None:
                    handle = self._refresh_pooled(join.result(), source="speculative_join")
            except Exception:
                # speculation must never fail the real resize: a broken
                # warm or joined world falls back to a cold build, and the
                # taken handle is released
                if warm is not None:
                    warm.release()
                handle = None
            if handle is None:
                handle = self._build_world(target)
            else:
                handle.timings["refresh_s"] = time.perf_counter() - t0
            if builder.abandoned:
                return handle  # superseded already: it plans and allocates nothing
            try:
                t0 = time.perf_counter()
                specs, plan = plan_state_transfer(self.cfg, src_parallel, target, source_policy=self.source_policy)
                handle.timings["plan_s"] = time.perf_counter() - t0
                handle.plan_bundle = (src_parallel, specs, plan)
                # a superseded build may be allocating its set, or not yet
                # have dropped it: allocate only once it has ended
                t0 = time.perf_counter()
                for b in orphans:
                    b.join()
                handle.timings["orphan_wait_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                handle.buffers = state_buffers(specs, plan, handle.device, reuse=reuse)
                reuse = None  # what the plan did not take goes now
                if handle.device.type == "cuda":
                    torch.cuda.current_stream(handle.device).synchronize()
                handle.timings["alloc_s"] = time.perf_counter() - t0
            except BaseException:
                # the resize fails either way; pool (or release) the world
                # rather than leaking it
                self._discard_world(handle)
                raise
            return handle

        builder = ShadowBuilder(build, gen.gen_id, on_discard=self._discard_world)
        self._builder = builder.start()
        return gen.gen_id

    def _abandon_builder(self) -> None:
        self._builder.abandon()
        if not self._builder.ready:
            self._orphans.append(self._builder)

    def cancel_resize(self, outcome: Optional[str] = None) -> None:
        """Abandon the in-flight reconfiguration. ``outcome`` ("aborted")
        retires it with a ReconfigRecord; None cancels silently."""
        if outcome is not None and self._builder is not None:
            rec = self._pending_rec or ReconfigRecord(
                gen_id=self._builder.gen_id,
                src=self.world.parallel.describe(),
                dst=self.machine.shadow.description if self.machine.shadow else "?",
                mode="live_overlap" if self._overlap_mode == "stream" else "live",
            )
            rec.outcome = outcome
            self.records.append(rec)
        if self._session is not None:
            # the side stream may still write into the shadow's buffers
            self._session.drain()
        if self._builder is not None:
            self._abandon_builder()
        self.machine.cancel()
        self._reset_reconfig_state()

    @property
    def reconfig_pending(self) -> bool:
        """A resize is in flight (Prepare/Ready/streaming, not committed)."""
        return self._builder is not None

    def wait_shadow_ready(self, timeout: Optional[float] = None) -> None:
        """Block until the in-flight shadow world is built (deterministic
        replay in tests; the autonomous path keeps training instead)."""
        if self._builder is not None:
            self._builder.result(timeout)

    def retarget_resize(
        self,
        target: ParallelConfig,
        overlap: Optional[str] = None,
        operating_point: Optional[OperatingPoint] = None,
    ) -> int:
        """A newer elasticity event supersedes the in-flight reconfiguration
        (paper §7 'Concurrent reconfiguration events').

        The pending shadow is abandoned (its build thread cannot be killed,
        only orphaned; its world goes to the pool) and a fresh Prepare
        starts for ``target``. What the superseded session already streamed
        is kept: after a full drain, its carries (less any that alias a
        live tensor) and its unused buffers go to the new Prepare, which
        takes them as destination tensors and allocates only what is
        missing, and the successor session adopts the carries
        (:meth:`OverlapSession.adopt`), so the stream goes on where it left
        off. The superseded session is dropped before the new buffers are
        allocated. The superseded event retires with a ``retargeted``
        record carrying its pre-copy work."""
        if self._builder is None:
            return self.request_resize(target, overlap=overlap, operating_point=operating_point)
        reuse = buffers = None
        rec = self._pending_rec
        if self._session is not None:
            # drain first: the carries must hold landed rows, and no write
            # of the old session may still be in flight into them
            self._session.drain()
            carries, buffers = self._session_tensors()
            reuse = (carries, dict(self._session.streamed_at))
            rep = self._session.report
            if rec is not None:
                rec.precopy_s = rep.precopy_seconds
                rec.precopy_bytes = rep.precopy_bytes
        if rec is None:
            rec = ReconfigRecord(
                gen_id=self._builder.gen_id,
                src=self.world.parallel.describe(),
                dst=self.machine.shadow.description if self.machine.shadow else "?",
                mode="live_overlap" if self._overlap_mode == "stream" else "live",
            )
        rec.outcome = "retargeted"
        self.records.append(rec)
        self._abandon_builder()
        if self.machine.state in (GenState.PREPARE, GenState.READY):
            self.machine.cancel()
        self._reset_reconfig_state()  # drops the old session
        gen_id = self._prepare(target, overlap, operating_point, reuse=buffers)
        self._reuse = reuse
        return gen_id

    def escalate_commit(self) -> Optional[ReconfigRecord]:
        """Deadline pressure mid-stream: commit now, by stop-copy.

        The scheduler calls this when the warning window no longer covers
        the remaining pre-copy rounds. If the shadow world is ready, the
        whole transfer runs inside one stop-copy pause from the current
        cut: the middle rung of the fallback lattice. The streaming
        session is drained and dropped, and its carries (less any that
        alias a live tensor) and unused buffers become the stop-copy's
        destination. Returns the commit's record (``fell_back``, with the
        pre-copy work it wasted), or None when nothing was ready to commit
        (the caller falls through to the checkpoint rung)."""
        if self._builder is None or not self._builder.ready:
            return None
        if self.machine.state == GenState.PREPARE:
            self.machine.mark_ready(self._builder.gen_id, payload=self._builder.result())
        if self.machine.state != GenState.READY:
            return None
        rep = None
        reused = self._pending_rec.reused_layers if self._pending_rec else 0
        if self._session is not None:
            self._session.drain()
            rep = self._session.report
            _, self.machine.shadow.payload.buffers = self._session_tensors()
            self._session = None
        self._commit_switch()
        rec = self.records[-1]
        rec.outcome = "fell_back"
        if rep is not None:
            # the escalation's cost is the pre-copy work it wasted
            rec.precopy_s = rep.precopy_seconds
            rec.precopy_bytes = rep.precopy_bytes
            # max: the stop-copy counted the plan's resident layers; the
            # session's figure also counts layers adopted at a retarget
            rec.reused_layers = max(rec.reused_layers, reused)
        return rec

    def _session_tensors(self) -> tuple[dict, dict]:
        """The drained session's destination tensors that may be handed on:
        (its carries, its carries and unused buffers), leaving out any
        carry that shares storage with a live params or moment tensor (a
        resident tensor's carry is the live tensor itself)."""
        live = list(named_state_leaves(self.params, self.opt_state)[0].values())
        ex = self._session.executor
        carries = {n: t for n, t in ex.dst.items() if not shares_storage(t, live)}
        return carries, {**ex.dst_buffers, **carries}

    def prewarm_transfer(self, *args, **kwargs):
        raise NotImplementedError(_PREWARM)

    def prewarm_failover_ahead(self, *args, **kwargs):
        raise NotImplementedError(_PREWARM)

    def fail_stop_recover(self, *args, **kwargs):
        raise NotImplementedError(_RECOVERY)

    def checkpoint_now(self, *args, **kwargs):
        raise NotImplementedError(_RECOVERY)

    # ------------------------------------------------------------------
    # Training loop
    # ------------------------------------------------------------------
    def train_steps(self, n: int, collect: Optional[Callable] = None) -> list[float]:
        losses = []
        for _ in range(n):
            t0 = time.perf_counter()
            batch = self._batch()
            if self._commit_armed:
                # this step runs split (grads on the old world, overlapped
                # with the dirty re-sync; the update on the new world) and
                # commits the switch at its end
                metrics = self._split_step_commit(batch)
            else:
                fence = self._session.fence if self._session is not None else None
                self.params, self.opt_state, metrics = self.world.step_fn(
                    self.params, self.opt_state, batch, fence
                )
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            self.iteration_times.append(dt)
            self.ledger.record(t0, t0 + dt, "train", self.world.parallel.world_size)
            losses.append(loss)
            self.step += 1
            if collect:
                collect(self.step, metrics)
            self._poll_boundary()
        return losses

    def _batch(self) -> dict:
        tokens = torch.from_numpy(self.data.global_batch_at(self.step))
        return {"tokens": tokens.to(device=self.device, dtype=torch.long)}

    def _poll_boundary(self) -> None:
        """Iteration boundary = the consistent cut (invariant I3)."""
        if self._spec_builders:
            self._harvest_spec_builders()
        if self._builder is None or not self._builder.ready:
            return
        if self.machine.state == GenState.PREPARE:
            handle = self._builder.result()
            self.machine.mark_ready(self._builder.gen_id, payload=handle)
        if self.machine.state != GenState.READY:
            return
        if self._overlap_mode == "stop_copy":
            self._commit_switch()
            return
        # overlapped streaming: pre-copy K layers per boundary while the
        # Active World keeps training; once the plan is fully streamed,
        # arm the split-step commit for the NEXT train step
        if self._session is None:
            self._start_overlap_session()
        t0 = time.perf_counter()
        named, _ = named_state_leaves(self.params, self.opt_state)
        self._session.stream_next(named, self.step)
        dt = time.perf_counter() - t0
        self.ledger.record(t0, t0 + dt, "reshard_overlap", self.world.parallel.world_size)
        if self._session.done_precopy:
            self._commit_armed = True

    # ------------------------------------------------------------------
    # Plan bookkeeping (computed once, at READY)
    # ------------------------------------------------------------------
    def _ensure_plan(self, new_world: WorldHandle) -> None:
        """The plan of this reconfiguration: normally made during Prepare;
        remade here, timed into the record, only if the source layout
        changed since the request."""
        if self._session_plan is not None:
            return
        bundle = new_world.plan_bundle
        if bundle is not None and bundle[0] == self.world.parallel:
            _, specs, plan = bundle
            self._plan_seconds = 0.0
        else:
            t0 = time.perf_counter()
            specs, plan = plan_state_transfer(
                self.cfg, self.world.parallel, new_world.parallel, source_policy=self.source_policy
            )
            self._plan_seconds = time.perf_counter() - t0
        self._session_specs = specs
        self._session_plan = plan

    def _op_params(self) -> tuple[int, int]:
        """(stream_k, staging_bytes) for the current reconfiguration: the
        tuned operating point when one was installed, else the
        constructor's."""
        op = self._operating_point
        if op is None:
            return self.stream_k, self.staging_bytes
        return op.stream_k, op.staging_bytes

    def _new_record(self, new_world: WorldHandle, mode: str) -> ReconfigRecord:
        plan = self._session_plan
        return ReconfigRecord(
            gen_id=self._builder.gen_id,
            src=self.world.parallel.describe(),
            dst=new_world.parallel.describe(),
            prepare_s=new_world.timings.get("prepare_total_s", 0.0),
            mode=mode,
            plan_s=self._plan_seconds,
            plan_network_bytes=plan.network_bytes,
            plan_local_bytes=plan.local_bytes,
            layers_total=len(plan.layers()),
            warm_hit=bool(new_world.timings.get("warm_hit", False)),
            prepare_source=new_world.timings.get("prepare_source", "cold"),
            operating_point=None if self._operating_point is None else self._operating_point.to_dict(),
        )

    def _start_overlap_session(self) -> None:
        new_world: WorldHandle = self.machine.shadow.payload
        self._ensure_plan(new_world)
        stream_k, staging_bytes = self._op_params()
        self._session = OverlapSession(
            self._session_specs,
            self._session_plan,
            {},  # sources provided per streaming round
            self.world.devices,
            new_world.devices,
            staging_bytes,
            stream_k=stream_k,
            wire_policy=self.wire_policy,
            dst_buffers=new_world.buffers,
        )
        new_world.buffers = {}  # the session's executor owns them now
        self._pending_rec = self._new_record(new_world, "live_overlap")
        # retarget reuse: go on from the superseded session's streamed
        # state instead of restarting the stream from scratch
        if self._reuse is not None:
            carries, streamed_at = self._reuse
            self._reuse = None
            named, _ = named_state_leaves(self.params, self.opt_state)
            self._session.adopt(carries, streamed_at, named)
        # the session's figure counts the plan's resident layers (never
        # streamed) plus any adopted above
        self._pending_rec.reused_layers = self._session.report.reused_layers
        self._pending_rec.resident_layers = self._session.report.resident_layers

    # ------------------------------------------------------------------
    # Switch: stop-copy, the whole transfer inside the pause
    # ------------------------------------------------------------------
    def _commit_switch(self) -> None:
        gen_id = self._builder.gen_id
        new_world: WorldHandle = self.machine.shadow.payload
        self._ensure_plan(new_world)
        plan = self._session_plan
        rec = self._new_record(new_world, "live")
        rec.reused_layers = rec.resident_layers = len(plan.resident_layers())
        pause_start = time.perf_counter()
        self.machine.begin_switch(gen_id)

        # 1. drain: all in-flight device work completes
        t0 = time.perf_counter()
        self._sync()
        rec.drain_s = time.perf_counter() - t0

        # 2. the plan executed on the live tensors through the shared engine
        t0 = time.perf_counter()
        named, extras = named_state_leaves(self.params, self.opt_state)
        _, staging_bytes = self._op_params()
        moved, stats = live_reshard_planned(
            self._session_specs, plan, named, self.world.devices, new_world.devices,
            staging_bytes=staging_bytes, wire_policy=self.wire_policy,
            dst_buffers=new_world.buffers,
        )
        new_world.buffers = {}
        self.params, self.opt_state = rebuild_state(moved, self.params, self.opt_state, extras)
        rec.transfer_s = time.perf_counter() - t0
        rec.moved_bytes = stats.network_bytes + stats.local_bytes
        rec.skipped_bytes = stats.resident_bytes
        rec.resident_cells = stats.resident_cells
        rec.wire_bytes = stats.wire_bytes
        rec.logical_bytes = stats.logical_bytes
        rec.executed_bytes = stats.executed_bytes
        rec.stream_dispatch_s = stats.dispatch_seconds
        rec.stream_drain_s = stats.drain_seconds
        rec.generic_cells = stats.generic_cells

        # 3. atomic switch: pointer swap of world references
        t0 = time.perf_counter()
        old = self.machine.commit_switch(gen_id)
        rec.switch_s = time.perf_counter() - t0
        rec.total_pause_s = time.perf_counter() - pause_start
        self.ledger.record(
            pause_start, pause_start + rec.total_pause_s, "pause",
            max(self.world.parallel.world_size, new_world.parallel.world_size),
        )
        self.records.append(rec)
        self._reset_reconfig_state()
        # 4. cleanup
        self._retire_world(old)
        self.machine.finish_cleanup()

    # ------------------------------------------------------------------
    # Switch: overlapped. Grads on the old world hide the dirty re-sync;
    # the optimizer update lands directly on the new world
    # ------------------------------------------------------------------
    def _split_step_commit(self, batch: dict) -> dict:
        gen_id = self._builder.gen_id
        new_world: WorldHandle = self.machine.shadow.payload
        session = self._session
        rec = self._pending_rec
        plan = self._session_plan

        # the final gradients on the OLD world (its state is also the
        # re-sync's source: both only read it)
        cut = None
        if self.device.type == "cuda":
            cut = torch.cuda.Event()
            cut.record(torch.cuda.current_stream(self.device))
        loss, metrics, grads = self.world.grad_fn(self.params, batch)
        # overlapped with them on the card: re-sync every dirty layer from
        # this boundary's cut; drain=False only dispatches
        named, extras = named_state_leaves(self.params, self.opt_state)
        session.resync(named, self.step, drain=False, after=cut)
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        grad_tail_s = time.perf_counter() - t1  # residual wait past overlap

        # ---- the commit pause: re-sync tail + grad reshard + update +
        # pointer swap ----
        pause_start = time.perf_counter()
        self.machine.begin_switch(gen_id)
        commit_drain_s = session.drain()
        t0 = time.perf_counter()
        p_specs = [s for s in self._session_specs if s.collection == "params"]
        p_plan = TransferPlan(
            tasks=[t for t in plan.tasks if t.collection == "params"],
            cfg_src=plan.cfg_src,
            cfg_dst=plan.cfg_dst,
        )
        g_named = {f"params/{p}": g for p, g in tree_paths(grads).items()}
        del grads
        _, staging_bytes = self._op_params()
        g_moved, g_stats = live_reshard_planned(
            p_specs, p_plan, g_named, self.world.devices, new_world.devices,
            staging_bytes=staging_bytes, wire_policy=self.wire_policy,
        )
        del g_named
        grads_new = tree_from_paths({name[len("params/"):]: g for name, g in g_moved.items()})
        rec.transfer_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        params_new, opt_new = rebuild_state(session.results(), self.params, self.opt_state, extras)
        self.params, self.opt_state, om = new_world.update_fn(grads_new, opt_new, params_new)
        self._sync()
        rec.update_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        old = self.machine.commit_switch(gen_id)
        rec.switch_s = time.perf_counter() - t0
        rec.total_pause_s = time.perf_counter() - pause_start

        rep = session.report
        rec.drain_s = grad_tail_s + commit_drain_s
        rec.precopy_s = rep.precopy_seconds
        rec.precopy_bytes = rep.precopy_bytes
        rec.resync_s = rep.resync_seconds
        rec.resync_bytes = rep.resync_bytes
        rec.stream_dispatch_s = rep.dispatch_seconds + g_stats.dispatch_seconds
        rec.stream_drain_s = rep.drain_seconds + commit_drain_s + g_stats.drain_seconds
        rec.generic_cells = session.stats.generic_cells + g_stats.generic_cells
        rec.dirty_layers = rep.resync_layers
        rec.reused_layers = rep.reused_layers
        rec.resident_layers = rep.resident_layers
        rec.skipped_bytes = rep.skipped_bytes + g_stats.resident_bytes
        rec.resident_cells = rep.resident_cells + g_stats.resident_cells
        rec.wire_bytes = rep.wire_bytes + g_stats.wire_bytes
        rec.logical_bytes = rep.logical_bytes + g_stats.logical_bytes
        rec.moved_bytes = rep.total_bytes + g_stats.network_bytes + g_stats.local_bytes
        rec.executed_bytes = session.stats.executed_bytes + g_stats.executed_bytes
        self.ledger.record(
            pause_start, pause_start + rec.total_pause_s, "pause",
            max(self.world.parallel.world_size, new_world.parallel.world_size),
        )
        self.records.append(rec)
        self._reset_reconfig_state()
        self._retire_world(old)
        self.machine.finish_cleanup()
        return {"loss": loss, **metrics, **om}

    def _reset_reconfig_state(self) -> None:
        self._builder = None
        self._session = None
        self._session_specs = None
        self._session_plan = None
        self._pending_rec = None
        self._commit_armed = False
        self._plan_seconds = 0.0
        self._reuse = None
        self._overlap_mode = self.overlap
        self._operating_point = None

    # ------------------------------------------------------------------
    def gathered_params(self) -> Any:
        """A host copy of the params as numpy arrays (verification only:
        never on the live path)."""
        return tree_map_with_path(lambda _, x: x.detach().to("cpu", copy=True).numpy(), self.params)
