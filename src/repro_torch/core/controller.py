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

The JAX API, with ``device=`` in place of its device list: every rank of
every world maps to that one device (the card by default; a CUDA request
without one raises), and ``params=`` (a param tree to train in place of
the seeded init, e.g. the JAX package's weights through
``models.convert.params_from_jax``). The step count, the one piece of
state outside the resource view, stays where it is on one device.

Not ported, each raising ``NotImplementedError`` with its ROADMAP item:
fail-stop recovery, the checkpoint rung and the parity spare (queue 1 item
9); the warm world pool's speculation, prewarms, retargeting and deadline
escalation (queue 1 item 7).
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
from repro_torch.data import SyntheticLM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.reshard import OverlapSession
from repro_torch.utils.pytree import tree_from_paths, tree_map_with_path, tree_paths

__all__ = ["LiveRController", "ReconfigRecord"]

_RECOVERY = "fail-stop recovery, the checkpoint rung and the parity spare are not ported yet (ROADMAP queue 1 item 9)"
_SPECULATION = (
    "the warm world pool's speculation, prewarms, retargeting and deadline escalation are not "
    "ported yet (ROADMAP queue 1 item 7)"
)


@dataclass
class ReconfigRecord(ReuseRecordMixin):
    """One reconfiguration (the JAX record's fields; those of the unported
    recovery and tuning paths keep their defaults)."""

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
    # committed | aborted
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
        world_pool=None,
        wire_policy=None,
        parity_every: int = 0,
        params: Optional[dict] = None,
    ):
        if ckpt_dir is not None or parity_every:
            raise NotImplementedError(_RECOVERY)
        if world_pool is not None:
            raise NotImplementedError(_SPECULATION)
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
        self._builder: Optional[ShadowBuilder] = None
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

    def _retire_world(self, old_gen) -> None:
        """Post-switch cleanup of the outgoing generation: its functions
        and buffers drop (its state went with the last references)."""
        world, old_gen.payload = old_gen.payload, None
        if world is not None:
            world.release()

    # ------------------------------------------------------------------
    # Trigger / Prepare
    # ------------------------------------------------------------------
    def request_resize(self, target: ParallelConfig, overlap: Optional[str] = None) -> int:
        """Trigger: start preparing the Shadow World in a background thread.
        Non-blocking. ``overlap`` overrides the transfer mode for this
        reconfiguration only.

        The Prepare thread builds the world, plans the transfer (metadata
        only, so the pause never pays it) and allocates the destination
        tensors the plan writes into."""
        if self._builder is not None:
            raise RuntimeError(f"a resize is already in flight; {_SPECULATION}")
        if overlap is not None:
            if overlap not in ("stop_copy", "stream"):
                raise ValueError(f"overlap={overlap!r}: want 'stop_copy' or 'stream'")
            self._overlap_mode = overlap
        gen = self.machine.begin_prepare(description=target.describe())
        src_parallel = self.world.parallel

        def build():
            handle = self._build_world(target)
            t0 = time.perf_counter()
            specs, plan = plan_state_transfer(self.cfg, src_parallel, target, source_policy=self.source_policy)
            handle.timings["plan_s"] = time.perf_counter() - t0
            handle.plan_bundle = (src_parallel, specs, plan)
            t0 = time.perf_counter()
            handle.buffers = state_buffers(specs, plan, handle.device)
            if handle.device.type == "cuda":
                torch.cuda.current_stream(handle.device).synchronize()
            handle.timings["alloc_s"] = time.perf_counter() - t0
            return handle

        self._builder = ShadowBuilder(build, gen.gen_id).start()
        return gen.gen_id

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
            self._builder.abandon()
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

    def retarget_resize(self, *args, **kwargs):
        raise NotImplementedError(_SPECULATION)

    def escalate_commit(self, *args, **kwargs):
        raise NotImplementedError(_SPECULATION)

    def prefetch_world(self, *args, **kwargs):
        raise NotImplementedError(_SPECULATION)

    def prewarm_transfer(self, *args, **kwargs):
        raise NotImplementedError(_SPECULATION)

    def prewarm_failover_ahead(self, *args, **kwargs):
        raise NotImplementedError(_SPECULATION)

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
        )

    def _start_overlap_session(self) -> None:
        new_world: WorldHandle = self.machine.shadow.payload
        self._ensure_plan(new_world)
        self._session = OverlapSession(
            self._session_specs,
            self._session_plan,
            {},  # sources provided per streaming round
            self.world.devices,
            new_world.devices,
            self.staging_bytes,
            stream_k=self.stream_k,
            wire_policy=self.wire_policy,
            dst_buffers=new_world.buffers,
        )
        new_world.buffers = {}  # the session's executor owns them now
        self._pending_rec = self._new_record(new_world, "live_overlap")
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
        moved, stats = live_reshard_planned(
            self._session_specs, plan, named, self.world.devices, new_world.devices,
            staging_bytes=self.staging_bytes, wire_policy=self.wire_policy,
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
        g_moved, g_stats = live_reshard_planned(
            p_specs, p_plan, g_named, self.world.devices, new_world.devices,
            staging_bytes=self.staging_bytes, wire_policy=self.wire_policy,
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
        self._overlap_mode = self.overlap

    # ------------------------------------------------------------------
    def gathered_params(self) -> Any:
        """A host copy of the params as numpy arrays (verification only:
        never on the live path)."""
        return tree_map_with_path(lambda _, x: x.detach().to("cpu", copy=True).numpy(), self.params)
