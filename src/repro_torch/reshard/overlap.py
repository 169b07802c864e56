"""Overlapped layer streaming for live reconfiguration (DESIGN.md §9).

The port of ``repro/reshard/overlap.py``. Stop-copy moves the entire state
inside the commit pause. An :class:`OverlapSession` instead streams the
plan's layers *between* training steps while the Active World keeps
stepping (pre-copy rounds), tracks which layers the optimizer dirtied
afterwards (a layer streamed at step ``s`` is stale once the optimizer has
stepped past ``s``), and re-syncs only the dirty set at commit time,
overlapped with the final gradient computation, so the blocking pause
shrinks to the residual tail plus the pointer swap.

On the card the rounds run on a side CUDA stream. ``stream_next`` only
dispatches a round: the side stream first waits for the trainer's stream
(the round reads the sources after the last in-place update), and the
round ends with an event, :attr:`fence`, that the trainer's next in-place
update waits on (``distribution/step.py::make_update_fn``), so the update
cannot overwrite a source before the round has read it: the port's analogue
of the JAX package's donation. The host blocks only to keep at most
``max_inflight_rounds`` rounds in flight (double buffering, DESIGN.md §9),
and at ``resync``/``drain`` (commit). On the CPU every copy has run when
its call returns.

As in the JAX package, under a dense optimizer every pre-copied layer is
dirty again by commit, so the re-sync moves the same bytes; what shrinks
the pause is that they move while the last gradients are computed, into
destination storage that is already there.

Retarget reuse (:meth:`OverlapSession.adopt`). A newer event may supersede
the reconfiguration mid-stream; the successor session adopts the carries
the superseded one streamed. On one card every world's carry is a global
tensor on the same device, so a carry of the right shape and dtype is laid
out as the new target wants it, and adoption is zero-copy: the new
executor's destination *is* the old carry (the JAX package relays out a
carry whose sharding differs). What the JAX package's liveness probe
guards against has another form here: the executor adopts a fully resident
tensor by aliasing the live source (``reshard/executors.py``), and a carry
that shares storage with a live params or moment tensor must never be
adopted, or the successor's scatters would write into the state that is
training. Such a carry is left behind and its layers re-stream.

On a per-rank world (``RankExecutor``) a carry is one rank's shard. The
controller hands on only the carries whose view in the new target is the
one they hold (``core/rank_controller.py``), a carry is taken where it has
the rank's view shape under the same alias rule, a layer needs carries
only of the tensors it moves into this rank (a tensor the rank adopts in
place needs none), and a layer counts as reused only where every rank of
the pool would reuse it (agreed, ``RankExecutor.agree``): otherwise the
ranks would stream different layers and post mismatched messages.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.intersection import TransferPlan
from repro_torch.core.records import ReuseRecordMixin
from repro_torch.core.resource_view import TensorSpec, dtype_name
from repro_torch.reshard.engine import ReshardEngine, StreamStats
from repro_torch.reshard.executors import LiveExecutor


def shares_storage(t: torch.Tensor, others) -> bool:
    """True when ``t``'s storage overlaps the storage of any tensor in
    ``others`` on the same device (a view or an alias of it, or it of them)."""
    lo = t.untyped_storage().data_ptr()
    hi = lo + t.untyped_storage().nbytes()
    for o in others:
        if o.device != t.device:
            continue
        o_lo = o.untyped_storage().data_ptr()
        if o_lo < hi and lo < o_lo + o.untyped_storage().nbytes():
            return True
    return False


@dataclass
class OverlapReport(ReuseRecordMixin):
    # reused_layers / resident_layers / skipped_bytes come from the shared
    # ReuseRecordMixin: resident layers never stream; adopt() adds layers
    # inherited from a superseded session at retarget
    precopy_rounds: int = 0
    precopy_bytes: int = 0
    precopy_seconds: float = 0.0
    resync_layers: int = 0
    resync_bytes: int = 0
    resync_seconds: float = 0.0
    # dispatch = host time issuing kernels, drain = blocking waits
    dispatch_seconds: float = 0.0
    drain_seconds: float = 0.0

    @property
    def total_bytes(self) -> int:
        return self.precopy_bytes + self.resync_bytes


class OverlapSession:
    """Drives one live reconfiguration's streaming across iteration
    boundaries. The controller owns the schedule (when boundaries happen);
    the session owns what moves at each one.

    ``src_devices`` / ``dst_devices`` are the two worlds' rank -> device
    lists; ``dst_buffers`` the destination tensors the shadow world
    allocated ahead (optional). ``executor``, given, replaces the
    ``LiveExecutor`` the session would build (a per-rank world's
    ``RankExecutor``, which holds its own buffers); its rounds run on the
    caller's stream, since its transport waits on the host."""

    def __init__(
        self,
        specs: list[TensorSpec],
        plan: TransferPlan,
        src_leaves: dict[str, torch.Tensor],
        src_devices: list,
        dst_devices: list,
        staging_bytes: int,
        stream_k: int = 4,
        max_inflight_rounds: int = 2,
        wire_policy=None,
        dst_buffers: Optional[dict[str, torch.Tensor]] = None,
        executor=None,
    ):
        self.spec_map = {s.name: s for s in specs}
        self.plan = plan
        self.executor = executor or LiveExecutor(
            self.spec_map, src_leaves, src_devices, dst_devices, staging_bytes,
            wire_policy=wire_policy, dst_buffers=dst_buffers,
        )
        self.engine = ReshardEngine(plan, self.executor, staging_bytes, wire_policy=wire_policy)
        device = self.executor.device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" and executor is None else None
        self.stream_k = max(1, stream_k)
        self.max_inflight_rounds = max(1, max_inflight_rounds)
        # fully-resident layers never enter the pre-copy schedule: the
        # commit-time resync re-adopts them from the final cut
        resident = set(plan.resident_layers())
        self.resident_layers: list[int] = sorted(l for l in self.engine.layers() if l in resident)
        self.pending: list[int] = [l for l in self.engine.layers() if l not in resident]
        self.streamed_at: dict[int, int] = {}
        self.stats = StreamStats()
        self.report = OverlapReport()
        self.report.resident_layers = len(self.resident_layers)
        self.report.reused_layers = len(self.resident_layers)
        # the end events of rounds whose writes may still be in flight
        self._inflight: list[Optional[torch.cuda.Event]] = []
        # what the trainer's next in-place update must wait for
        self.fence: Optional[torch.cuda.Event] = None

    @property
    def done_precopy(self) -> bool:
        return not self.pending

    def adopt(
        self,
        carries: dict[str, torch.Tensor],
        streamed_at: dict[int, int],
        live: dict[str, torch.Tensor],
    ) -> int:
        """Retarget reuse (DESIGN.md §10): seed this session from a
        superseded session's streamed state instead of restarting the stream
        from scratch.

        ``carries``: the superseded executor's destination tensors by name;
        ``streamed_at``: its layers' stream steps; ``live``: the training
        state's params and moment tensors (``named_state_leaves``). A carry
        of the shape the executor holds the tensor in (``carry_shape``) and
        its spec's dtype on this session's device becomes this executor's
        destination as it is (no copy), unless it shares storage with a live
        tensor. A layer counts as reused iff the old session streamed it and
        every tensor it needs carries of (``layer_tensors``) has an adopted
        one, on every rank (``agree``);
        it keeps its original ``streamed_at`` step, so the commit-time dirty
        re-sync still refreshes whatever the optimizer has since touched.
        Returns the number of reused layers.

        Must be called before the first ``stream_next``; the caller must
        have drained the old session (its writes must have landed)."""
        assert not self.streamed_at, "adopt() must precede streaming"
        live_tensors = list(live.values())
        adopted: set[str] = set()
        for name, leaf in carries.items():
            spec = self.spec_map.get(name)
            if spec is None or dtype_name(leaf.dtype) != spec.dtype:
                continue
            if tuple(leaf.shape) != self.executor.carry_shape(name):
                continue
            if leaf.device != self.executor.device or shares_storage(leaf, live_tensors):
                continue
            self.executor.dst[name] = leaf
            self.executor.dst_buffers.pop(name, None)
            adopted.add(name)
        ex = self.executor
        flags = ex.agree([l in streamed_at and ex.layer_tensors(self.plan.by_layer(l)) <= adopted
                          for l in self.pending])
        reused = [l for l, ok in zip(list(self.pending), flags) if ok]
        for l in reused:
            self.pending.remove(l)
            self.streamed_at[l] = streamed_at[l]
        # += : resident layers were already counted as reused at __init__
        self.report.reused_layers += len(reused)
        return len(reused)

    def dirty_layers(self, step: int) -> list[int]:
        """Layers whose stream predates the optimizer's latest update."""
        return sorted(l for l, s in self.streamed_at.items() if s < step)

    # ------------------------------------------------------------------
    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def _round(self, layers: list[int], after: Optional[torch.cuda.Event] = None) -> tuple[StreamStats, float]:
        """Dispatch one round on the session's stream; returns its stats
        and the host seconds it took."""
        t0 = time.perf_counter()
        with self._on_stream():
            self.executor.begin_round(after)
            s = self.engine.run(layers)
            self.fence = self.executor.sync_staging()
        self._inflight.append(self.fence)
        return s, time.perf_counter() - t0

    def _drain_rounds(self, keep: int) -> float:
        """Block until all but the newest ``keep`` rounds have landed."""
        t0 = time.perf_counter()
        while len(self._inflight) > keep:
            event = self._inflight.pop(0)
            if event is not None:
                event.synchronize()
        return time.perf_counter() - t0

    def drain(self) -> float:
        """Full barrier: every dispatched round has landed. The only sync
        points are here and in ``resync``: commit-time calls."""
        dt = self._drain_rounds(0)
        t0 = time.perf_counter()
        self.executor.block_until_ready()
        return dt + (time.perf_counter() - t0)

    def _account(self, s: StreamStats, dispatch_dt: float, drain_dt: float) -> None:
        s.drain_seconds += drain_dt
        self.stats.merge(s)
        # skipped bytes accrue per resident CELL (core/records.py)
        self.report.skipped_bytes += s.resident_bytes
        self.report.resident_cells += s.resident_cells
        self.report.logical_bytes += s.logical_bytes
        self.report.wire_bytes += s.wire_bytes
        self.report.dispatch_seconds += s.dispatch_seconds
        self.report.drain_seconds += drain_dt + max(0.0, dispatch_dt - s.dispatch_seconds)

    # ------------------------------------------------------------------
    def stream_next(self, src_leaves: dict[str, torch.Tensor], step: int) -> int:
        """One pre-copy round at an iteration boundary: dispatch the next K
        pending layers from the current state, and wait only for the
        round-before-last (double buffering). Returns layers streamed."""
        if not self.pending:
            return 0
        batch, self.pending = self.pending[: self.stream_k], self.pending[self.stream_k :]
        self.executor.update_sources(src_leaves)
        s, dispatch_dt = self._round(batch)
        drain_dt = self._drain_rounds(self.max_inflight_rounds - 1)
        self._account(s, dispatch_dt, drain_dt)
        for l in batch:
            self.streamed_at[l] = step
        self.report.precopy_rounds += 1
        self.report.precopy_bytes += s.network_bytes + s.local_bytes
        self.report.precopy_seconds += dispatch_dt + drain_dt
        return len(batch)

    def resync(
        self,
        src_leaves: dict[str, torch.Tensor],
        step: int,
        drain: bool = True,
        after: Optional[torch.cuda.Event] = None,
    ) -> StreamStats:
        """Re-stream every dirty layer (plus any pending tail, plus the
        resident layers' re-adoption) from the state at ``step``. After it
        (and :meth:`drain`, with ``drain=False``) the destination holds a
        byte-exact copy of the step-``step`` cut, or its wire round trip
        for quantized collections. ``after``: an event the trainer recorded
        once the step-``step`` state was written; the copies need not wait
        for the trainer's later work (the split step's gradients only read
        the state)."""
        layers = sorted(set(self.dirty_layers(step)) | set(self.pending) | set(self.resident_layers))
        self.pending = []
        self.executor.update_sources(src_leaves)
        self.executor.reset_round()
        s, dispatch_dt = self._round(layers, after)
        drain_dt = self.drain() if drain else 0.0
        self._account(s, dispatch_dt, drain_dt)
        for l in layers:
            self.streamed_at[l] = step
        self.report.resync_layers += len(layers)
        self.report.resync_bytes += s.network_bytes + s.local_bytes
        self.report.resync_seconds += dispatch_dt + drain_dt
        return s

    def results(self) -> dict[str, torch.Tensor]:
        return self.executor.results()
