"""Backend-agnostic Algorithm 1 driver (paper §4.6.2).

The engine owns everything that is *protocol*: layer ordering, per-layer
barriers, staging-budget chunking and its bounded-memory accounting
(Theorem 1), and the byte/phase statistics. Executors own everything that
is *mechanism*: how one planned chunk's bytes actually move (numpy shard
copies for the sim oracle, torch tensor copies for the live path).

One engine + plan therefore produces identical `StreamStats` byte
accounting regardless of backend — the "plan-vs-live agreement" the
benchmarks report.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional, Protocol

from repro_torch.core.errors import RecoveryError
from repro_torch.core.intersection import TransferPlan, TransferTask
from repro_torch.reshard.chunking import chunk_task
from repro_torch.reshard.wire import wire_nbytes

# Documented fallback (paper default B = 512 MB): the autotuner
# (repro.reshard.autotune) picks a measured staging budget per reconfig
# when bandwidth history exists; this constant is what every path uses
# when it does not.
DEFAULT_STAGING_BYTES = 512 * 1024 * 1024


@dataclass
class StreamStats:
    layers_streamed: int = 0
    network_bytes: int = 0
    local_bytes: int = 0
    # compressed wire format (DESIGN.md §14): logical_bytes is what the plan
    # says streamed (== network_bytes), wire_bytes is what physically crossed
    # the interconnect under the wire policy (quantized payload + sidecar
    # scales; equal to logical_bytes when lossless) — the ratio of the two is
    # the stream's compression factor
    wire_bytes: int = 0
    logical_bytes: int = 0
    # bytes whose cells were classified resident: already in place on the
    # right device, counted here and moved nowhere (DESIGN.md §13)
    resident_bytes: int = 0
    resident_cells: int = 0
    peak_staging_bytes: int = 0
    barriers: int = 0
    chunks: int = 0
    per_layer_bytes: dict[int, int] = field(default_factory=dict)
    # backend-reported: bytes the executor physically moved (the live path
    # moves each deduplicated region once; the sim oracle moves per-rank)
    executed_bytes: int = 0
    seconds: float = 0.0
    # host time spent issuing the round's device programs (engine loop) vs
    # waiting for them to land — the async data plane's win is dispatch
    # shrinking while drain overlaps useful work. Filled by the engine
    # (dispatch) and whichever caller performs the blocking wait (drain).
    dispatch_seconds: float = 0.0
    drain_seconds: float = 0.0
    # cells that fell off the row-merge fast path onto the generic per-cell
    # fallback (surfaced so slow-path regressions show up in benchmarks)
    generic_cells: int = 0

    def assert_bounded(self, budget: int) -> None:
        assert self.peak_staging_bytes <= budget, (
            f"staging {self.peak_staging_bytes} exceeded budget {budget} "
            "(Theorem 1 violated)"
        )

    def merge(self, other: "StreamStats") -> None:
        self.layers_streamed += other.layers_streamed
        self.network_bytes += other.network_bytes
        self.local_bytes += other.local_bytes
        self.wire_bytes += other.wire_bytes
        self.logical_bytes += other.logical_bytes
        self.resident_bytes += other.resident_bytes
        self.resident_cells += other.resident_cells
        self.peak_staging_bytes = max(
            self.peak_staging_bytes, other.peak_staging_bytes
        )
        self.barriers += other.barriers
        self.chunks += other.chunks
        for k, v in other.per_layer_bytes.items():
            self.per_layer_bytes[k] = self.per_layer_bytes.get(k, 0) + v
        self.executed_bytes += other.executed_bytes
        self.seconds += other.seconds
        self.dispatch_seconds += other.dispatch_seconds
        self.drain_seconds += other.drain_seconds
        self.generic_cells += other.generic_cells


class Executor(Protocol):
    """What a backend must provide; all protocol logic stays in the engine."""

    def begin_layer(self, layer: int) -> None: ...

    def apply(self, chunk: TransferTask) -> None: ...

    def end_layer(self, layer: int) -> None: ...

    @property
    def executed_bytes(self) -> int: ...


class ReshardEngine:
    """Execute a TransferPlan through a pluggable executor, one layer at a
    time, with bounded staging (Algorithm 1)."""

    def __init__(
        self,
        plan: TransferPlan,
        executor,
        staging_bytes: int = DEFAULT_STAGING_BYTES,
        zero_copy_local: bool = True,
        delta: bool = True,
        wire_policy=None,
    ):
        self.plan = plan
        self.executor = executor
        self.staging_bytes = staging_bytes
        self.zero_copy_local = zero_copy_local
        # delta=False demotes resident cells to the pre-classification local
        # path — the full-copy baseline benchmarks compare against
        self.delta = delta
        # None = fully lossless wire (the byte-oracle default); a WirePolicy
        # quantizes remote chunks of its configured collections on the wire,
        # shrinking both staged bytes and the staging budget they count
        # against (Theorem 1 bounds *wire* bytes — that is what is staged)
        self.wire_policy = wire_policy

    def layers(self) -> list[int]:
        return self.plan.layers()

    def run(self, layers: Optional[Iterable[int]] = None) -> StreamStats:
        """Stream the given layers (default: all, ascending; -1 = non-layer
        state first). Each layer ends with a barrier; the staging buffer is
        reused across layers so peak memory never scales with model size."""
        stats = StreamStats()
        t0 = time.perf_counter()
        run_layers = list(self.layers() if layers is None else layers)
        # source-release schedule: a tensor's sources may be freed after its
        # last layer of THIS run (only executors that opted in act on it)
        release = getattr(self.executor, "release", None)
        releasable: dict[int, list[str]] = {}
        if release is not None:
            in_run = set(run_layers)
            last_layer: dict[str, int] = {}
            for t in self.plan.tasks:
                if t.layer in in_run and t.layer >= last_layer.get(t.tensor, -(1 << 62)):
                    last_layer[t.tensor] = t.layer
            for name, ll in last_layer.items():
                releasable.setdefault(ll, []).append(name)
        exec0 = getattr(self.executor, "executed_bytes", 0)
        gen0 = getattr(self.executor, "generic_cells", 0)
        wait0 = getattr(self.executor, "stage_wait_seconds", 0.0)
        for layer in run_layers:
            self.run_layer(layer, stats)
            for name in releasable.get(layer, ()):
                release(name)
        stats.seconds = time.perf_counter() - t0
        # the engine loop only *issues* work on an async backend — except
        # staging backpressure, which the executor self-reports so those
        # blocked seconds land on the drain side of the attribution
        waited = getattr(self.executor, "stage_wait_seconds", 0.0) - wait0
        stats.dispatch_seconds = stats.seconds - waited
        stats.drain_seconds += waited
        # delta, not lifetime total: the same executor may serve many runs
        # (overlap pre-copy rounds) and per-run stats are merged downstream
        stats.executed_bytes = getattr(self.executor, "executed_bytes", 0) - exec0
        stats.generic_cells = getattr(self.executor, "generic_cells", 0) - gen0
        return stats

    def run_layer(self, layer: int, stats: StreamStats) -> None:
        tasks = self.plan.by_layer(layer)
        if not tasks:
            return
        self.executor.begin_layer(layer)
        # group by destination rank — each dst drains its own staging buffer
        by_dst: dict[int, list[TransferTask]] = {}
        for t in tasks:
            by_dst.setdefault(t.dst_rank, []).append(t)
        for dst_rank, dtasks in by_dst.items():
            staging_used = 0
            for task in dtasks:
                if task.kind == "lost":
                    # survivor-constrained plan with an unrepaired hole
                    # (DESIGN.md §15): executing it would read a dead rank.
                    raise RecoveryError(
                        f"plan has a lost cell for {task.tensor} dst rank "
                        f"{task.dst_rank} ({task.nbytes} bytes): no surviving "
                        "source; repair from parity or fall back before "
                        "executing"
                    )
                if task.resident:
                    if self.delta:
                        # bytes already in place: account, never chunk/move
                        self.executor.apply(task)
                        stats.resident_bytes += task.nbytes
                        stats.resident_cells += 1
                        continue
                    # full-copy baseline: demote to the pre-classification
                    # local path so the executor physically moves the bytes
                    task = dataclasses.replace(task, kind="local")
                if task.local and self.zero_copy_local:
                    self.executor.apply(task)
                    stats.local_bytes += task.nbytes
                    continue
                for chunk in chunk_task(task, self.staging_bytes, self.wire_policy):
                    stats.chunks += 1
                    staged = wire_nbytes(self.wire_policy, chunk)
                    if staging_used + staged > self.staging_bytes:
                        # flush: everything staged so far is assembled into
                        # the destination shard; buffer is reused
                        staging_used = 0
                    staging_used += staged
                    stats.peak_staging_bytes = max(
                        stats.peak_staging_bytes, staging_used
                    )
                    self.executor.apply(chunk)
                    stats.network_bytes += chunk.nbytes
                    stats.logical_bytes += chunk.nbytes
                    stats.wire_bytes += staged
            stats.per_layer_bytes[layer] = stats.per_layer_bytes.get(
                layer, 0
            ) + sum(t.nbytes for t in dtasks)
        self.executor.end_layer(layer)
        stats.barriers += 1
        stats.layers_streamed += 1
