"""Execution backends for the ReshardEngine.

SimExecutor — the byte-level oracle: simulated ranks own numpy shards
(``RankStore``); every planned chunk is copied shard-to-shard exactly as a
real send/recv would. This is the semantics reference the property tests
exercise and the live path is validated against. (A copy of the JAX
package's.)

LiveExecutor — the live path over torch tensors.

How a world maps onto the card. A world is a ``ParallelConfig`` plus a
rank -> device list; with one card, every rank maps to that card. A world's
state is held as **global** tensors (each the whole logical tensor) on the
world's device, as the JAX executor works on global ``jax.Array``s whose
mesh only decides placement. Plan cells are per (tensor, destination rank);
on global tensors the same bytes exist once, so the executor deduplicates
replica fan-out by (tensor, bounds) and every move writes the destination
carry at the cell's global offsets. The cell kinds (resident / local /
remote) are the planner's, and the executor routes each tensor's layer by
them:

  * every cell resident -> adopt: the destination *is* the source tensor,
    no copy, 0 executed bytes (the JAX executor's aliasing ``device_put``);
  * local (and resident) cells that tile full rows, when the two worlds'
    rank -> device lists are equal (the JAX test that both meshes flatten
    to one device assignment) -> ``relayout_rows``, in batches of the
    staging budget;
  * every other full-row batch -> ``pack_rows`` into a staging buffer, then
    ``scatter_rows`` into the destination carry. One contiguous run is one
    block (``starts=[lo]``, ``block_rows=hi-lo``), scattered rows are
    blocks of one row. This is the one deliberate change from the JAX
    routing, which moves a contiguous run by slice + ``device_put`` +
    dynamic-update-slice and keeps pack/scatter for scattered rows: the
    port sends both through the two kernels, the same bytes by one
    mechanism, so the kernels run on every resize that moves state;
  * partial-width cells -> a plain box copy, counted in ``generic_cells``
    (the JAX package moves them outside any kernel too).

The compressed wire. Under a ``WirePolicy`` that quantizes a tensor's
collection (by default the Adam moments ``mu``/``nu`` to int8; params stay
lossless), every full-row batch of that tensor that does not take the
relayout goes ``pack_quant_rows`` -> staging -> ``dequant_scatter_rows``,
one tile (and one float32 scale) per row of the tensor collapsed to 2-D,
as the JAX executor does. The staging budget counts wire bytes (``row_elems
+ 4`` a row), and ``wire_bytes`` counts what was staged, as in the JAX
executor.

Destination carries are zero tensors on the world's device, allocated at
first touch, or taken from ``dst_buffers`` (zeroed tensors the shadow world
allocated ahead, ``core/shadow.py``). The kernels write into them in place,
on the current stream. At most two staging buffers stay referenced; on one
stream the caching allocator hands a dereferenced buffer's memory out again
only to work queued after the kernel that reads it.

The round protocol (:meth:`begin_round`, :meth:`round_touched`,
:meth:`sync_staging`, :meth:`reset_round`, :meth:`update_sources`) serves
``reshard/overlap.py``, whose pre-copy rounds run on a side CUDA stream
while training goes on. The trainer updates the source tensors in place,
so :meth:`begin_round` makes the executor's stream wait for the trainer's
stream, and :meth:`sync_staging` returns an event that the trainer's next
in-place update waits on: the port's analogue of the JAX package's
donation, which may not free a source before the round's reads retired.

RankExecutor — the live path between per-rank worlds: each process holds
its own shards (``core/resource_view.py::shard_of``) and posts the cells
it sends and receives through the rank pool's batched point-to-point call
(``distribution/groups.py::RankPool.exchange``).

How a cell maps onto a shard. Every process walks the same plan in the
same order (the engine calls ``apply`` for every chunk on every rank). A
cell is a box of its source shard and of its destination shard; in each,
its innermost partial dim ``k`` makes it runs of ``box[k] * inner``
contiguous elements, which are blocks of rows of the shard viewed as
``(numel / W, W)`` with ``W`` the largest width that divides the runs,
their starts and the shard. So every cell goes through the row kernels,
whatever its width, and its staged bytes are the cell in C order:

  * ``src == dst`` on this rank, every cell of the view resident -> adopt:
    the destination *is* the source shard, no copy;
  * ``src == dst``, the same runs at the same offsets in both shards ->
    ``relayout_rows`` (the two views cut to their common rows);
  * ``src == dst`` otherwise -> ``pack_rows`` and ``scatter_rows`` on
    this rank, no message;
  * ``src`` this rank -> ``pack_rows`` (or, for a collection the wire
    policy quantizes, ``pack_quant_rows``: one tile and one float32 scale
    per dim-0 row of the cell, the engine's wire accounting; a cell whose
    dim-0 rows are not contiguous in the shard is packed losslessly first)
    and a send;
  * ``dst`` this rank -> a receive into staging, then ``scatter_rows`` (or
    ``dequant_scatter_rows``, through a staging tile where the rows are not
    contiguous in the destination shard).

A layer's messages go out in one batched call, in waves whose summed wire
bytes stay under the staging budget; the wave boundaries follow the plan
order, the same on every rank, so no rank waits on a message its peer
posts in a later wave.

Replicas under a lossy wire. The ranks of a world that hold the same view
of a tensor (its dp replicas, or an ep group's copies of a tensor without
experts) must hold the same bytes, or their updates part. Where the wire
rounds a collection and one replica's copy crosses it, every other copy of
that view on this side takes the same rounding (:func:`wire_rounded`):
a local cell goes through ``pack_quant_rows`` and ``dequant_scatter_rows``
on this rank, and a view adopted in place is rounded in place once the
commit's transfers are done (:meth:`RankExecutor.results`). The replicas' cells have the same bounds (the
source views tile the tensor alike whichever replica sends), so they take
the same scales, as long as a quantized cell keeps its dim-0 rows whole
(``reshard/chunking.py`` splits it along dim 0 when its leading dimension
has more than one row).
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Optional

import torch

from repro_torch.core.intersection import TransferTask
from repro_torch.core.resource_view import TensorSpec, dtype_name, view_of
from repro_torch.core.shadow import world_device
from repro_torch.kernels import ops
from repro_torch.reshard.chunking import rows_per_budget
from repro_torch.reshard.wire import wire_nbytes


# ---------------------------------------------------------------------------
# Sim backend
# ---------------------------------------------------------------------------


class SimExecutor:
    """Copy planned chunks between per-rank numpy shard stores.

    The sim always copies losslessly (it is the byte-level semantics
    oracle), but it *prices* wire bytes under the given policy: its
    ``wire_bytes`` counter reports what a compressed wire would have
    carried for the same plan, so sim↔live accounting comparisons hold
    with or without quantization.
    """

    def __init__(
        self,
        src_stores: dict[int, Any],
        dst_stores: dict[int, Any],
        wire_policy=None,
    ):
        self.src_stores = src_stores
        self.dst_stores = dst_stores
        self.wire_policy = wire_policy
        self.executed_bytes = 0
        self.wire_bytes = 0

    def begin_layer(self, layer: int) -> None:
        pass

    def apply(self, task: TransferTask) -> None:
        src = self.src_stores[task.src_rank]
        dst = self.dst_stores[task.dst_rank]
        shape = task.shape()
        ssl = tuple(slice(o, o + s) for o, s in zip(task.src_offset, shape))
        dsl = tuple(slice(o, o + s) for o, s in zip(task.dst_offset, shape))
        dst.shards[task.tensor][dsl] = src.shards[task.tensor][ssl]
        # resident cells are already in place on the real device — the sim
        # still performs the copy (its per-rank stores are distinct buffers,
        # and the oracle must produce complete destination shards) but the
        # byte oracle counts them as zero moved bytes (DESIGN.md §13)
        if not task.resident:
            self.executed_bytes += task.nbytes
            self.wire_bytes += wire_nbytes(self.wire_policy, task)

    def end_layer(self, layer: int) -> None:
        pass


# ---------------------------------------------------------------------------
# Live backend
# ---------------------------------------------------------------------------


class LiveExecutor:
    """Execute plan regions on live torch tensors.

    src: {tensor name: global tensor of the source world}
    src_devices, dst_devices: the two worlds' rank -> device lists; the
        destination world's ranks must all name one device.
    """

    def __init__(
        self,
        specs: dict[str, TensorSpec],
        src: dict[str, torch.Tensor],
        src_devices: list,
        dst_devices: list,
        staging_bytes: int,
        wire_policy=None,
        dst_buffers: Optional[dict[str, torch.Tensor]] = None,
    ):
        self.specs = specs
        self.src = src
        self.device = world_device(dst_devices)
        # the fused relayout reads the source in place: legal only when the
        # two worlds place their ranks on the same devices
        self.relayout_ok = [torch.device(d) for d in src_devices] == [
            torch.device(d) for d in dst_devices
        ]
        self.staging_bytes = staging_bytes
        # None = fully lossless (the byte-oracle default)
        self.wire_policy = wire_policy
        self.dst_buffers = dict(dst_buffers or {})
        self.dst: dict[str, torch.Tensor] = {}
        self.executed_bytes = 0
        # bytes that crossed a staging buffer (quantized payload + sidecar
        # scales for compressed batches); relayouts and adoptions cross none
        self.wire_bytes = 0
        self.generic_cells = 0  # cells that fell off the full-row paths
        self.resident_passthroughs = 0  # tensors adopted in place
        # replica-dedupe: region key -> strongest kind seen ("resident" is
        # upgraded in place if another dst rank genuinely needs the bytes)
        self._seen: dict[tuple, str] = {}
        self._cells: dict[str, dict[tuple, TransferTask]] = {}
        self._resident_done: set[str] = set()
        self._staged: list[torch.Tensor] = []
        # the round protocol: destination tensors this round wrote into
        self._round_touched: set[str] = set()
        # the stream the trainer runs on (the executor may run on another)
        self._home = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    # -- round protocol (reshard/overlap.py) ------------------------------
    # -- retarget adoption (reshard/overlap.py::OverlapSession.adopt) ------
    def carry_shape(self, name: str) -> Optional[tuple]:
        """The shape a carry of ``name`` has here: the global tensor's."""
        return tuple(self.specs[name].shape)

    def layer_tensors(self, tasks) -> set[str]:
        """The tensors a layer's ``tasks`` need carries of to count as
        streamed: every tensor they touch."""
        return {t.tensor for t in tasks}

    def agree(self, flags: list[bool]) -> list[bool]:
        """Per-layer decisions, decided: one process decides alone."""
        return list(flags)

    def update_sources(self, src: dict[str, torch.Tensor]) -> None:
        """Swap in this boundary's source tensors; resident destinations
        re-adopt them."""
        self.src = src
        self._resident_done = set()

    def reset_round(self) -> None:
        """Layers streamed before may be streamed again (the dirty
        re-sync): forget the replica-dedupe set and the adoptions."""
        self._seen = {}
        self._resident_done = set()

    def begin_round(self, after: Optional[torch.cuda.Event] = None) -> None:
        """Open a round: forget the previous round's touched set, and on the
        card make the current (executor's) stream wait for the trainer's
        work so far, or only up to ``after`` (an event the trainer recorded
        after its last write of the sources): the round reads the sources
        after the trainer's last in-place update."""
        self._round_touched = set()
        if self._home is not None:
            stream = torch.cuda.current_stream(self.device)
            if after is not None:
                stream.wait_event(after)
            elif stream != self._home:
                stream.wait_stream(self._home)

    def round_touched(self) -> set[str]:
        """Destination tensors this round dispatched writes into."""
        return set(self._round_touched)

    def sync_staging(self) -> Optional[torch.cuda.Event]:
        """An event on the executor's stream after every read this round
        made of its sources (None on the CPU, where every copy has run).
        The trainer's next in-place update waits on it
        (``distribution/step.py::make_update_fn``), and the staged buffers
        are let go: they are only read on this stream."""
        self._staged = []
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    # -- engine protocol ------------------------------------------------
    def begin_layer(self, layer: int) -> None:
        self._cells = {}

    def apply(self, chunk: TransferTask) -> None:
        key = (chunk.tensor, chunk.bounds)
        prev = self._seen.get(key)
        if prev is not None:  # replica fan-out: same bytes, other dst rank
            if prev == "resident" and chunk.kind != "resident":
                # the region first showed up as resident, but this replica
                # lands on a rank that does NOT already hold it: one move on
                # the global tensor covers every destination rank
                self._seen[key] = chunk.kind
                self._cells[chunk.tensor][chunk.bounds] = chunk
            return
        self._seen[key] = chunk.kind
        self._cells.setdefault(chunk.tensor, {})[chunk.bounds] = chunk

    def end_layer(self, layer: int) -> None:
        for name, regions in self._cells.items():
            cells = list(regions.values())
            if all(c.resident for c in cells):
                self._adopt_resident(name)
            else:
                self._move_tensor(name, cells)
        self._cells = {}

    def _adopt_resident(self, name: str) -> None:
        """Every byte of this tensor's layer is already in place: the
        destination is the source tensor itself (global state, one
        device), so nothing is copied. A tensor adopted here and moved in
        another layer is written at its own coordinates with its own bytes."""
        self._round_touched.add(name)
        if name in self._resident_done:
            return
        self._resident_done.add(name)
        self.dst[name] = self.src[name].to(self.device)
        self.resident_passthroughs += 1

    # -- movement -------------------------------------------------------
    def _dst_carry(self, name: str) -> torch.Tensor:
        if name not in self.dst:
            spec = self.specs[name]
            dtype = getattr(torch, spec.dtype)
            buf = self.dst_buffers.pop(name, None)
            if buf is not None:
                if tuple(buf.shape) != spec.shape or buf.dtype != dtype or buf.device != self.device:
                    raise ValueError(f"{name}: buffer {tuple(buf.shape)} {buf.dtype} on {buf.device} does not match its spec")
                self.dst[name] = buf
            else:
                carry = torch.zeros(spec.shape, dtype=dtype, device=self.device)
                if self._home is not None and torch.cuda.current_stream(self.device) != self._home:
                    # allocated on a side stream, used by the trainer's
                    carry.record_stream(self._home)
                self.dst[name] = carry
        return self.dst[name]

    def _move_tensor(self, name: str, cells: list[TransferTask]) -> None:
        spec = self.specs[name]
        self._round_touched.add(name)
        if dtype_name(self.src[name].dtype) != spec.dtype or tuple(self.src[name].shape) != spec.shape:
            raise ValueError(
                f"{name}: source {tuple(self.src[name].shape)} {self.src[name].dtype} does not "
                f"match its spec {spec.shape} {spec.dtype}"
            )
        here = [c for c in cells if c.kind in ("local", "resident")]
        if here and self.relayout_ok:
            rest = [c for c in cells if c.kind == "remote"]
            rows_here = _full_rows(spec, here)
            rows_rest = _full_rows(spec, rest) if rest else []
            if rows_here is not None and rows_rest is not None:
                self._relayout_rows(name, rows_here)
                if not rest:
                    return
                cells = rest
        rows = _full_rows(spec, cells)
        if rows is not None:
            self._move_rows(name, rows)
        else:
            # partial-width cells (no full-row union): per-cell box copies
            self.generic_cells += len(cells)
            for c in cells:
                self._move_cell(name, c)

    def _rows_2d(self, name: str) -> tuple[torch.Tensor, torch.Tensor, int]:
        """(source, carry) as (rows, C) tensors, and the bytes of one row."""
        spec = self.specs[name]
        rows = spec.shape[0]
        carry = self._dst_carry(name).view(rows, -1)
        return self.src[name].reshape(rows, -1), carry, spec.nbytes // rows

    def _relayout_rows(self, name: str, rows: list[int]) -> None:
        leaf, carry, per_row = self._rows_2d(name)
        max_rows = rows_per_budget(per_row, self.staging_bytes)
        for i in range(0, len(rows), max_rows):
            batch = rows[i : i + max_rows]
            ops.relayout_rows(carry, leaf, batch, 1)
            self.executed_bytes += per_row * len(batch)

    def _wire_format(self, name: str) -> str:
        if self.wire_policy is None:
            return "none"
        return self.wire_policy.format_for(self.specs[name].collection)

    def _move_rows(self, name: str, rows: list[int]) -> None:
        leaf, carry, per_row = self._rows_2d(name)
        fmt = self._wire_format(name)
        if fmt != "none":
            # one float32 sidecar scale per row-tile rides with the payload
            wire_per_row = math.prod(self.specs[name].shape[1:]) + 4
        else:
            wire_per_row = per_row
        # the budget bounds what is staged: wire bytes
        max_rows = rows_per_budget(wire_per_row, self.staging_bytes)
        for i in range(0, len(rows), max_rows):
            batch = rows[i : i + max_rows]
            if fmt != "none":
                # the compressed wire, contiguous runs too: one tile a row
                qbuf, scales = ops.pack_quant_rows(leaf, batch, 1, fmt)
                ops.dequant_scatter_rows(carry, qbuf, scales, batch, 1)
                self._stage((qbuf, scales))
            else:
                runs = _runs(batch)
                if len(runs) == 1:  # one contiguous run: one block
                    starts, block_rows = [runs[0][0]], runs[0][1] - runs[0][0]
                else:  # scattered rows: blocks of one row
                    starts, block_rows = batch, 1
                buf = ops.pack_rows(leaf, starts, block_rows).to(self.device)
                ops.scatter_rows(carry, buf, starts, block_rows)
                self._stage(buf)
            self.executed_bytes += per_row * len(batch)
            self.wire_bytes += wire_per_row * len(batch)

    def _move_cell(self, name: str, cell: TransferTask) -> None:
        sl = tuple(slice(lo, hi) for lo, hi in cell.bounds)
        self._dst_carry(name)[sl].copy_(self.src[name][sl])
        self.executed_bytes += cell.nbytes
        self.wire_bytes += cell.nbytes

    def _stage(self, buf) -> None:
        """Keep at most two staging batches referenced."""
        self._staged.append(buf)
        if len(self._staged) > 2:
            self._staged.pop(0)

    # -- results --------------------------------------------------------
    def results(self) -> dict[str, torch.Tensor]:
        """Destination tensors (tensors never planned keep no entry)."""
        return self.dst

    def block_until_ready(self) -> None:
        """Wait until every copy this executor dispatched has landed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._staged = []


def _full_rows(spec, cells: list[TransferTask]) -> list[int] | None:
    """The sorted dim-0 rows these cells tile at full width, or None if the
    union does not decompose into complete rows (the generic-cell case)."""
    rows: set[int] = set()
    for c in cells:
        rows.update(range(c.bounds[0][0], c.bounds[0][1]))
    per_row = spec.nbytes // spec.shape[0]
    covered = sum(c.nbytes for c in cells)
    if covered == per_row * len(rows):
        return sorted(rows)
    return None


def _runs(sorted_rows: list[int]) -> list[tuple[int, int]]:
    """Collapse a sorted unique row list into contiguous [lo, hi) runs."""
    runs: list[tuple[int, int]] = []
    for r in sorted_rows:
        if runs and runs[-1][1] == r:
            runs[-1] = (runs[-1][0], r + 1)
        else:
            runs.append((r, r + 1))
    return runs


# ---------------------------------------------------------------------------
# Per-rank backend
# ---------------------------------------------------------------------------


def cell_runs(shape: tuple, offset: tuple, box: tuple) -> tuple[list[int], int]:
    """The element offsets of the contiguous runs of the box ``box`` at
    ``offset`` in a contiguous tensor of ``shape``, in C order, and the
    runs' length."""
    n = len(shape)
    partial = [d for d in range(n) if box[d] != shape[d]]
    k = partial[-1] if partial else 0
    inner = math.prod(shape[k + 1 :])
    strides = [math.prod(shape[d + 1 :]) for d in range(n)]
    base = offset[k] * inner
    starts = [
        base + sum(i * strides[d] for d, i in enumerate(idx))
        for idx in itertools.product(*(range(offset[d], offset[d] + box[d]) for d in range(k)))
    ]
    return starts, box[k] * inner


def _width(starts: list[int], run: int, numel: int) -> int:
    w = math.gcd(run, numel)
    for s in starts:
        w = math.gcd(w, s)
    return w


def _rows_contiguous(shape: tuple, box: tuple) -> bool:
    """The cell's dim-0 rows are whole rows of the shard."""
    return tuple(box[1:]) == tuple(shape[1:])


def wire_rounded(plan, specs, rank: int, wire_policy) -> frozenset:
    """The tensors whose copies on ``rank`` (a destination rank of
    ``plan``) that do not cross the wire take its rounding all the same:
    those of a collection ``wire_policy`` rounds, where some rank with the
    same view of the tensor receives a cell of it over the wire (the
    module docstring)."""
    cfg = plan.cfg_dst
    if wire_policy is None or rank >= cfg.world_size:
        return frozenset()
    crossed = {(t.tensor, t.dst_rank) for t in plan.tasks
               if t.kind == "remote" and wire_policy.format_for(t.collection) != "none"}
    out = set()
    for spec in specs:
        view = view_of(spec, cfg, rank) if wire_policy.format_for(spec.collection) != "none" else None
        if view is None:
            continue
        replicas = [r for r in range(cfg.world_size) if (v := view_of(spec, cfg, r)) is not None
                    and v.bounds == view.bounds]
        if any((spec.name, r) in crossed for r in replicas):
            out.add(spec.name)
    return frozenset(out)


def round_in_place(t: torch.Tensor, fmt: str) -> None:
    """``t`` through the wire's round trip in ``fmt``, one tile and scale a
    dim-0 row, written back in place."""
    rows = t.view(t.shape[0], -1)
    idx = list(range(t.shape[0]))
    q, scales = ops.pack_quant_rows(rows, idx, 1, fmt)
    ops.dequant_scatter_rows(rows, q, scales, idx, 1)


class RankExecutor:
    """Execute plan cells between per-rank shards (the module docstring).

    specs: {tensor name: TensorSpec}; src: this rank's source shards by
    name ({} for a rank outside the source world); transport: the pool's
    ``exchange(sends, recvs)``; dst_buffers: zeroed destination shards
    allocated ahead (``core/shadow.py::rank_state_buffers``); rounded: the
    tensors whose local cells take the wire's rounding
    (:func:`wire_rounded`; those adopted in place are rounded when the
    results are taken)."""

    def __init__(
        self,
        specs: dict[str, TensorSpec],
        src: dict[str, torch.Tensor],
        rank: int,
        cfg_dst,
        transport,
        device,
        staging_bytes: int,
        wire_policy=None,
        dst_buffers: Optional[dict[str, torch.Tensor]] = None,
        rounded=frozenset(),
    ):
        self.specs = specs
        self.src = src
        self.rank = rank
        self.rounded = rounded
        self._rounded_adopted: set[str] = set()
        self.cfg_dst = cfg_dst
        self.transport = transport
        self.device = torch.device(device)
        self.staging_bytes = staging_bytes
        self.wire_policy = wire_policy
        self.dst_buffers = dict(dst_buffers or {})
        self.dst: dict[str, torch.Tensor] = {}
        self.executed_bytes = 0  # bytes this rank wrote into its destination shards
        self.wire_bytes = 0  # bytes this rank put on the wire (payload and scales)
        self.generic_cells = 0  # every cell takes the row kernels
        self.sent_bytes: dict[int, int] = {}  # logical bytes sent, by destination rank
        self.recv_bytes: dict[int, int] = {}  # logical bytes received, by source rank
        self.peak_staged_bytes = 0
        self._chunks: list[TransferTask] = []
        self._resident_done: set[str] = set()
        self._round_touched: set[str] = set()
        self._home = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    # -- retarget adoption (reshard/overlap.py::OverlapSession.adopt) ------
    def carry_shape(self, name: str) -> Optional[tuple]:
        """This rank's view of ``name`` in the destination world (None
        where it holds none)."""
        view = view_of(self.specs[name], self.cfg_dst, self.rank) if self.rank < self.cfg_dst.world_size else None
        return None if view is None else view.shape()

    def layer_tensors(self, tasks) -> set[str]:
        """The tensors whose cells ``tasks`` move into this rank: a tensor
        this rank adopts in place needs no carry."""
        return {t.tensor for t in tasks if t.dst_rank == self.rank and t.kind != "resident"}

    def agree(self, flags: list[bool]) -> list[bool]:
        """Per-layer decisions, agreed (MIN) over the pool: a layer one
        rank would stream again streams on all."""
        return [v >= 1.0 for v in self.transport.agree_all([1.0 if f else 0.0 for f in flags], "min")]

    # -- round protocol (reshard/overlap.py) ------------------------------
    def update_sources(self, src: dict[str, torch.Tensor]) -> None:
        self.src = src
        self._resident_done = set()

    def reset_round(self) -> None:
        self._resident_done = set()

    def begin_round(self, after: Optional[torch.cuda.Event] = None) -> None:
        self._round_touched = set()
        if self._home is not None:
            stream = torch.cuda.current_stream(self.device)
            if after is not None:
                stream.wait_event(after)
            elif stream != self._home:
                stream.wait_stream(self._home)

    def round_touched(self) -> set[str]:
        return set(self._round_touched)

    def sync_staging(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    # -- engine protocol ------------------------------------------------
    def begin_layer(self, layer: int) -> None:
        self._chunks = []

    def apply(self, chunk: TransferTask) -> None:
        self._chunks.append(chunk)

    def end_layer(self, layer: int) -> None:
        wave, used = [], 0
        for c in self._chunks:
            if c.resident:
                if c.dst_rank == self.rank:
                    self._adopt(c.tensor)
                continue
            nbytes = wire_nbytes(self.wire_policy, c)
            if wave and used + nbytes > self.staging_bytes:
                self._run_wave(wave)
                wave, used = [], 0
            wave.append(c)
            used += nbytes
        if wave:
            self._run_wave(wave)
        self._chunks = []

    def _adopt(self, name: str) -> None:
        self._round_touched.add(name)
        if name in self._resident_done:
            return
        self._resident_done.add(name)
        self.dst[name] = self.src[name]

    # -- geometry -------------------------------------------------------
    def _dst_carry(self, name: str) -> torch.Tensor:
        if name not in self.dst:
            spec = self.specs[name]
            shape = view_of(spec, self.cfg_dst, self.rank).shape()
            dtype = getattr(torch, spec.dtype)
            buf = self.dst_buffers.pop(name, None)
            if buf is not None:
                if tuple(buf.shape) != shape or buf.dtype != dtype or buf.device != self.device:
                    raise ValueError(f"{name}: buffer {tuple(buf.shape)} {buf.dtype} does not match its view {shape}")
                self.dst[name] = buf
            else:
                self.dst[name] = torch.zeros(shape, dtype=dtype, device=self.device)
        return self.dst[name]

    @staticmethod
    def _rows(t: torch.Tensor, offset: tuple, box: tuple) -> tuple[torch.Tensor, list[int], int]:
        """(the (numel/W, W) view of ``t``, block starts, block rows) of
        the box."""
        starts, run = cell_runs(tuple(t.shape), offset, box)
        w = _width(starts, run, t.numel())
        return t.view(-1, w), [s // w for s in starts], run // w

    def _fmt(self, c: TransferTask) -> str:
        return "none" if self.wire_policy is None else self.wire_policy.format_for(c.collection)

    # -- movement -------------------------------------------------------
    def _pack(self, c: TransferTask) -> list[torch.Tensor]:
        src = self.src[c.tensor]
        box = c.shape()
        fmt = self._fmt(c)
        if fmt == "none":
            view, starts, br = self._rows(src, c.src_offset, box)
            return [ops.pack_rows(view, starts, br)]
        if _rows_contiguous(tuple(src.shape), box):
            rows = list(range(c.src_offset[0], c.src_offset[0] + box[0]))
            q, scales = ops.pack_quant_rows(src.view(src.shape[0], -1), rows, 1, fmt)
        else:
            view, starts, br = self._rows(src, c.src_offset, box)
            flat = ops.pack_rows(view, starts, br)
            q, scales = ops.pack_quant_rows(flat.view(box[0], -1), list(range(box[0])), 1, fmt)
        return [q, scales]

    def _recv_buffers(self, c: TransferTask) -> list[torch.Tensor]:
        box = c.shape()
        numel = math.prod(box)
        dtype = getattr(torch, self.specs[c.tensor].dtype)
        fmt = self._fmt(c)
        if fmt == "none":
            return [torch.empty(numel, dtype=dtype, device=self.device)]
        from repro_torch.kernels.ref import WIRE_QDTYPE

        return [torch.empty((box[0], numel // box[0]), dtype=WIRE_QDTYPE[fmt], device=self.device),
                torch.empty((box[0], 1), dtype=torch.float32, device=self.device)]

    def _unpack(self, c: TransferTask, bufs: list[torch.Tensor]) -> None:
        dst = self._dst_carry(c.tensor)
        box = c.shape()
        if len(bufs) == 1:
            view, starts, br = self._rows(dst, c.dst_offset, box)
            ops.scatter_rows(view, bufs[0].view(-1, view.shape[1]), starts, br)
            return
        q, scales = bufs
        if _rows_contiguous(tuple(dst.shape), box):
            rows = list(range(c.dst_offset[0], c.dst_offset[0] + box[0]))
            ops.dequant_scatter_rows(dst.view(dst.shape[0], -1), q, scales, rows, 1)
            return
        tile = torch.empty(q.shape, dtype=dst.dtype, device=self.device)
        ops.dequant_scatter_rows(tile, q, scales, list(range(box[0])), 1)
        view, starts, br = self._rows(dst, c.dst_offset, box)
        ops.scatter_rows(view, tile.view(-1, view.shape[1]), starts, br)

    def _local(self, c: TransferTask) -> None:
        if c.tensor in self.rounded:
            self._unpack(c, self._pack(c))
            self.executed_bytes += c.nbytes
            return
        src, dst = self.src[c.tensor], self._dst_carry(c.tensor)
        box = c.shape()
        s_starts, s_run = cell_runs(tuple(src.shape), c.src_offset, box)
        d_starts, d_run = cell_runs(tuple(dst.shape), c.dst_offset, box)
        if s_starts == d_starts and s_run == d_run:
            w = math.gcd(_width(s_starts, s_run, src.numel()), _width(d_starts, d_run, dst.numel()))
            rows = min(src.numel(), dst.numel()) // w
            ops.relayout_rows(dst.view(-1, w)[:rows], src.view(-1, w)[:rows], [s // w for s in s_starts], s_run // w)
        else:
            view, starts, br = self._rows(src, c.src_offset, box)
            buf = ops.pack_rows(view, starts, br)
            dview, dstarts, dbr = self._rows(dst, c.dst_offset, box)
            ops.scatter_rows(dview, buf.view(-1, dview.shape[1]), dstarts, dbr)
        self.executed_bytes += c.nbytes

    def _run_wave(self, wave: list[TransferTask]) -> None:
        sends, recvs, landing = [], [], []
        staged = 0
        for c in wave:
            if c.src_rank == self.rank and c.dst_rank == self.rank:
                self._round_touched.add(c.tensor)
                self._local(c)
            elif c.src_rank == self.rank:
                bufs = self._pack(c)
                sends += [(c.dst_rank, b) for b in bufs]
                nbytes = sum(b.numel() * b.element_size() for b in bufs)
                staged += nbytes
                self.wire_bytes += nbytes
                self.sent_bytes[c.dst_rank] = self.sent_bytes.get(c.dst_rank, 0) + c.nbytes
            elif c.dst_rank == self.rank:
                self._round_touched.add(c.tensor)
                bufs = self._recv_buffers(c)
                recvs += [(c.src_rank, b) for b in bufs]
                landing.append((c, bufs))
                staged += sum(b.numel() * b.element_size() for b in bufs)
                self.recv_bytes[c.src_rank] = self.recv_bytes.get(c.src_rank, 0) + c.nbytes
                self.executed_bytes += c.nbytes
        self.peak_staged_bytes = max(self.peak_staged_bytes, staged)
        self.transport.exchange(sends, recvs)
        for c, bufs in landing:
            self._unpack(c, bufs)

    # -- results --------------------------------------------------------
    def results(self) -> dict[str, torch.Tensor]:
        """The destination shards, the transfers done: a rounded view this
        rank adopted in place takes the wire's rounding here, once."""
        for name in self.rounded - self._rounded_adopted:
            if name in self.dst and self.dst[name] is self.src.get(name):
                round_in_place(self.dst[name], self.wire_policy.format_for(self.specs[name].collection))
                self._rounded_adopted.add(name)
        return self.dst

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
