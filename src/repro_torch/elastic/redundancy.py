"""Peer-redundancy recovery layer (DESIGN.md §15).

The port of ``repro/elastic/redundancy.py``: a copy, with the parity word
formed over torch bytes. The redundancy needed to recover from a
fail-stop is usually already in device memory: DP replicas hold full
copies of params and (non-ZeRO) optimizer moments, and the intersection
planner knows exactly which ranks those are.

* :class:`RedundancyMap`: for one source world and one survivor set,
  which surviving rank holds a valid replica of each distinct shard
  (computed from the planner's src views, grouped by view bounds).
* :func:`survivors_for`: the survivor set implied by a fail-stop event
  (explicit ``lost_ranks``, or the prefix-allocation default: the ranks
  beyond the target world died).
* :func:`balance_donors`: post-pass over a survivor-constrained
  :class:`~repro_torch.core.intersection.TransferPlan` that spreads remote
  cells across the surviving replicas of each cell (greedy
  least-loaded-by-bytes).
* :class:`ParityStore`: the spare-shard scheme for worlds with no replica
  axis (dp=1): an XOR parity of the distinct shard images of every tensor,
  refreshed at idle step boundaries. A shard whose entire replica group
  died is reconstructed as ``parity XOR (all surviving groups)`` and
  written back into the live tensors before the recovery stream runs.
* :func:`heal_plan`: after parity repair, rewrites ``kind == "lost"``
  cells into executable remote cells sourced from the (repaired) owner
  rank.

Where the parity word lives. The JAX package keeps it "off the owning
replicas (host memory here)", as numpy. The port keeps it in host memory
too, pinned when the state is on the card, and forms it on the state's
device a tensor at a time: every distinct shard image is XOR-ed
(``bitwise_xor_``) into a scratch the size of the tensor's largest shard,
which is then copied to the host once. The word of qwen3-1.7b's training
state at dp1tp4 is 6.10 GB; on the card it would sit beside the training
peak and a recovery's destination tensors. Repair brings a tensor's word
back to the device, XORs the surviving groups into it there, and copies the
reconstructed bytes into the dead region of the live tensor, in place: a
copy of the tensor (the JAX ``arr.at[sl].set``) would be a second set at
full width, and the dead region's bytes are garbage after a loss.

On a per-rank world (:class:`RankParityStore`) no process holds the whole
tensor. The word is formed across the pool: each distinct shard image is
contributed once, by the first rank of its replica group, zero-padded, and
the pool XOR-reduces the contributions as ``uint8`` (gloo's ``BXOR``,
``distribution/groups.py::RankPool.xor_reduce``). Every rank keeps the
whole word in its host memory (pinned when its state is on the card): a
loss takes the copies of the ranks it takes, never the survivors'. That
costs every rank the word's bytes of host memory (qwen3-1.7b at dp1tp4,
28 layers: 6.10 GB a rank, 24.4 GB over four), and each refresh one
all-reduce of them. A repair is formed on the rank ``heal_plan`` makes the
cell's source, the first owner of the dead group: the lowest surviving
rank contributes its copy of the word, one surviving owner of every other
group its image, and the pool XOR-reduces them to that rank, which keeps
the reconstructed shard as its source. It reads nothing the loss took.

``RecoveryError`` (re-exported from :mod:`repro_torch.core.errors`) is the
typed "no rung left" failure: no surviving replica, no fresh parity, no
checkpoint directory.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.errors import RecoveryError
from repro_torch.core.intersection import TransferPlan, TransferTask, replica_candidates
from repro_torch.core.resource_view import TensorSpec, itemsize, view_of

__all__ = [
    "RecoveryError",
    "RedundancyMap",
    "ParityStore",
    "RankParityStore",
    "survivors_for",
    "balance_donors",
    "heal_plan",
]


def survivors_for(
    cfg_src: ParallelConfig,
    lost_ranks: Iterable[int] = (),
    target: Optional[ParallelConfig] = None,
    devices_failed: bool = True,
) -> frozenset[int]:
    """Survivor ranks of ``cfg_src`` after a fail-stop.

    Explicit ``lost_ranks`` win. Otherwise, under the prefix device
    allocation (rank r <-> devices[r] in every world), an unannounced
    fail-stop that forces a shrink to ``target`` means the ranks beyond the
    target prefix died. With ``devices_failed=False`` (warned event past
    its window: the machines are still up) everyone survives.
    """
    lost = set(int(r) for r in lost_ranks)
    if not lost and devices_failed and target is not None:
        lost = set(range(target.world_size, cfg_src.world_size))
    return frozenset(range(cfg_src.world_size)) - lost


# ---------------------------------------------------------------------------
# Redundancy map
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardCover:
    """One distinct shard image of one tensor and who can still donate it."""

    tensor: str
    bounds: tuple[tuple[int, int], ...]
    owners: tuple[int, ...]  # the full replica group in cfg_src
    donors: tuple[int, ...]  # owners ∩ survivors
    nbytes: int


@dataclass
class RedundancyMap:
    """Which surviving device holds a valid replica of each shard.

    Shards are grouped by view bounds: ranks with byte-identical views
    form one replica group. ``complete`` iff every group kept at least one
    survivor; ``uncovered`` lists the holes parity must fill.
    """

    cfg: ParallelConfig
    survivors: frozenset[int]
    covers: list[ShardCover] = field(default_factory=list)

    @classmethod
    def build(cls, specs: Iterable[TensorSpec], cfg: ParallelConfig, survivors: frozenset[int]) -> "RedundancyMap":
        covers: list[ShardCover] = []
        for spec in specs:
            groups: dict[tuple, list[int]] = {}
            for r in range(cfg.world_size):
                v = view_of(spec, cfg, r)
                if v is not None and v.size != 0:
                    groups.setdefault(v.bounds, []).append(r)
            for bounds, owners in groups.items():
                covers.append(ShardCover(
                    tensor=spec.name,
                    bounds=bounds,
                    owners=tuple(owners),
                    donors=tuple(r for r in owners if r in survivors),
                    nbytes=_nbytes(spec, bounds),
                ))
        return cls(cfg=cfg, survivors=survivors, covers=covers)

    @property
    def complete(self) -> bool:
        return all(c.donors for c in self.covers)

    def uncovered(self) -> list[ShardCover]:
        return [c for c in self.covers if not c.donors]

    @property
    def uncovered_bytes(self) -> int:
        return sum(c.nbytes for c in self.uncovered())

    def donor_load(self) -> dict[int, int]:
        """Bytes each survivor would send if it donated every shard it
        holds exactly once (an upper bound used for balance sanity)."""
        load: dict[int, int] = {}
        for c in self.covers:
            for r in c.donors:
                load[r] = load.get(r, 0) + c.nbytes
        return load


# ---------------------------------------------------------------------------
# Donor balancing
# ---------------------------------------------------------------------------


def balance_donors(plan: TransferPlan, specs: Iterable[TensorSpec], survivors: frozenset[int]) -> TransferPlan:
    """Spread remote cells across surviving replicas, least-loaded first.

    The planner's per-cell policy is donor-oblivious; after a fail-stop the
    surviving replica groups shrink and a single donor can end up sourcing
    most of the stream. This pass reassigns each remote cell (largest
    first) to the surviving candidate with the least bytes already
    assigned, recomputing the source offset from the chosen donor's view.
    Resident/local cells are left alone.
    """
    by_name = {s.name: s for s in specs}
    load: dict[int, int] = {r: 0 for r in survivors}
    remote = [t for t in plan.tasks if t.kind == "remote"]
    out: list[TransferTask] = [t for t in plan.tasks if t.kind != "remote"]
    for t in sorted(remote, key=lambda t: -t.nbytes):
        spec = by_name.get(t.tensor)
        if spec is None:
            out.append(t)
            load[t.src_rank] = load.get(t.src_rank, 0) + t.nbytes
            continue
        cands = [r for r in replica_candidates(spec, plan.cfg_src, t.bounds) if r in survivors]
        if not cands:
            out.append(t)
            continue
        src = min(cands, key=lambda r: (load.get(r, 0), r))
        if src != t.src_rank:
            v_src = view_of(spec, plan.cfg_src, src)
            assert v_src is not None
            t = dataclasses.replace(
                t, src_rank=src, src_offset=tuple(b[0] - v[0] for b, v in zip(t.bounds, v_src.bounds))
            )
        load[src] = load.get(src, 0) + t.nbytes
        out.append(t)
    return TransferPlan(tasks=out, cfg_src=plan.cfg_src, cfg_dst=plan.cfg_dst)


# ---------------------------------------------------------------------------
# Spare-shard / erasure scheme
# ---------------------------------------------------------------------------


def _shard_groups(spec: TensorSpec, cfg: ParallelConfig) -> list[tuple[tuple[tuple[int, int], ...], list[int]]]:
    """Distinct shard images of ``spec`` under ``cfg``: (bounds, owners).

    Parity is computed over *distinct* images, one per replica group:
    XOR-ing identical replicas would cancel them out of the parity word.
    Deterministic order (sorted by bounds) so refresh and repair agree.
    """
    groups: dict[tuple, list[int]] = {}
    for r in range(cfg.world_size):
        v = view_of(spec, cfg, r)
        if v is None or v.size == 0:
            continue
        groups.setdefault(v.bounds, []).append(r)
    return sorted(groups.items())


def _nbytes(spec: TensorSpec, bounds) -> int:
    return math.prod(hi - lo for lo, hi in bounds) * itemsize(spec.dtype)


def _shard_bytes(arr: torch.Tensor, bounds: tuple[tuple[int, int], ...]) -> torch.Tensor:
    """A shard's bytes as a flat ``uint8`` tensor on ``arr``'s device (a
    view of ``arr`` where the slice is contiguous, a copy elsewhere)."""
    sl = tuple(slice(lo, hi) for lo, hi in bounds)
    return arr[sl].contiguous().reshape(-1).view(torch.uint8)


class ParityStore:
    """Periodic XOR parity over the distinct shard images of each tensor.

    ``refresh(named, step)`` snapshots one parity word per tensor (the
    byte-XOR of every distinct shard image, zero-padded to the largest) at
    an idle step boundary, into host memory (pinned for a state on the
    card; the buffers are kept and reused by the next refresh). When an
    entire replica group dies its image is reconstructible as
    ``parity XOR (surviving groups)``.

    Parity is a consistent cut: repair is only valid when the snapshot
    step equals the step the survivors are at (``covers(step)``), because
    reconstruction mixes the stored word with the survivors' *live* bytes.
    ``last_refresh_s`` and ``refreshed_bytes`` describe the last refresh.
    """

    def __init__(self, specs: Iterable[TensorSpec], cfg: ParallelConfig):
        self.specs = {s.name: s for s in specs}
        self.cfg = cfg
        self.step: Optional[int] = None
        self._groups = {name: _shard_groups(s, cfg) for name, s in self.specs.items()}
        self._width = {
            name: max((_nbytes(self.specs[name], b) for b, _ in g), default=0) for name, g in self._groups.items()
        }
        self._parity: dict[str, torch.Tensor] = {}
        self.last_refresh_s = 0.0
        self.refreshed_bytes = 0

    def covers(self, step: int) -> bool:
        return self.step == step and bool(self._parity)

    def refresh(self, named: dict[str, torch.Tensor], step: int) -> int:
        """Rebuild every parity word from the live state at ``step``."""
        t0 = time.perf_counter()
        self.step = None  # the words are rewritten in place below
        names = [n for n in self.specs if n in named]
        if not names:
            self._parity = {}
            return 0
        device = named[names[0]].device
        # one device scratch for every tensor: the copies out of it and
        # the XORs into it are ordered on one stream
        scratch = torch.empty(max(self._width[n] for n in names), dtype=torch.uint8, device=device)
        parity: dict[str, torch.Tensor] = {}
        total = 0
        for name in names:
            arr = named[name]
            width = self._width[name]
            # one group (a fully replicated or unsplit tensor) degenerates
            # to a full spare copy: still the only redundancy such state has
            word = scratch[:width].zero_()
            for bounds, _owners in self._groups[name]:
                img = _shard_bytes(arr, bounds)
                word[: img.numel()].bitwise_xor_(img)
            host = self._parity.get(name)
            if host is None or host.numel() != width:
                host = torch.empty(width, dtype=torch.uint8, pin_memory=device.type == "cuda")
            host.copy_(word, non_blocking=True)
            parity[name] = host
            total += width
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        self._parity = parity
        self.step = step
        self.refreshed_bytes = total
        self.last_refresh_s = time.perf_counter() - t0
        return total

    def dead_groups(self, lost_ranks: frozenset[int]) -> list[tuple[str, tuple[tuple[int, int], ...], list[int]]]:
        """(tensor, bounds, owners) of every group wholly inside the loss."""
        out = []
        for name in self.specs:
            for bounds, owners in self._groups[name]:
                if all(r in lost_ranks for r in owners):
                    out.append((name, bounds, owners))
        return out

    def repair(
        self, named: dict[str, torch.Tensor], lost_ranks: frozenset[int], step: int
    ) -> tuple[dict[str, torch.Tensor], int]:
        """Reconstruct every dead group's image and write it into the dead
        region of its live tensor in ``named``, in place.

        Returns (``named``, repaired bytes). Raises :class:`RecoveryError`,
        before anything is written, when parity is stale, more than one
        group of the same tensor died (single-parity-word erasure limit),
        or a group the reconstruction needs died too.
        """
        by_tensor = self._dead_by_tensor(lost_ranks, step)
        for name in by_tensor:
            if named.get(name) is None:
                raise RecoveryError(f"{name}: no live leaf to repair into")
        repaired = 0
        for name, [bounds] in by_tensor.items():
            spec, arr = self.specs[name], named[name]
            word = self._parity[name].to(arr.device, non_blocking=True, copy=True)
            for g_bounds, _ in self._groups[name]:
                if g_bounds != bounds:
                    img = _shard_bytes(arr, g_bounds)
                    word[: img.numel()].bitwise_xor_(img)
            shape = tuple(hi - lo for lo, hi in bounds)
            nbytes = _nbytes(spec, bounds)
            sl = tuple(slice(lo, hi) for lo, hi in bounds)
            arr[sl].copy_(word[:nbytes].view(getattr(torch, spec.dtype)).reshape(shape))
            repaired += nbytes
        for device in {x.device for x in named.values() if x.device.type == "cuda"}:
            torch.cuda.current_stream(device).synchronize()  # the bytes are in place on return
        return named, repaired


    def _dead_by_tensor(self, lost_ranks: frozenset[int], step: int) -> dict[str, list]:
        """The dead group's bounds by tensor, once every condition of a
        repair holds; else :class:`RecoveryError`."""
        if not self.covers(step):
            raise RecoveryError(
                f"parity snapshot at step {self.step} cannot repair state at step {step}: stale or never refreshed"
            )
        by_tensor: dict[str, list] = {}
        for name, bounds, owners in self.dead_groups(lost_ranks):
            by_tensor.setdefault(name, []).append(bounds)
        for name, dead in by_tensor.items():
            if len(dead) > 1:
                raise RecoveryError(
                    f"{name}: {len(dead)} shard groups lost at once; single XOR parity can reconstruct at most one"
                )
            for g_bounds, g_owners in self._groups[name]:
                if g_bounds != dead[0] and all(r in lost_ranks for r in g_owners):
                    raise RecoveryError(f"{name}: surviving group needed for parity repair also died")
        return by_tensor


def healed_owner(spec: TensorSpec, cfg: ParallelConfig, bounds) -> int:
    """The rank :func:`heal_plan` sources a lost cell of ``bounds`` from."""
    for r in replica_candidates(spec, cfg, bounds):
        if view_of(spec, cfg, r) is not None:
            return r
    raise RecoveryError(f"{spec.name}: lost cell has no owner view")


class RankParityStore(ParityStore):
    """:class:`ParityStore` over a per-rank world, seen from process
    ``pool.rank`` (the module docstring): ``named`` holds this rank's
    shards only. ``refresh`` and ``repair`` are collective over the pool:
    every rank calls them at the same step. ``word`` is the whole word in
    host memory, each tensor's a slice of it (``_parity``); ``device`` is
    where a repaired shard is put."""

    def __init__(self, specs: Iterable[TensorSpec], cfg: ParallelConfig, pool, device):
        super().__init__(specs, cfg)
        self.pool = pool
        self.rank = pool.rank
        self.device = torch.device(device)
        self._offset: dict[str, int] = {}
        total = 0
        for name in self.specs:
            self._offset[name] = total
            total += self._width[name]
        self.word = torch.empty(total, dtype=torch.uint8, pin_memory=self.device.type == "cuda")

    def _slice(self, name: str) -> torch.Tensor:
        return self.word[self._offset[name]: self._offset[name] + self._width[name]]

    def refresh(self, named: dict[str, torch.Tensor], step: int) -> int:
        """Rebuild the word from every rank's shards at ``step``."""
        t0 = time.perf_counter()
        self.step = None
        self.word.zero_()
        for name in self.specs:
            for _bounds, owners in self._groups[name]:
                if owners[0] == self.rank:  # this rank's own view is the image
                    img = named[name].reshape(-1).view(torch.uint8)
                    self._slice(name)[: img.numel()].copy_(img)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.pool.xor_reduce(self.word)
        self._parity = {name: self._slice(name) for name in self.specs}
        self.step = step
        self.refreshed_bytes = self.word.numel()
        self.last_refresh_s = time.perf_counter() - t0
        return self.refreshed_bytes

    def repair(
        self, named: dict[str, torch.Tensor], lost_ranks: frozenset[int], step: int
    ) -> tuple[dict[str, torch.Tensor], int]:
        """Reconstruct every dead group's image on its healed owner
        (:func:`healed_owner`), into ``named`` there as a new tensor (or
        into the rank's own, where it still holds one). Returns (``named``,
        repaired bytes, the same on every rank); raises as
        :meth:`ParityStore.repair`, on every rank, before anything moves."""
        by_tensor = self._dead_by_tensor(lost_ranks, step)
        survivors = [r for r in range(self.cfg.world_size) if r not in lost_ranks]
        repaired = 0
        for name in self.specs:
            if name not in by_tensor:
                continue
            [bounds] = by_tensor[name]
            spec = self.specs[name]
            owner = healed_owner(spec, self.cfg, bounds)
            buf = torch.zeros(self._width[name], dtype=torch.uint8)
            if self.rank == survivors[0]:
                buf.bitwise_xor_(self._parity[name])
            for g_bounds, g_owners in self._groups[name]:
                if g_bounds != bounds and min(r for r in g_owners if r not in lost_ranks) == self.rank:
                    img = named[name].reshape(-1).view(torch.uint8)
                    buf[: img.numel()].bitwise_xor_(img.cpu())
            self.pool.xor_reduce(buf, dst=owner)
            nbytes = _nbytes(spec, bounds)
            if self.rank == owner:
                shape = tuple(hi - lo for lo, hi in bounds)
                img = buf[:nbytes].view(getattr(torch, spec.dtype)).reshape(shape)
                if named.get(name) is not None:
                    named[name].copy_(img)
                else:
                    named[name] = img.to(self.device, copy=True)
            repaired += nbytes
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return named, repaired


def heal_plan(plan: TransferPlan, specs: Iterable[TensorSpec]) -> tuple[TransferPlan, int]:
    """Rewrite ``lost`` cells as executable remote cells after parity repair.

    Once :meth:`ParityStore.repair` has written the reconstructed bytes
    back into the (global) source tensors, each lost cell can stream like
    any other remote cell; it is sourced from the original owner rank: the
    bytes are byte-identical to what that rank held, they just arrived via
    the parity word. Returns (healed plan, parity-sourced bytes).
    """
    by_name = {s.name: s for s in specs}
    healed: list[TransferTask] = []
    parity_bytes = 0
    for t in plan.tasks:
        if t.kind != "lost":
            healed.append(t)
            continue
        spec = by_name[t.tensor]
        r = healed_owner(spec, plan.cfg_src, t.bounds)
        v = view_of(spec, plan.cfg_src, r)
        healed.append(dataclasses.replace(
            t, kind="remote", src_rank=r, src_offset=tuple(b[0] - vb[0] for b, vb in zip(t.bounds, v.bounds))
        ))
        parity_bytes += t.nbytes
    return TransferPlan(tasks=healed, cfg_src=plan.cfg_src, cfg_dst=plan.cfg_dst), parity_bytes
