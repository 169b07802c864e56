"""Intersection-based transfer planning (paper §4.6.1, App. A.2.2).

For every (tensor, destination-rank) pair the planner cuts the destination
view by the source configuration's split points, producing grid *cells*;
each cell lies inside exactly one source view per replica group, so choosing
one replica yields a TransferTask with exact byte ranges. By construction the
cells tile every destination view exactly once — completeness (Eq. 1) and
exactly-once coverage hold structurally (and are property-tested).

Planning touches only sharding metadata — never tensor data — and runs on
CPU (the paper reports <1 s for 175B/96L/1024 ranks; see
benchmarks/bench_plan.py for ours).

Source-selection policies (the paper picks an arbitrary replica; the latter
two are this repo's beyond-paper extensions, see DESIGN.md §8):
  "first"    — lowest-rank replica (paper-faithful baseline)
  "balanced" — deterministic hash spreading source fan-out across replicas
  "nearest"  — prefer src == dst rank (zero-copy), then same-coordinate
               replicas (same node/pod under block device layouts), then
               balanced
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.resource_view import (
    TensorSpec,
    View,
    _role_factor_idx,
    itemsize,
    split_bounds,
    split_points,
    view_of,
)

_POS_RE = re.compile(r"/pos(\d+)/")


@dataclass(frozen=True)
class TransferTask:
    tensor: str
    collection: str
    src_rank: int
    dst_rank: int
    bounds: tuple[tuple[int, int], ...]  # global coords of the moved region
    src_offset: tuple[int, ...]  # region origin within the source shard
    dst_offset: tuple[int, ...]  # region origin within the destination shard
    nbytes: int
    layer: int  # streaming group (global layer id; -1 = non-layer state)
    # cell class (DESIGN.md §13, §15):
    #   "resident" — src shard == dst shard on the same device: a no-op
    #   "local"    — same device, different layout: on-device relayout
    #   "remote"   — genuine cross-device transfer
    #   "lost"     — no allowed source rank holds this cell (survivor-
    #                constrained planning, DESIGN.md §15); src_rank == -1
    #                and the cell must be repaired (parity) or the plan
    #                abandoned before execution.
    # The default keeps hand-built synthetic tasks (plan-less live_reshard,
    # test fixtures) on the conservative full-transfer path.
    kind: str = "remote"

    @property
    def local(self) -> bool:
        return self.src_rank == self.dst_rank

    @property
    def resident(self) -> bool:
        return self.kind == "resident"

    def shape(self) -> tuple[int, ...]:
        return tuple(h - l for l, h in self.bounds)


@dataclass
class TransferPlan:
    tasks: list[TransferTask]
    cfg_src: ParallelConfig
    cfg_dst: ParallelConfig

    @property
    def network_bytes(self) -> int:
        return sum(t.nbytes for t in self.tasks if t.kind == "remote")

    @property
    def local_bytes(self) -> int:
        """On-device relayout bytes — excludes resident (in-place) cells."""
        return sum(t.nbytes for t in self.tasks if t.kind == "local")

    @property
    def resident_bytes(self) -> int:
        """Bytes already in place on the right device: never moved."""
        return sum(t.nbytes for t in self.tasks if t.kind == "resident")

    @property
    def lost_bytes(self) -> int:
        """Bytes with no surviving source under ``allowed_src`` planning."""
        return sum(t.nbytes for t in self.tasks if t.kind == "lost")

    def lost_tasks(self) -> list[TransferTask]:
        return [t for t in self.tasks if t.kind == "lost"]

    def kind_bytes(self) -> dict[str, int]:
        out = {"resident": 0, "local": 0, "remote": 0}
        for t in self.tasks:
            out[t.kind] = out.get(t.kind, 0) + t.nbytes
        return out

    def layers(self) -> list[int]:
        return sorted({t.layer for t in self.tasks})

    def resident_layers(self) -> list[int]:
        """Layers whose every cell is resident: nothing to stream at all."""
        moved = {t.layer for t in self.tasks if t.kind != "resident"}
        return sorted({t.layer for t in self.tasks} - moved)

    def by_layer(self, layer: int) -> list[TransferTask]:
        return [t for t in self.tasks if t.layer == layer]

    def per_rank_bytes(self) -> tuple[dict[int, int], dict[int, int]]:
        """(bytes sent per src rank, bytes received per dst rank) — network only."""
        tx: dict[int, int] = {}
        rx: dict[int, int] = {}
        for t in self.tasks:
            if t.local:
                continue
            tx[t.src_rank] = tx.get(t.src_rank, 0) + t.nbytes
            rx[t.dst_rank] = rx.get(t.dst_rank, 0) + t.nbytes
        return tx, rx


# ---------------------------------------------------------------------------


def _src_cuts_for_dim(
    spec: TensorSpec, dim: int, cfg_src: ParallelConfig
) -> list[int]:
    role = spec.roles[dim]
    parts = {"pp": cfg_src.pp, "tp": cfg_src.tp, "ep": cfg_src.ep, "dp": cfg_src.dp,
             "none": 1}[role]
    return split_points(spec.shape[dim], parts)


def _segments(lo: int, hi: int, cuts: list[int]) -> list[tuple[int, int]]:
    """Split [lo, hi) at the given sorted cut points (non-empty segments)."""
    pts = [lo] + [c for c in cuts if lo < c < hi] + [hi]
    return [
        (pts[i], pts[i + 1]) for i in range(len(pts) - 1) if pts[i + 1] > pts[i]
    ]


def _src_index_for(
    spec: TensorSpec, dim: int, cfg_src: ParallelConfig, lo: int
) -> int:
    cuts = _src_cuts_for_dim(spec, dim, cfg_src)
    return bisect.bisect_right(cuts, lo) - 1


def _itemsize(dtype: str) -> int:
    return itemsize(dtype)


def _layer_id(
    spec: TensorSpec, cell_lo: int, num_positions: int
) -> int:
    """Global layer id of a unit stacked-axis slice starting at cell_lo."""
    m = _POS_RE.search(spec.name)
    j = int(m.group(1)) if m else 0
    return cell_lo * num_positions + j


def replica_candidates(
    spec: TensorSpec,
    cfg_src: ParallelConfig,
    bounds: tuple[tuple[int, int], ...],
) -> list[int]:
    """All source ranks whose view contains ``bounds`` (replica group).

    The roled dims of the cell fix one coordinate per parallel factor; the
    remaining (free) factors enumerate the replicas. This is the geometry
    ``_emit_cell`` uses to choose a source, exposed for the redundancy map
    (DESIGN.md §15): restricting this list to survivors tells recovery who
    can donate the cell.
    """
    fixed: dict[str, int] = {}
    for d, role in enumerate(spec.roles):
        if role == "none":
            continue
        fixed[role] = _src_index_for(spec, d, cfg_src, bounds[d][0])
    if spec.stage_scope == "first":
        fixed["pp"] = 0
    elif spec.stage_scope == "last":
        fixed["pp"] = cfg_src.pp - 1
    dp_r = [fixed["dp"]] if "dp" in fixed else range(cfg_src.dp)
    pp_r = [fixed["pp"]] if "pp" in fixed else range(cfg_src.pp)
    ep_r = [fixed["ep"]] if "ep" in fixed else range(cfg_src.ep)
    tp_r = [fixed["tp"]] if "tp" in fixed else range(cfg_src.tp)
    return [
        cfg_src.coords_rank(di, pi, ei, ti)
        for di in dp_r
        for pi in pp_r
        for ei in ep_r
        for ti in tp_r
    ]


def _pick_source(
    policy: str,
    candidates: list[int],
    dst_rank: int,
    cell_key: int,
    dst_coords: tuple[int, int, int, int],
    cfg_src: ParallelConfig,
) -> int:
    if len(candidates) == 1:
        return candidates[0]
    if policy == "first":
        return candidates[0]
    if policy == "nearest":
        if dst_rank in candidates:
            return dst_rank
        # same dp coordinate (same "node group" under blocked layouts)
        dp_i = dst_coords[0]
        same_dp = [r for r in candidates if cfg_src.rank_coords(r)[0] == dp_i]
        if same_dp:
            return same_dp[(cell_key + dst_rank) % len(same_dp)]
    # balanced
    return candidates[(cell_key * 1000003 + dst_rank) % len(candidates)]


def plan_transfer(
    specs: Iterable[TensorSpec],
    cfg_src: ParallelConfig,
    cfg_dst: ParallelConfig,
    source_policy: str = "nearest",
    layer_granular: bool = True,
    num_positions: int = 1,
    allowed_src: Optional[frozenset[int]] = None,
) -> TransferPlan:
    """Compute the full transfer plan between two configurations.

    layer_granular: additionally cut the stacked-layers dim into unit slices
    so execution can stream one *model layer* at a time (Algorithm 1);
    ``num_positions`` is the block-program period (for global layer ids).

    allowed_src: survivor-constrained planning (DESIGN.md §15) — only these
    source ranks may donate a cell. Cells whose whole replica group fell
    outside the set come back as ``kind == "lost"`` with ``src_rank == -1``;
    the caller must repair them (parity) or abandon the plan.
    """
    tasks: list[TransferTask] = []
    for spec in specs:
        itemsize = _itemsize(spec.dtype)
        ldim = spec.layer_dim()
        for dst_rank in range(cfg_dst.world_size):
            v_dst = view_of(spec, cfg_dst, dst_rank)
            if v_dst is None or v_dst.size == 0:
                # empty balanced-split remainder (dim smaller than factor)
                continue
            dst_coords = cfg_dst.rank_coords(dst_rank)
            # per-dim segments of the dst view cut by src split points
            per_dim: list[list[tuple[int, int]]] = []
            for d, (lo, hi) in enumerate(v_dst.bounds):
                cuts = _src_cuts_for_dim(spec, d, cfg_src)
                if layer_granular and d == ldim:
                    cuts = list(range(spec.shape[d] + 1))  # unit slices
                per_dim.append(_segments(lo, hi, cuts))
            # cartesian product of segments -> cells
            def rec(d: int, bounds: list[tuple[int, int]]):
                if d == len(per_dim):
                    _emit_cell(
                        tasks,
                        spec,
                        tuple(bounds),
                        cfg_src,
                        cfg_dst,
                        dst_rank,
                        dst_coords,
                        v_dst,
                        itemsize,
                        source_policy,
                        num_positions,
                        ldim,
                        allowed_src,
                    )
                    return
                for seg in per_dim[d]:
                    bounds.append(seg)
                    rec(d + 1, bounds)
                    bounds.pop()

            rec(0, [])
    return TransferPlan(tasks=tasks, cfg_src=cfg_src, cfg_dst=cfg_dst)


def _emit_cell(
    tasks: list[TransferTask],
    spec: TensorSpec,
    bounds: tuple[tuple[int, int], ...],
    cfg_src: ParallelConfig,
    cfg_dst: ParallelConfig,
    dst_rank: int,
    dst_coords: tuple[int, int, int, int],
    v_dst: View,
    itemsize: int,
    policy: str,
    num_positions: int,
    ldim: Optional[int],
    allowed_src: Optional[frozenset[int]] = None,
) -> None:
    candidates = replica_candidates(spec, cfg_src, bounds)
    nbytes = itemsize
    for lo, hi in bounds:
        nbytes *= hi - lo
    layer = -1
    if ldim is not None:
        layer = _layer_id(spec, bounds[ldim][0], num_positions)
    if allowed_src is not None:
        candidates = [r for r in candidates if r in allowed_src]
        if not candidates:
            # whole replica group died: record the hole, let recovery decide
            tasks.append(
                TransferTask(
                    tensor=spec.name,
                    collection=spec.collection,
                    src_rank=-1,
                    dst_rank=dst_rank,
                    bounds=bounds,
                    src_offset=tuple(0 for _ in bounds),
                    dst_offset=tuple(
                        b[0] - v[0] for b, v in zip(bounds, v_dst.bounds)
                    ),
                    nbytes=nbytes,
                    layer=layer,
                    kind="lost",
                )
            )
            return
    cell_key = hash(bounds) & 0x7FFFFFFF
    src_rank = _pick_source(policy, candidates, dst_rank, cell_key, dst_coords, cfg_src)
    v_src = view_of(spec, cfg_src, src_rank)
    assert v_src is not None
    # Classification (DESIGN.md §13). Under the prefix device allocation rank
    # r maps to devices[r] in both configs, so src_rank == dst_rank means the
    # same physical device. "resident" additionally requires the whole shard
    # view to be identical — then the cell's bytes sit at the same place in
    # the same buffer layout and nothing needs to happen.
    if src_rank != dst_rank:
        kind = "remote"
    elif v_src.bounds == v_dst.bounds:
        kind = "resident"
    else:
        kind = "local"
    tasks.append(
        TransferTask(
            tensor=spec.name,
            collection=spec.collection,
            src_rank=src_rank,
            dst_rank=dst_rank,
            bounds=bounds,
            src_offset=tuple(b[0] - v[0] for b, v in zip(bounds, v_src.bounds)),
            dst_offset=tuple(b[0] - v[0] for b, v in zip(bounds, v_dst.bounds)),
            nbytes=nbytes,
            layer=layer,
            kind=kind,
        )
    )


# ---------------------------------------------------------------------------
# Verification helpers (used by tests and by the executor's paranoia mode)
# ---------------------------------------------------------------------------


def verify_completeness(
    specs: Iterable[TensorSpec],
    plan: TransferPlan,
    cfg_dst: ParallelConfig,
) -> None:
    """Every destination view must be tiled exactly once (Eq. 1)."""
    by_key: dict[tuple[str, int], list[TransferTask]] = {}
    for t in plan.tasks:
        by_key.setdefault((t.tensor, t.dst_rank), []).append(t)
    for spec in specs:
        for r in range(cfg_dst.world_size):
            v = view_of(spec, cfg_dst, r)
            tasks = by_key.get((spec.name, r), [])
            if v is None:
                assert not tasks, f"{spec.name}: tasks for non-owning rank {r}"
                continue
            covered = sum(t.nbytes for t in tasks) // _itemsize(spec.dtype)
            assert covered == v.size, (
                f"{spec.name} dst {r}: covered {covered} != view {v.size}"
            )
            # pairwise disjoint
            for i, a in enumerate(tasks):
                va = View(a.bounds)
                for b in tasks[i + 1 :]:
                    assert va.intersect(View(b.bounds)) is None, (
                        f"overlap in {spec.name} dst {r}"
                    )
