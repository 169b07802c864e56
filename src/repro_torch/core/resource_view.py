"""Abstract Resource View (paper §4.6.1, App. A.2).

Training state is modeled as *logical tensors* (name, shape, dtype) plus a
sharding specification per parallel configuration — fully decoupled from
physical rank/device assignment. The view function ``V(T, C, r)`` (Def. A.1)
returns the hyper-rectangular index region of tensor ``T`` owned by rank
``r`` under configuration ``C``, or ``None`` when the rank holds no part of
it (e.g. wrong pipeline stage).

Dim roles:
  "pp"   — the stacked-layers axis, split contiguously across pipeline stages
  "tp"   — tensor-parallel split
  "ep"   — expert-parallel split (expert-stacked tensors)
  "dp"   — ZeRO split of optimizer moments across data-parallel ranks
  "none" — unsplit

Tensors without an "ep"/"dp" role are replicated across those mesh factors;
replication is what makes DP scale-out degenerate to a broadcast pattern and
scale-in to a discard (App. A.2.3) — the same geometry handles all of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.utils.pytree import axes_paths, tree_paths

# logical axes eligible for tensor-parallel splitting, in preference order
TP_AXES = (
    "ffn",
    "heads",
    "kv_heads",
    "vocab",
    "inner",
    "expert_in",
    "state",
    "ssm_heads",
    "embed",
)


@dataclass(frozen=True)
class TensorSpec:
    """A logical tensor of the training state."""

    name: str  # param-tree path, e.g. "params/blocks/pos0/mixer/wq"
    shape: tuple[int, ...]
    dtype: str
    roles: tuple[str, ...]  # per-dim role, len == len(shape)
    stage_scope: str = "stages"  # "stages" | "first" | "last" | "all"
    collection: str = "params"  # "params" | "mu" | "nu" | "step"

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * itemsize(self.dtype)

    def layer_dim(self) -> Optional[int]:
        return self.roles.index("pp") if "pp" in self.roles else None


def itemsize(dtype: str) -> int:
    """Bytes per element of a dtype name (``"float32"``, ``"bfloat16"``):
    numpy knows bfloat16 only where ml_dtypes is installed, torch always."""
    return getattr(torch, dtype).itemsize


def dtype_name(dtype) -> str:
    """``"bfloat16"`` for ``torch.bfloat16`` or ``"bfloat16"``: the dtype
    names the specs carry, as the JAX package writes them."""
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Splitting geometry
# ---------------------------------------------------------------------------


def split_bounds(size: int, parts: int, idx: int) -> tuple[int, int]:
    """Balanced contiguous split (equal when divisible)."""
    base, rem = divmod(size, parts)
    lo = idx * base + min(idx, rem)
    hi = lo + base + (1 if idx < rem else 0)
    return lo, hi


def split_points(size: int, parts: int) -> list[int]:
    return [split_bounds(size, parts, i)[0] for i in range(parts)] + [size]


@dataclass(frozen=True)
class View:
    """Hyper-rectangle: per-dim [lo, hi)."""

    bounds: tuple[tuple[int, int], ...]

    def intersect(self, other: "View") -> Optional["View"]:
        out = []
        for (a0, a1), (b0, b1) in zip(self.bounds, other.bounds):
            lo, hi = max(a0, b0), min(a1, b1)
            if lo >= hi:
                return None
            out.append((lo, hi))
        return View(tuple(out))

    @property
    def size(self) -> int:
        return int(math.prod(h - l for l, h in self.bounds))

    def shape(self) -> tuple[int, ...]:
        return tuple(h - l for l, h in self.bounds)


def _role_factor_idx(
    role: str, cfg: ParallelConfig, coords: tuple[int, int, int, int]
) -> tuple[int, int]:
    dp_i, pp_i, ep_i, tp_i = coords
    return {
        "pp": (cfg.pp, pp_i),
        "tp": (cfg.tp, tp_i),
        "ep": (cfg.ep, ep_i),
        "dp": (cfg.dp, dp_i),
        "none": (1, 0),
    }[role]


def view_of(spec: TensorSpec, cfg: ParallelConfig, rank: int) -> Optional[View]:
    """The paper's V(T, C, r)."""
    coords = cfg.rank_coords(rank)
    dp_i, pp_i, ep_i, tp_i = coords
    if spec.stage_scope == "first" and pp_i != 0:
        return None
    if spec.stage_scope == "last" and pp_i != cfg.pp - 1:
        return None
    bounds = []
    for size, role in zip(spec.shape, spec.roles):
        parts, idx = _role_factor_idx(role, cfg, coords)
        bounds.append(split_bounds(size, parts, idx))
    return View(tuple(bounds))


def _box(view: View) -> tuple[slice, ...]:
    return tuple(slice(lo, hi) for lo, hi in view.bounds)


def shard_of(tensor: torch.Tensor, spec: TensorSpec, cfg: ParallelConfig, rank: int) -> Optional[torch.Tensor]:
    """Rank ``rank``'s shard of the whole ``tensor`` under ``cfg``: its
    :func:`view_of` box, a contiguous tensor of its own storage, or None
    where the rank holds no part of it (a stage-scoped leaf on another
    stage). The per-rank worlds hold exactly these boxes of every param,
    ``mu`` and ``nu`` leaf (the specs of ``build_tensor_specs(...,
    zero_sharding=False)``), the views the reshard plan moves cells
    between: cut by pipeline stage, by expert over ep and by tp."""
    if tuple(tensor.shape) != spec.shape:
        raise ValueError(f"{spec.name}: tensor {tuple(tensor.shape)} is not its spec's {spec.shape}")
    view = view_of(spec, cfg, rank)
    if view is None:
        return None
    return tensor[_box(view)].clone(memory_format=torch.contiguous_format)


def assemble(shards: dict[int, torch.Tensor], spec: TensorSpec, cfg: ParallelConfig) -> torch.Tensor:
    """The inverse of :func:`shard_of`: the whole tensor from shards by
    rank, which must cover it (each replica group once at least). A rank
    that holds no part of the tensor has no shard to give."""
    first = next(iter(shards.values()))
    out = torch.empty(spec.shape, dtype=first.dtype, device=first.device)
    boxes = set()
    for rank, shard in shards.items():
        view = view_of(spec, cfg, rank)
        if view is None:
            raise ValueError(f"{spec.name}: rank {rank} of {cfg.describe()} holds no part of it")
        out[_box(view)] = shard
        boxes.add(view.bounds)
    # a config's views are equal (replicas) or disjoint
    if sum(View(b).size for b in boxes) != math.prod(spec.shape):
        raise ValueError(f"{spec.name}: the shards of ranks {sorted(shards)} do not cover the tensor")
    return out


def replica_sources(
    spec: TensorSpec, cfg: ParallelConfig, view: View
) -> list[int]:
    """All ranks of ``cfg`` whose view equals ``view`` (replicas).

    Used by the planner to pick a source among DP (and EP, for non-expert
    tensors) replicas — the topology-aware source-selection hook.
    """
    out = []
    for r in range(cfg.world_size):
        v = view_of(spec, cfg, r)
        if v is not None and v.bounds == view.bounds:
            out.append(r)
    return out


# ---------------------------------------------------------------------------
# Building the resource view of a model + optimizer
# ---------------------------------------------------------------------------


def _pick_tp_dim(axes: tuple[str, ...]) -> Optional[int]:
    for ax_name in TP_AXES:
        for d, a in enumerate(axes):
            if a == ax_name:
                return d
    return None


def _pick_zero_dim(roles: list[str], shape: tuple[int, ...]) -> Optional[int]:
    """Largest unsplit dim (greedy per-tensor ZeRO-1)."""
    best = None
    for d, r in enumerate(roles):
        if r == "none":
            if best is None or shape[d] > shape[best]:
                best = d
    return best


def build_tensor_specs(
    cfg: ModelConfig,
    include_optimizer: bool = True,
    zero_sharding: bool = True,
) -> list[TensorSpec]:
    """Logical tensors of (params [+ AdamW moments]) for ``cfg``.

    Roles are assigned from the model's logical axes only — the spec list is
    valid under ANY ParallelConfig (a role names *which* factor splits a dim;
    the view function applies the factor's degree from the config, with
    balanced splits when not divisible). One description, many
    configurations: the decoupling the Abstract Resource View requires.
    """
    from repro_torch.models.model import abstract_params, param_logical_axes

    params = tree_paths(abstract_params(cfg))
    axes = axes_paths(param_logical_axes(cfg))
    specs: list[TensorSpec] = []
    for path, leaf in params.items():
        ax = axes[path]
        shape = tuple(int(x) for x in leaf.shape)
        roles = ["none"] * len(shape)
        scope = "stages"
        if ax and ax[0] == "layers":
            roles[0] = "pp"
        else:
            # non-layer tensors: embed -> first stage, head/final_norm -> last
            scope = "first" if path.startswith("embed") else "last"
        # expert dim
        for d, a in enumerate(ax):
            if a == "expert" and roles[d] == "none":
                roles[d] = "ep"
        # one tp dim
        free_axes = tuple(
            a if roles[d] == "none" else "_" for d, a in enumerate(ax)
        )
        tp_d = _pick_tp_dim(free_axes)
        if tp_d is not None:
            roles[tp_d] = "tp"
        specs.append(
            TensorSpec(
                name=f"params/{path}",
                shape=shape,
                dtype=dtype_name(leaf.dtype),
                roles=tuple(roles),
                stage_scope=scope,
                collection="params",
            )
        )
        if include_optimizer:
            for coll in ("mu", "nu"):
                oroles = list(roles)
                if zero_sharding:
                    zd = _pick_zero_dim(oroles, shape)
                    if zd is not None:
                        oroles[zd] = "dp"
                specs.append(
                    TensorSpec(
                        name=f"{coll}/{path}",
                        shape=shape,
                        dtype="float32",
                        roles=tuple(oroles),
                        stage_scope=scope,
                        collection=coll,
                    )
                )
    return specs


def layer_of_spec(spec: TensorSpec, period: int) -> int:
    """Coarse layer id for streaming order: stacked tensors stream per
    period-slice; non-layer tensors get layer -1 (embeddings, head)."""
    return -1 if spec.layer_dim() is None else 0


def total_state_bytes(specs: list[TensorSpec]) -> int:
    return sum(s.nbytes for s in specs)
