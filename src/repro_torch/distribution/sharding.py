"""Logical-axis -> mesh sharding rules with divisibility-aware fallbacks,
over a mesh described by its axis names and sizes.

The counterpart of ``repro/distribution/sharding.py``, rule for rule. The
production mesh is ``("data","model")`` (one pod) or
``("pod","data","model")`` (two; ``launch/mesh.py``):

- tensor-parallel logical axes (ffn/heads/vocab/...) map to ``model``;
- the embed dim of weight matrices maps to ``data`` (FSDP-style parameter
  sharding);
- the batch dim maps to ``("pod","data")``; parameters are replicated
  across pods.

Elastic meshes add ``pipe`` / ``expert`` axes for PP / EP configurations
(:func:`make_elastic_mesh`). A rule is dropped (the dim replicated) when
sizes do not divide; one mesh axis is never given to two dims of one
tensor.

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of two or more axis names, as ``PartitionSpec`` prints them (it
prints a one-name tuple as the name; the JAX spec drops trailing ``None``
entries, these keep one entry per dim).
:func:`shard_shape` is a shard's shape under a spec. No device and no
process group is involved: the dry run (``launch/dryrun.py``) reads these
rules for its per-chip shapes. The port's worlds do not read them: a
per-rank world holds the planner's views (``core/resource_view.py::
shard_of``), the boxes its reshard plans move cells between, and a
one-process world global tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.mesh import MeshSpec
from repro_torch.utils.pytree import axes_paths, tree_from_paths, tree_paths

Entry = Union[None, str, tuple]
Spec = tuple

# preference-ordered mesh axes per logical axis; first divisible wins
RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "ffn": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "inner": ("model",),
    "ssm_heads": ("model",),
    "expert_in": (),
    "state": (),
    "head_dim": (),
    "conv_k": (),
    "embed": ("data",),  # FSDP param sharding
    "layers": ("pipe",),
    "expert": ("expert", "model"),
}


def _entry(axes) -> Entry:
    """A spec entry of mesh axes: None, the name of one, a tuple of more."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def make_elastic_mesh(parallel: ParallelConfig) -> MeshSpec:
    """The mesh of an arbitrary ParallelConfig: axes (data, pipe, expert,
    model)."""
    return MeshSpec(("data", "pipe", "expert", "model"), (parallel.dp, parallel.pp, parallel.ep, parallel.tp))


def _spec_for_axes(mesh: MeshSpec, logical: tuple[str, ...], shape: tuple[int, ...]) -> Spec:
    used: set[str] = set()
    out: list[Optional[str]] = []
    for d, ax in enumerate(logical):
        assigned = None
        for mesh_ax in RULES.get(ax, ()):
            size = mesh.axis_size(mesh_ax)
            if mesh_ax in mesh.axis_names and mesh_ax not in used and shape[d] % size == 0 and size > 1:
                assigned = mesh_ax
                used.add(mesh_ax)
                break
        out.append(assigned)
    return tuple(out)


def param_shardings(cfg: ModelConfig, mesh: MeshSpec, serving: bool = False) -> dict:
    """A spec tree mirroring the param tree.

    ``serving=True`` drops the FSDP (``embed`` -> ``data``) rule: parameters
    replicate across the data axis so decode steps avoid per-token
    parameter all-gathers."""
    from repro_torch.models.model import abstract_params, param_logical_axes

    flat_axes = axes_paths(param_logical_axes(cfg))
    out = {}
    for path, leaf in tree_paths(abstract_params(cfg)).items():
        axes = flat_axes[path]
        if serving:
            axes = tuple("_noshard" if a == "embed" else a for a in axes)
        out[path] = _spec_for_axes(mesh, axes, tuple(leaf.shape))
    return tree_from_paths(out)


def opt_state_shardings(cfg: ModelConfig, mesh: MeshSpec) -> dict:
    ps = param_shardings(cfg, mesh)
    return {"mu": ps, "nu": ps, "count": ()}


def batch_sharding(mesh: MeshSpec, batch: int, ndim: int = 2) -> Spec:
    """Batch dim over (pod, data), dropping axes that do not divide; the
    other ``ndim - 1`` dims replicated."""
    keep: list[str] = []
    prod = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names and batch % (prod * mesh.axis_size(a)) == 0:
            keep.append(a)
            prod *= mesh.axis_size(a)
    return (_entry(keep),) + (None,) * (ndim - 1)


def activation_sharding(mesh: MeshSpec) -> Spec:
    return (_entry(a for a in ("pod", "data") if a in mesh.axis_names),)


def cache_shardings(cfg: ModelConfig, mesh: MeshSpec, batch: int, max_seq: int) -> dict:
    """Adaptive KV/state-cache specs.

    Cascade per attention cache (np_, b, T, kh, hd):
      batch -> ("pod","data") when divisible;
      kv_heads -> "model" when divisible, else T -> "model"
      (sequence-parallel decode);
      when batch is unshardable (long-context b=1), T also takes "data".
    """
    from repro_torch.models.model import abstract_cache

    md = mesh.axis_size("model")
    batch_axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    b_div = all(batch % mesh.axis_size(a) == 0 for a in batch_axes) and batch >= (
        math.prod(mesh.axis_size(a) for a in batch_axes) or 1
    )
    bspec = _entry(batch_axes) if b_div else None

    def kv_spec(shape) -> Spec:
        np_, b, T, kh, hd = shape
        if kh % md == 0 and md > 1:
            return (None, bspec, None, "model", None)
        seq_axes = ["model"] if md > 1 and T % md == 0 else []
        if not b_div:
            for a in reversed(batch_axes):
                if T % (mesh.axis_size(a) * (math.prod(mesh.axis_size(x) for x in seq_axes) or 1)) == 0:
                    seq_axes.insert(0, a)
        return (None, bspec, _entry(seq_axes), None, None)

    def ssm_spec(shape) -> Spec:
        # ssd: (np_, b, h, p, n) / conv: (np_, b, k, ch)
        if len(shape) == 5:
            hspec = "model" if md > 1 and shape[2] % md == 0 else None
            return (None, bspec, hspec, None, None)
        cspec = "model" if md > 1 and shape[3] % md == 0 else None
        return (None, bspec, None, cspec)

    out = {}
    for path, leaf in tree_paths(abstract_cache(cfg, batch, max_seq)).items():
        shape = tuple(leaf.shape)
        out[path] = kv_spec(shape) if ("/k" in path or "/v" in path) else ssm_spec(shape)
    return tree_from_paths(out)


def _axes_of(entry: Entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, spec: Spec, mesh: MeshSpec) -> tuple[int, ...]:
    """The shape of one shard of a ``shape`` tensor under ``spec``: each dim
    divided by the product of its axes' sizes (a spec may be shorter than
    the shape: the rest replicated). Raises where a dim does not divide."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape} has dims")
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(mesh.axis_size(a) for a in _axes_of(entry))
        if shape[d] % n:
            raise ValueError(f"dim {d} of {shape} does not divide by {n} ({entry})")
        out[d] = shape[d] // n
    return tuple(out)


def shard_bytes(leaf: torch.Tensor, spec: Spec, mesh: MeshSpec) -> int:
    """Bytes of one shard of ``leaf`` (any device; meta does) under ``spec``."""
    return math.prod(shard_shape(leaf.shape, spec, mesh)) * leaf.element_size()
