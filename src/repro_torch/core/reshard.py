"""Live-path resharder over torch tensors (paper §4.6.2 on the live worlds).

:func:`live_reshard_planned` executes an intersection plan (from
``core/intersection.py``) through the shared
:class:`~repro_torch.reshard.engine.ReshardEngine` and the
:class:`~repro_torch.reshard.executors.LiveExecutor`: the same protocol code
the simulated-rank oracle runs, so chunking, staging bounds and byte
accounting cannot diverge between the two paths.
:func:`plan_state_transfer`, :func:`named_state_leaves` and
:func:`rebuild_state` name the training state (params and Adam moments) as
the plan does.

:func:`live_reshard` is the plan-less path (checkpoint resume, ad-hoc
moves, the state outside the resource view such as the step count): each
leaf that is not on its target device is one task of a synthetic plan, one
streaming layer a leaf, run by the same engine and executor, so a leaf
larger than the staging budget is chunked by the shared chunker. The port's
counterpart of a leaf's sharding is its device: on one card every leaf is
already there and passes through untouched (the JAX delta no-op).
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.intersection import TransferPlan, TransferTask, plan_transfer
from repro_torch.core.resource_view import TensorSpec, build_tensor_specs, dtype_name
from repro_torch.reshard.engine import DEFAULT_STAGING_BYTES, ReshardEngine, StreamStats
from repro_torch.reshard.executors import LiveExecutor
from repro_torch.utils.pytree import tree_from_paths, tree_paths

__all__ = [
    "DEFAULT_STAGING_BYTES",
    "ReshardReport",
    "live_reshard",
    "live_reshard_planned",
    "named_state_leaves",
    "plan_state_transfer",
    "rebuild_state",
]


@dataclass
class ReshardReport:
    leaves: int = 0
    chunked_leaves: int = 0
    moved_bytes: int = 0
    seconds: float = 0.0
    max_inflight_bytes: int = 0
    stats: Optional[StreamStats] = None


def _on(device: torch.device, target) -> bool:
    """``device`` is ``target`` (a bare ``cuda`` names the current card)."""
    target = torch.device(target)
    if target.type == "cuda" and target.index is None:
        target = torch.device("cuda", torch.cuda.current_device())
    return device == target


class _DonatingExecutor(LiveExecutor):
    """Releases a donated source's storage once its last layer has been
    dispatched (the JAX package deletes the donated buffers). On the card
    the caching allocator hands the memory out again only to work queued
    after the copies that read it."""

    def __init__(self, *args, donated: set[str], **kwargs):
        super().__init__(*args, **kwargs)
        self._donated = donated

    def release(self, name: str) -> None:
        if name in self._donated:
            self.src[name].untyped_storage().resize_(0)


def _owns_storage(t: torch.Tensor) -> bool:
    """``t`` is the whole of a storage this process may free."""
    st = t.untyped_storage()
    return st.resizable() and t.storage_offset() == 0 and st.nbytes() == t.numel() * t.element_size()


def live_reshard(
    state: Any,
    target_devices: Any,
    staging_bytes: int = DEFAULT_STAGING_BYTES,
    donate: bool = True,
) -> tuple[Any, ReshardReport]:
    """Move a tree of tensors to the devices ``target_devices`` names (a
    tree with ``state``'s paths, a device a leaf), leaf-streamed.

    Returns (new tree, report). A leaf already on its device passes
    through untouched. A 0-d or one-element leaf elsewhere is copied
    plainly: it has no rows for the row kernels. Every other leaf is a
    one-task streaming layer of a synthetic plan, run by the shared engine
    and ``LiveExecutor`` (``pack_rows`` into staging, ``scatter_rows``
    into the new tensor), chunked to the staging budget. With
    ``donate=True`` (default) each moved leaf that owns its storage, and
    shares it with no other leaf, has that storage released as soon as its
    layer is dispatched, so the peak stays ~1x state + staging; the caller
    must not touch the input tree again. ``donate=False`` keeps the
    sources intact."""
    flat = tree_paths(state)
    targets = tree_paths(target_devices)
    report = ReshardReport()
    t0 = time.perf_counter()
    shared = Counter(x.untyped_storage().data_ptr() for x in flat.values())
    out: dict[str, torch.Tensor] = {}
    groups: dict[torch.device, dict[str, tuple[str, torch.Tensor]]] = {}
    for i, (path, leaf) in enumerate(flat.items()):
        report.leaves += 1
        dst = torch.device(targets[path])
        if _on(leaf.device, dst):
            out[path] = leaf  # the delta no-op
            continue
        if leaf.numel() <= 1:
            out[path] = leaf.to(dst, copy=True)
            report.moved_bytes += leaf.numel() * leaf.element_size()
            continue
        groups.setdefault(dst, {})[f"leaf{i}"] = (path, leaf)

    for dst, leaves in groups.items():
        specs, tasks = {}, []
        for layer, (name, (_, leaf)) in enumerate(leaves.items()):
            shape = tuple(int(d) for d in leaf.shape)
            nbytes = leaf.numel() * leaf.element_size()
            specs[name] = TensorSpec(
                name=name, shape=shape, dtype=dtype_name(leaf.dtype), roles=("none",) * len(shape),
                stage_scope="all", collection="state",
            )
            # src 0 -> dst 1: fictitious ranks; "remote" runs the chunked
            # staging path
            tasks.append(TransferTask(
                tensor=name, collection="state", src_rank=0, dst_rank=1, bounds=tuple((0, d) for d in shape),
                src_offset=(0,) * len(shape), dst_offset=(0,) * len(shape), nbytes=nbytes, layer=layer,
            ))
            if nbytes > staging_bytes and shape[0] > 1:
                report.chunked_leaves += 1
        src = {name: leaf for name, (_, leaf) in leaves.items()}
        donated = {
            name for name, x in src.items()
            if donate and _owns_storage(x) and shared[x.untyped_storage().data_ptr()] == 1
        }
        executor = _DonatingExecutor(
            specs, src, [next(iter(src.values())).device], [dst], staging_bytes, donated=donated,
        )
        del src
        stats = ReshardEngine(TransferPlan(tasks=tasks, cfg_src=None, cfg_dst=None), executor,
                              staging_bytes=staging_bytes).run()
        t1 = time.perf_counter()
        executor.block_until_ready()
        stats.drain_seconds += time.perf_counter() - t1
        for name, (path, _) in leaves.items():
            out[path] = executor.results()[name]
        report.moved_bytes += stats.network_bytes + stats.local_bytes
        report.max_inflight_bytes = max(report.max_inflight_bytes, stats.peak_staging_bytes)
        if report.stats is None:
            report.stats = stats
        else:
            report.stats.merge(stats)

    report.seconds = time.perf_counter() - t0
    return tree_from_paths({p: out[p] for p in flat}), report


def plan_state_transfer(
    cfg: ModelConfig,
    cfg_src: ParallelConfig,
    cfg_dst: ParallelConfig,
    source_policy: str = "nearest",
    allowed_src=None,
) -> tuple[list[TensorSpec], TransferPlan]:
    """Specs + intersection plan for the live training state (params, mu,
    nu). ``zero_sharding=False``: moments are laid out like their params,
    so the plan's bytes are what moves."""
    from repro_torch.models.transformer import block_program

    specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
    plan = plan_transfer(
        specs,
        cfg_src,
        cfg_dst,
        source_policy=source_policy,
        layer_granular=True,
        num_positions=len(block_program(cfg)),
        allowed_src=allowed_src,
    )
    return specs, plan


def named_state_leaves(params: dict, opt_state: dict) -> tuple[dict[str, torch.Tensor], dict]:
    """Flatten live training state into the resource view's tensor names:
    (``params/...``, ``mu/...``, ``nu/...`` leaves, leftovers such as the
    step count)."""
    named: dict[str, torch.Tensor] = {f"params/{p}": x for p, x in tree_paths(params).items()}
    extras: dict = {}
    for coll, sub in opt_state.items():
        if coll in ("mu", "nu"):
            named.update({f"{coll}/{p}": x for p, x in tree_paths(sub).items()})
        else:
            extras[coll] = sub
    return named, extras


def rebuild_state(named: dict[str, torch.Tensor], params_like: dict, opt_like: dict, extras: dict) -> tuple[dict, dict]:
    """Inverse of :func:`named_state_leaves`."""
    params = tree_from_paths({p: named[f"params/{p}"] for p in tree_paths(params_like)})
    opt: dict = {}
    for coll, sub in opt_like.items():
        if coll in ("mu", "nu"):
            opt[coll] = tree_from_paths({p: named[f"{coll}/{p}"] for p in tree_paths(sub)})
        else:
            opt[coll] = extras[coll]
    return params, opt


def live_reshard_planned(
    specs: list[TensorSpec],
    plan: TransferPlan,
    named_leaves: dict[str, torch.Tensor],
    src_devices: list,
    dst_devices: list,
    staging_bytes: int = DEFAULT_STAGING_BYTES,
    layers: Optional[list[int]] = None,
    wire_policy=None,
    dst_buffers: Optional[dict[str, torch.Tensor]] = None,
) -> tuple[dict[str, torch.Tensor], StreamStats]:
    """Execute an intersection plan on live tensors via the shared engine,
    from the world on ``src_devices`` to the world on ``dst_devices`` (rank
    -> device lists), under ``wire_policy`` (None = lossless), into
    ``dst_buffers`` where given. Returns (destination tensors by name,
    stats); the destinations are complete when it returns."""
    spec_map = {s.name: s for s in specs}
    executor = LiveExecutor(
        spec_map, named_leaves, src_devices, dst_devices, staging_bytes, wire_policy=wire_policy,
        dst_buffers=dst_buffers,
    )
    engine = ReshardEngine(plan, executor, staging_bytes=staging_bytes, wire_policy=wire_policy)
    stats = engine.run(layers)
    t1 = time.perf_counter()
    executor.block_until_ready()
    stats.drain_seconds += time.perf_counter() - t1
    return executor.results(), stats
