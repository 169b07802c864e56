"""Live serving reconfiguration controller.

The port of ``repro/serve/controller.py``: Prepare builds (or takes warm
from the shared :class:`WorldPool`) a target serving world in the
background while decode continues on the active world; the commit lands
at a decode-step boundary mid-generation. Params AND the live KV cache
stream through one intersection plan and one ReshardEngine pass, and the
session continues token-for-token on the new world. Retired actives and
abandoned shadow builds are deposited back into the pool.

The JAX controller's API, with ``device=`` in place of its device list:
every rank of every world maps to that one device (the card by default; a
CUDA request without one raises), and ``params=`` (a param tree to serve in
place of the seeded init, e.g. the JAX package's weights through
``models.convert.params_from_jax``). The controller holds the params cast
once to ``cfg.dtype`` (``model.cast_params``), which is what the port
computes with. Enc-dec cross-attention KV is not ported, so ``commit``
takes the cache alone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.records import ReuseRecordMixin
from repro_torch.core.reshard import DEFAULT_STAGING_BYTES, live_reshard_planned
from repro_torch.core.resource_view import dtype_name
from repro_torch.core.shadow import ShadowBuilder, WorldHandle
from repro_torch.core.world_pool import WorldPool
from repro_torch.serve.cache_view import (
    named_serve_leaves,
    rebuild_serve_state,
    serve_plan,
    serve_state_specs,
)
from repro_torch.serve.world import build_serve_world

__all__ = ["LiveServeController", "ServeRecord"]


@dataclass
class ServeRecord(ReuseRecordMixin):
    """One committed serving reconfiguration."""

    gen_id: int
    src: str
    dst: str
    # decode-step index (global token position counter) the cut landed on:
    # requests decoded on the old world up to this step, on the new after
    cut_step: int = -1
    prepare_s: float = 0.0
    plan_s: float = 0.0
    pause_s: float = 0.0  # decode stalled: plan + stream + drain + rebind
    moved_bytes: int = 0
    executed_bytes: int = 0
    plan_network_bytes: int = 0
    plan_local_bytes: int = 0
    # layers whose CACHE cells were all resident (the serving reuse
    # headline: tp-preserving resizes keep every live cache shard in place)
    cache_resident_layers: int = 0
    warm_hit: bool = False
    outcome: str = "committed"


@dataclass
class _Pending:
    target: ParallelConfig
    key: tuple
    handle: Optional[WorldHandle] = None  # warm pool hit
    builder: Optional[ShadowBuilder] = None  # cold shadow build
    requested_at: float = field(default_factory=time.perf_counter)

    @property
    def ready(self) -> bool:
        return self.handle is not None or self.builder.ready


def _resolve(device) -> torch.device:
    from repro_torch.models.model import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class LiveServeController:
    """Owns the active serving world + params; serves resize requests."""

    def __init__(
        self,
        cfg: ModelConfig,
        parallel: ParallelConfig,
        n_slots: int,
        prompt_len: int,
        max_seq: int,
        cache_dtype=torch.float32,
        pool: Optional[WorldPool] = None,
        pool_capacity: int = 2,
        staging_bytes: int = DEFAULT_STAGING_BYTES,
        sync_prepare: bool = False,
        seed: int = 0,
        device="cuda",
        params: Optional[dict] = None,
    ):
        from repro_torch.models import model as M

        self.cfg = cfg
        self.n_slots = n_slots
        self.prompt_len = prompt_len
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.device = _resolve(device)
        self.world_pool = pool if pool is not None else WorldPool(capacity=pool_capacity)
        self.staging_bytes = staging_bytes
        self.sync_prepare = sync_prepare
        self.gen_id = 0
        self.records: list[ServeRecord] = []
        self._pending: Optional[_Pending] = None
        # one spec list serves every topology: specs are config-level, the
        # planner applies each ParallelConfig's factors at plan time
        self.specs = serve_state_specs(cfg, n_slots, max_seq, cache_dtype=cache_dtype)
        self.active = self._acquire(parallel)
        self.active.gen_id = self.gen_id
        # params live on the controller; the seeded init is one generator
        # over the full tensors, so it does not depend on the topology
        if params is None:
            params = M.init_params(cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
        self.params = M.cast_params(_to(params, self.active.device), cfg.dtype)

    # -- world acquisition ---------------------------------------------
    def _device_subset(self, target: ParallelConfig) -> list:
        """The world's rank -> device list: every rank on the one device."""
        return [self.device] * target.world_size

    def pool_key(self, target: ParallelConfig) -> tuple:
        """Pool identity of the serving world for ``target``: everything
        shaping its functions plus the device-set fingerprint. The leading
        tag keeps serve worlds apart from training worlds in a shared pool."""
        fingerprint = tuple(str(d) for d in self._device_subset(target))
        return (
            "serve",
            self.cfg,
            target,
            fingerprint,
            self.n_slots,
            self.prompt_len,
            self.max_seq,
            dtype_name(self.cache_dtype),
        )

    def _build(self, target: ParallelConfig) -> WorldHandle:
        return build_serve_world(
            self.cfg,
            target,
            self.n_slots,
            self.prompt_len,
            self.max_seq,
            devices=self._device_subset(target),
            cache_dtype=self.cache_dtype,
        )

    def _acquire(self, target: ParallelConfig) -> WorldHandle:
        """Initial world: warm from the pool when a previous session (or
        prefetch) deposited one, else a synchronous cold build."""
        warm = self.world_pool.take(self.pool_key(target))
        if warm is not None:
            warm.timings = dict(warm.timings)
            warm.timings["warm_hit"] = True
            return warm
        return self._build(target)

    # -- Prepare --------------------------------------------------------
    def request_resize(self, target: ParallelConfig) -> None:
        """Start Prepare for ``target``; decode keeps running. A newer
        request supersedes an in-flight one (retarget): the abandoned
        build deposits its world into the pool on completion."""
        if self._pending is not None:
            self._discard_pending()
        key = self.pool_key(target)
        warm = self.world_pool.take(key)
        if warm is not None:
            self._pending = _Pending(target=target, key=key, handle=warm)
            return
        builder = ShadowBuilder(
            lambda: self._build(target),
            gen_id=self.gen_id + 1,
            on_discard=lambda h, k=key: self.world_pool.put(k, h),
        )
        builder.start()
        self._pending = _Pending(target=target, key=key, builder=builder)
        if self.sync_prepare:
            builder.result()

    def _discard_pending(self) -> None:
        p, self._pending = self._pending, None
        if p is None:
            return
        if p.handle is not None:
            self.world_pool.put(p.key, p.handle)
        else:
            p.builder.abandon()

    @property
    def resize_pending(self) -> bool:
        return self._pending is not None

    @property
    def resize_ready(self) -> bool:
        return self._pending is not None and self._pending.ready

    # -- Switch (the mid-generation commit) -----------------------------
    def commit(self, cache: Any, cut_step: int):
        """Commit the pending resize at a decode-step boundary.

        Streams params + the live cache through one intersection plan on
        the shared engine; returns the cache re-hosted on the new world.
        Token-for-token continuity is the migrated state: byte-identical
        cache rows, same positions, same params.
        """
        if self._pending is None:
            raise RuntimeError("no resize pending")
        p, self._pending = self._pending, None
        if p.handle is not None:
            handle, warm_hit = p.handle, True
            prepare_s = time.perf_counter() - p.requested_at
        else:
            handle = p.builder.result()  # blocks for any remaining Prepare
            warm_hit = False
            prepare_s = handle.timings.get("prepare_total_s", 0.0)
        handle.gen_id = self.gen_id + 1

        t_pause = time.perf_counter()
        # wave-boundary commit (no generation in flight): params-only plan
        specs = self.specs if cache is not None else [s for s in self.specs if s.collection == "params"]
        t0 = time.perf_counter()
        plan = serve_plan(self.cfg, specs, self.active.parallel, handle.parallel)
        plan_s = time.perf_counter() - t0
        named = named_serve_leaves(self.params, cache)
        dst_named, stats = live_reshard_planned(
            specs,
            plan,
            named,
            self.active.devices,
            handle.devices,
            staging_bytes=self.staging_bytes,
        )
        params, new_cache = rebuild_serve_state(dst_named, self.params, cache)

        old, old_key = self.active, self.pool_key(self.active.parallel)
        self.active, self.params, self.gen_id = handle, params, handle.gen_id
        # retired active becomes the pool's warm world for its topology
        self.world_pool.put(old_key, old)
        pause_s = time.perf_counter() - t_pause

        cache_layers = {t.layer for t in plan.tasks if t.collection == "cache"}
        cache_moved = {t.layer for t in plan.tasks if t.collection == "cache" and t.kind != "resident"}
        rec = ServeRecord(
            gen_id=self.gen_id,
            src=old.parallel.describe(),
            dst=handle.parallel.describe(),
            cut_step=cut_step,
            prepare_s=prepare_s,
            plan_s=plan_s,
            pause_s=pause_s,
            moved_bytes=stats.network_bytes + stats.local_bytes,
            executed_bytes=stats.executed_bytes,
            plan_network_bytes=plan.network_bytes,
            plan_local_bytes=plan.local_bytes,
            cache_resident_layers=len(cache_layers - cache_moved),
            warm_hit=warm_hit,
            reused_layers=len(plan.resident_layers()),
            resident_layers=len(plan.resident_layers()),
            resident_cells=stats.resident_cells,
            skipped_bytes=stats.resident_bytes,
            logical_bytes=stats.logical_bytes,
            wire_bytes=stats.wire_bytes,
        )
        self.records.append(rec)
        return new_cache

    def shutdown(self, retire_to_pool: bool = True) -> None:
        """Release controller-held worlds. ``retire_to_pool`` deposits the
        active world for the next session (cross-session warm start)."""
        self._discard_pending()
        if retire_to_pool:
            self.world_pool.put(self.pool_key(self.active.parallel), self.active)
        else:
            self.active.release()
        self.active = None


def _to(tree: dict, device: torch.device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
