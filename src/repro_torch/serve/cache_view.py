"""Resource view of the serving state (params + KV cache).

The serving analogue of ``core/resource_view.py``: every decode-cache leaf
(``models/kvcache.py`` layout) gets a :class:`TensorSpec`, so cache state is
planned and moved by the SAME intersection-planner -> ReshardEngine pipeline
as parameters, including delta classification: a tp-preserving resize
adopts the resident cache instead of re-streaming it.

Role assignment (the cache-migration invariant): the batch (slot) axis
carries role ``none``, so the serving state has no ``dp`` role anywhere and
a resize that preserves the tp degree classifies every cell resident.

The param specs carry the dtypes the port serves with: the controller holds
``model.cast_params(params, cfg.dtype)`` (matrices in ``cfg.dtype``, norm
scales in float32), where the JAX controller holds float32 params and casts
at use. On the reduced (float32) configs the specs equal the JAX package's
field for field; at full width (bfloat16) each matrix's bytes are half the
JAX plan's.

The JAX package's ``role_sharding`` has no counterpart: a world's state is
global tensors on its one device (``reshard/executors.py``). Attention KV
and SSM (Mamba-2) state leaves are covered; the encoder-decoder
cross-attention KV comes with its model family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.intersection import TransferPlan, plan_transfer
from repro_torch.core.resource_view import TensorSpec, build_tensor_specs, dtype_name
from repro_torch.utils.pytree import tree_from_paths, tree_paths

__all__ = [
    "cache_tensor_specs",
    "named_serve_leaves",
    "rebuild_serve_state",
    "serve_plan",
    "serve_state_specs",
]



def cache_tensor_specs(cfg: ModelConfig, batch: int, max_seq: int, cache_dtype="float32") -> list[TensorSpec]:
    """Specs for the decode cache tree. Shapes mirror ``kvcache.init_cache``
    exactly; names (``cache/pos{j}/k``) carry the ``/pos{j}/`` marker the
    planner's layer-granular streaming keys on, so cache cells land in the
    same global layer ids as the params of that block position."""
    from repro_torch.models.kvcache import cache_capacity
    from repro_torch.models.transformer import block_program, n_periods

    from repro_torch.models import ssm as ssm_mod

    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the cross-attention KV of enc-dec models is not ported yet (ROADMAP queue 1 item 10)"
        )
    prog = block_program(cfg)
    np_ = n_periods(cfg)
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    T = cache_capacity(cfg, max_seq)
    specs: list[TensorSpec] = []
    for j, (mixer, _) in enumerate(prog):
        if mixer == "attn":
            for leaf in ("k", "v"):
                specs.append(
                    TensorSpec(
                        name=f"cache/pos{j}/{leaf}",
                        shape=(np_, batch, T, kh, hd),
                        dtype=dtype_name(cache_dtype),
                        roles=("pp", "none", "none", "tp", "none"),
                        stage_scope="stages",
                        collection="cache",
                    )
                )
            continue
        # the SSD state splits its heads over tp, the conv history its
        # channels; both are float32 whatever the cache dtype
        _, h, n, conv_ch = ssm_mod.ssm_dims(cfg)
        specs.append(
            TensorSpec(
                name=f"cache/pos{j}/ssd",
                shape=(np_, batch, h, ssm_mod.SSM_HEAD_DIM, n),
                dtype="float32",
                roles=("pp", "none", "tp", "none", "none"),
                stage_scope="stages",
                collection="cache",
            )
        )
        specs.append(
            TensorSpec(
                name=f"cache/pos{j}/conv",
                shape=(np_, batch, ssm_mod.CONV_WIDTH - 1, conv_ch),
                dtype="float32",
                roles=("pp", "none", "none", "tp"),
                stage_scope="stages",
                collection="cache",
            )
        )
    return specs


def serve_state_specs(cfg: ModelConfig, batch: int, max_seq: int, cache_dtype="float32") -> list[TensorSpec]:
    """Params + cache: the full migratable serving state, params in the
    dtypes the port serves with (module docstring)."""
    from repro_torch.models import model as M

    served = tree_paths(M.cast_params(M.abstract_params(cfg), cfg.dtype))
    params = [
        dataclasses.replace(s, dtype=dtype_name(served[s.name.removeprefix("params/")].dtype))
        for s in build_tensor_specs(cfg, include_optimizer=False)
    ]
    return params + cache_tensor_specs(cfg, batch, max_seq, cache_dtype=cache_dtype)


def serve_plan(
    cfg: ModelConfig,
    specs: list[TensorSpec],
    cfg_src: ParallelConfig,
    cfg_dst: ParallelConfig,
    allowed_src=None,
) -> TransferPlan:
    """Intersection plan for a serving resize — one plan covers params and
    cache together, so both stream through one engine pass at commit."""
    from repro_torch.models.transformer import block_program

    return plan_transfer(
        specs,
        cfg_src,
        cfg_dst,
        source_policy="nearest",
        layer_granular=True,
        num_positions=len(block_program(cfg)),
        allowed_src=allowed_src,
    )


def named_serve_leaves(params: Any, cache: Optional[Any] = None) -> dict[str, Any]:
    """Flatten live serving state into the resource view's tensor names.
    ``cache=None`` covers wave-boundary commits: no generation in flight,
    so only params migrate."""
    named: dict[str, Any] = {}
    for path, leaf in tree_paths(params).items():
        named[f"params/{path}"] = leaf
    for path, leaf in tree_paths(cache or {}).items():
        named[f"cache/{path}"] = leaf
    return named


def rebuild_serve_state(named: dict[str, Any], params_like: Any, cache_like: Any = None):
    """Inverse of :func:`named_serve_leaves`. Returns (params, cache)."""
    params = tree_from_paths({p: named[f"params/{p}"] for p in tree_paths(params_like)})
    cache = None
    if cache_like is not None:
        cache = tree_from_paths({p: named[f"cache/{p}"] for p in tree_paths(cache_like)})
    return params, cache
