"""Transformer assembly: block program, stacked-period init, prefill and
decode over the stack.

As in the JAX package, layers are grouped into *periods* and each position
of a period keeps its parameters stacked over ``n_periods`` on a leading
axis (``blocks/pos0/mixer/wq`` is ``(n_periods, d, h*hd)``). The JAX
``lax.scan`` over periods becomes a loop over the stacked index. This slice
runs ``("attn", "dense")`` blocks; other mixers and MLPs raise.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, mlp_init, rmsnorm_apply, rmsnorm_init

_NOT_PORTED = {
    "ssm": "the SSM mixer (ROADMAP queue 1 item 10, with the SSD kernel)",
    "moe": "the MoE MLP (ROADMAP queue 1 item 10)",
}


# ---------------------------------------------------------------------------
# Block program
# ---------------------------------------------------------------------------


def block_program(cfg: ModelConfig) -> list[tuple[str, str]]:
    """[(mixer, mlp)] per position within one period.

    mixer in {"attn", "ssm"}; mlp in {"dense", "moe", "none"}.
    """
    period = 1
    if cfg.family == "hybrid" and cfg.attn_period > 0:
        period = math.lcm(cfg.attn_period, cfg.moe_period if cfg.num_experts else 1)
    elif cfg.num_experts > 0 and cfg.moe_period > 1:
        period = cfg.moe_period
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers not a multiple of period {period}")
    prog = []
    for j in range(period):
        mixer = cfg.layer_kind(j)
        if cfg.d_ff == 0:
            mlp = "none"
        elif cfg.is_moe_layer(j):
            mlp = "moe"
        else:
            mlp = "dense"
        prog.append((mixer, mlp))
    return prog


def n_periods(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(block_program(cfg))


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block kind this slice lacks."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet (ROADMAP queue 1 item 10)"
        )
    for mixer, mlp in block_program(cfg):
        for kind in (mixer, mlp):
            if kind in _NOT_PORTED:
                raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[kind]} is not ported yet")


def _period(tree: dict, i: int) -> dict:
    """The parameters (or cache) of period ``i``: views, no copies."""
    return {k: _period(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Stack init (stacked over n_periods)
# ---------------------------------------------------------------------------


def _block_init(gen, cfg: ModelConfig, mixer: str, mlp: str, dtype, device, lead) -> dict:
    params = {"ln1": rmsnorm_init(cfg.d_model, dtype, device, lead)}
    params["mixer"] = attn.attn_init(gen, cfg, dtype, device, lead)
    if mlp != "none":
        params["ln2"] = rmsnorm_init(cfg.d_model, dtype, device, lead)
        params["mlp"] = mlp_init(gen, cfg, dtype, device, lead)
    return params


def stack_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    check_ported(cfg)
    lead = (n_periods(cfg),)
    return {
        f"pos{j}": _block_init(gen, cfg, mixer, mlp, dtype, device, lead)
        for j, (mixer, mlp) in enumerate(block_program(cfg))
    }


# ---------------------------------------------------------------------------
# Prefill and decode over the stack
# ---------------------------------------------------------------------------


def _mlp(bp: dict, cfg: ModelConfig, mlp: str, x: torch.Tensor) -> torch.Tensor:
    if mlp == "none":
        return x
    return x + mlp_apply(bp["mlp"], rmsnorm_apply(bp["ln2"], x), cfg.act)


def stack_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Forward pass that also materializes the decode cache.

    Returns (x, collected) where collected mirrors the per-position
    structure of :func:`repro_torch.models.kvcache.init_cache`:
    ``{"posj": {"k", "v"}}`` stacked over n_periods. For sliding-window
    attention the caller crops it to the ring (kvcache.cache_from_prefill).
    """
    check_ported(cfg)
    prog = block_program(cfg)
    ks: dict[str, list] = {f"pos{j}": [] for j in range(len(prog))}
    vs: dict[str, list] = {f"pos{j}": [] for j in range(len(prog))}
    for i in range(n_periods(cfg)):
        period = _period(params, i)
        for j, (_, mlp) in enumerate(prog):
            bp = period[f"pos{j}"]
            h = rmsnorm_apply(bp["ln1"], x)
            out, k, v = attn.attn_forward(bp["mixer"], cfg, h, positions, return_kv=True)
            ks[f"pos{j}"].append(k)
            vs[f"pos{j}"].append(v)
            x = _mlp(bp, cfg, mlp, x + out)
            # the JAX package re-anchors the residual's sharding here
            # (shard_hints.constrain); one process has nothing to anchor
    collected = {
        name: {"k": torch.stack(ks[name]), "v": torch.stack(vs[name])} for name in ks
    }
    return x, collected


def stack_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: int):
    """One token through the stack; ``cache`` is updated in place (see
    ``attention.attn_decode``) and returned."""
    check_ported(cfg)
    prog = block_program(cfg)
    for i in range(n_periods(cfg)):
        period = _period(params, i)
        period_cache = _period(cache, i)
        for j, (_, mlp) in enumerate(prog):
            bp = period[f"pos{j}"]
            c = period_cache[f"pos{j}"]
            out, _, _ = attn.attn_decode(
                bp["mixer"], cfg, rmsnorm_apply(bp["ln1"], x), c["k"], c["v"], pos
            )
            x = _mlp(bp, cfg, mlp, x + out)
    return x, cache
