"""Transformer assembly: block program, stacked-period init, and the
forward, prefill and decode passes over the stack.

As in the JAX package, layers are grouped into *periods* and each position
of a period keeps its parameters stacked over ``n_periods`` on a leading
axis (``blocks/pos0/mixer/wq`` is ``(n_periods, d, h*hd)``). The JAX
``lax.scan`` over periods becomes a loop over the stacked index. The port
runs attention and SSM (Mamba-2) mixers with a dense MLP or none
(mamba2-2.7b at full width has ``d_ff = 0``); the MoE MLP and enc-dec
models raise. An SSM mixer trains on the CPU only: on the card its SSD
kernel has no backward yet (:func:`check_trainable`).
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import MLP_AXES, RMSNORM_AXES, mlp_apply, mlp_init, rmsnorm_apply, rmsnorm_init

_NOT_PORTED = {
    "moe": "the MoE MLP (ROADMAP queue 1 item 10)",
}
SSM_TRAINING_TODO = (
    "training the SSM mixer on the card needs a backward of the SSD intra-chunk kernel, which is "
    "not written yet (ROADMAP queue 1 item 14: SSM training); on the CPU the plain version trains"
)


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


def check_trainable(cfg: ModelConfig, device) -> None:
    """Raise ``NotImplementedError`` for a model that cannot train on
    ``device``: an SSM mixer on the card. Takes a device or its name and
    builds no tensor."""
    check_ported(cfg)
    if torch.device(device).type == "cuda" and any(m == "ssm" for m, _ in block_program(cfg)):
        raise NotImplementedError(f"{cfg.name}: {SSM_TRAINING_TODO}")


def _period(tree: dict, i: int) -> dict:
    """The parameters (or cache) of period ``i``: views, no copies."""
    return {k: _period(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Stack init (stacked over n_periods)
# ---------------------------------------------------------------------------


def _block_init(gen, cfg: ModelConfig, mixer: str, mlp: str, dtype, device, lead) -> dict:
    params = {"ln1": rmsnorm_init(cfg.d_model, dtype, device, lead)}
    if mixer == "attn":
        params["mixer"] = attn.attn_init(gen, cfg, dtype, device, lead)
    else:
        params["mixer"] = ssm_mod.ssm_init(gen, cfg, dtype, device, lead)
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


def stack_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`stack_init`'s params: each block's axes with
    the stacked ``"layers"`` axis in front."""
    check_ported(cfg)
    out = {}
    for j, (mixer, mlp) in enumerate(block_program(cfg)):
        block = {"ln1": RMSNORM_AXES, "mixer": attn.attn_axes(cfg) if mixer == "attn" else ssm_mod.SSM_AXES}
        if mlp != "none":
            block.update(ln2=RMSNORM_AXES, mlp=MLP_AXES)
        out[f"pos{j}"] = {
            part: {name: ("layers",) + ax for name, ax in axes.items()}
            for part, axes in block.items()
        }
    return out


# ---------------------------------------------------------------------------
# Forward (training), prefill and decode over the stack
# ---------------------------------------------------------------------------


def _period_forward(period: dict, cfg: ModelConfig, prog, x, positions, causal: bool):
    for j, (mixer, mlp) in enumerate(prog):
        bp = period[f"pos{j}"]
        h = rmsnorm_apply(bp["ln1"], x)
        if mixer == "attn":
            x = x + attn.attn_forward(bp["mixer"], cfg, h, positions, causal=causal)
        else:
            x = x + ssm_mod.ssm_forward(bp["mixer"], cfg, h)
        x = _mlp(bp, cfg, mlp, x)
        # the JAX package re-anchors the residual's sharding here
        # (shard_hints.constrain); one process has nothing to anchor
    return x


def stack_forward(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    remat: str = "full",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over the stack; returns (x, moe aux loss),
    the aux loss a float32 zero (no MoE layer is ported).

    ``remat="full"`` recomputes each period in the backward pass, as the
    JAX package's ``jax.checkpoint`` over the scanned period body does:
    ``torch.utils.checkpoint`` without reentrancy keeps only each period's
    input. ``remat="none"`` keeps every activation; the JAX package's
    ``"dots"`` policy has no counterpart here and raises."""
    check_ported(cfg)
    if remat not in ("full", "none"):
        raise NotImplementedError(f"remat={remat!r}: only 'full' and 'none' are ported")
    prog = block_program(cfg)
    for i in range(n_periods(cfg)):
        period = _period(params, i)
        if remat == "full" and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _period_forward, period, cfg, prog, x, positions, causal, use_reentrant=False
            )
        else:
            x = _period_forward(period, cfg, prog, x, positions, causal)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)



def _mlp(bp: dict, cfg: ModelConfig, mlp: str, x: torch.Tensor) -> torch.Tensor:
    if mlp == "none":
        return x
    return x + mlp_apply(bp["mlp"], rmsnorm_apply(bp["ln2"], x), cfg.act)


def stack_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Forward pass that also materializes the decode cache.

    Returns (x, collected) where collected mirrors the per-position
    structure of :func:`repro_torch.models.kvcache.init_cache`, stacked
    over n_periods: ``{"k", "v"}`` for an attention position, the SSD
    state ``{"ssd", "conv"}`` for an SSM one. For sliding-window attention
    the caller crops it to the ring (kvcache.cache_from_prefill).
    """
    check_ported(cfg)
    prog = block_program(cfg)
    per_pos: dict[str, dict[str, list]] = {f"pos{j}": {} for j in range(len(prog))}
    for i in range(n_periods(cfg)):
        period = _period(params, i)
        for j, (mixer, mlp) in enumerate(prog):
            bp = period[f"pos{j}"]
            h = rmsnorm_apply(bp["ln1"], x)
            if mixer == "attn":
                out, k, v = attn.attn_forward(bp["mixer"], cfg, h, positions, return_kv=True)
                leaves = {"k": k, "v": v}
            else:
                out, leaves = ssm_mod.ssm_forward(bp["mixer"], cfg, h, return_state=True)
            for name, leaf in leaves.items():
                per_pos[f"pos{j}"].setdefault(name, []).append(leaf)
            x = _mlp(bp, cfg, mlp, x + out)
            # the JAX package re-anchors the residual's sharding here
            # (shard_hints.constrain); one process has nothing to anchor
    collected = {
        pos: {name: torch.stack(leaves) for name, leaves in by_leaf.items()} for pos, by_leaf in per_pos.items()
    }
    return x, collected


def stack_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: int):
    """One token through the stack; ``cache`` is updated in place (see
    ``attention.attn_decode``; an SSM position's new state is copied into
    its cache leaves) and returned."""
    check_ported(cfg)
    prog = block_program(cfg)
    for i in range(n_periods(cfg)):
        period = _period(params, i)
        period_cache = _period(cache, i)
        for j, (mixer, mlp) in enumerate(prog):
            bp = period[f"pos{j}"]
            c = period_cache[f"pos{j}"]
            h = rmsnorm_apply(bp["ln1"], x)
            if mixer == "attn":
                out, _, _ = attn.attn_decode(bp["mixer"], cfg, h, c["k"], c["v"], pos)
            else:
                out, state = ssm_mod.ssm_decode(bp["mixer"], cfg, h, c)
                c["ssd"].copy_(state["ssd"])
                c["conv"].copy_(state["conv"])
            x = _mlp(bp, cfg, mlp, x + out)
    return x, cache
