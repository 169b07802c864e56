"""Transformer assembly: block program, stacked-period init, and the
forward, prefill and decode passes over the stack.

As in the JAX package, layers are grouped into *periods* and each position
of a period keeps its parameters stacked over ``n_periods`` on a leading
axis (``blocks/pos0/mixer/wq`` is ``(n_periods, d, h*hd)``). The JAX
``lax.scan`` over periods becomes a loop over the stacked index. The port
runs attention and SSM (Mamba-2) mixers, each followed by a dense MLP, the
MoE MLP (``models/moe.py``: mixtral, llama4-scout, jamba's every second
layer) or none (mamba2-2.7b at full width has ``d_ff = 0``), and an enc-dec
decoder's blocks with cross attention (``cross=True``: ``ln_x`` and
``cross`` after the mixer); all train on the card and on the CPU.
:func:`stack_chunk` runs one prompt chunk of a decoder-only model against
the cache (chunked prefill). :func:`stack_forward` with ``groups`` runs
one rank's shards of a per-rank world: each sublayer's input enters the
tp region (``distribution/tp.py::copy_to``) before its norm, and
attention, the dense MLP and the MoE MLP (``moe.moe_apply_rank``, its
experts cut over ep) leave it by an all-reduce; only attention mixers
take that path. Under pipeline stages the stack a rank holds is its
stage's periods (the leaves' leading dimension, cut by pp), and the loop
runs those.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import tp as TP
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import MLP_AXES, RMSNORM_AXES, mlp_apply, mlp_init, rmsnorm_apply, rmsnorm_init


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


def _stacked(tree: dict) -> int:
    """The periods a stack (or a stage's part of one) holds: its leaves'
    leading dimension (or length, a leaf given as a list of periods)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(tree)


def _period(tree: dict, i: int) -> dict:
    """The parameters (or cache) of period ``i``: views, no copies."""
    return {k: _period(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Stack init (stacked over n_periods)
# ---------------------------------------------------------------------------


def _block_init(gen, cfg: ModelConfig, mixer: str, mlp: str, dtype, device, lead, cross: bool, cast) -> dict:
    """One block position's params; ``cast`` maps each part (and each MoE
    expert matrix) to the served dtypes as soon as it is drawn."""
    params = {"ln1": cast(rmsnorm_init(cfg.d_model, dtype, device, lead))}
    if mixer == "attn":
        params["mixer"] = cast(attn.attn_init(gen, cfg, dtype, device, lead))
    else:
        params["mixer"] = cast(ssm_mod.ssm_init(gen, cfg, dtype, device, lead))
    if cross:
        params["ln_x"] = cast(rmsnorm_init(cfg.d_model, dtype, device, lead))
        params["cross"] = cast(attn.attn_init(gen, cfg, dtype, device, lead, cross=True))
    if mlp != "none":
        params["ln2"] = cast(rmsnorm_init(cfg.d_model, dtype, device, lead))
        if mlp == "moe":
            params["mlp"] = moe_mod.moe_init(gen, cfg, dtype, device, lead, cast=cast)
        else:
            params["mlp"] = cast(mlp_init(gen, cfg, dtype, device, lead))
    return params


def stack_init(gen, cfg: ModelConfig, dtype, device, cast, cross: bool = False) -> dict:
    """The stack's params; ``cross=True`` gives each block cross attention
    (an enc-dec decoder). ``cast`` maps ``{name: leaf}`` trees to the
    served dtypes as they are drawn, or returns them (``model.init_params``)."""
    lead = (n_periods(cfg),)
    return {
        f"pos{j}": _block_init(gen, cfg, mixer, mlp, dtype, device, lead, cross, cast)
        for j, (mixer, mlp) in enumerate(block_program(cfg))
    }


def stack_axes(cfg: ModelConfig, cross: bool = False) -> dict:
    """Logical axes of :func:`stack_init`'s params: each block's axes with
    the stacked ``"layers"`` axis in front."""

    def stacked(axes: dict) -> dict:
        return {name: stacked(ax) if isinstance(ax, dict) else ("layers",) + ax for name, ax in axes.items()}

    out = {}
    for j, (mixer, mlp) in enumerate(block_program(cfg)):
        block = {"ln1": RMSNORM_AXES, "mixer": attn.attn_axes(cfg) if mixer == "attn" else ssm_mod.SSM_AXES}
        if cross:
            block.update(ln_x=RMSNORM_AXES, cross=attn.attn_axes(cfg, cross=True))
        if mlp != "none":
            block.update(ln2=RMSNORM_AXES, mlp=moe_mod.moe_axes(cfg) if mlp == "moe" else MLP_AXES)
        out[f"pos{j}"] = stacked(block)
    return out


# ---------------------------------------------------------------------------
# Forward (training), prefill and decode over the stack
# ---------------------------------------------------------------------------


def _period_forward_tp(period: dict, cfg: ModelConfig, prog, x, positions, causal: bool, groups):
    """One period's attention blocks with dense or MoE MLPs on one rank's
    shards: returns (x, the period's MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, (mixer, mlp) in enumerate(prog):
        bp = period[f"pos{j}"]
        if mixer != "attn" or mlp == "none" or "cross" in bp:
            raise ValueError(f"{cfg.name}: per-rank worlds run attention mixers with dense or MoE MLPs only")
        h = rmsnorm_apply(bp["ln1"], TP.copy_to(x, groups), groups=groups)
        x = x + attn.attn_forward(bp["mixer"], cfg, h, positions, causal=causal, groups=groups)
        h = rmsnorm_apply(bp["ln2"], TP.copy_to(x, groups), groups=groups)
        if mlp == "moe":
            y, a = moe_mod.moe_apply_rank(bp["mlp"], cfg, h, groups)
            x, aux = x + y, aux + a
        else:
            x = x + mlp_apply(bp["mlp"], h, cfg.act, groups=groups)
    return x, aux


def _period_forward(period: dict, cfg: ModelConfig, prog, x, positions, causal: bool, enc_out=None, groups=None):
    """One period's blocks: returns (x, the period's MoE aux loss)."""
    if groups is not None:
        return _period_forward_tp(period, cfg, prog, x, positions, causal, groups)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, (mixer, mlp) in enumerate(prog):
        bp = period[f"pos{j}"]
        h = rmsnorm_apply(bp["ln1"], x)
        if mixer == "attn":
            x = x + attn.attn_forward(bp["mixer"], cfg, h, positions, causal=causal)
        else:
            x = x + ssm_mod.ssm_forward(bp["mixer"], cfg, h)
        x = _cross(bp, cfg, x, enc_out)
        if mlp == "moe":
            aux = aux + moe_mod.moe_aux_loss(bp["mlp"], cfg, rmsnorm_apply(bp["ln2"], x))
        x = _mlp(bp, cfg, mlp, x)
        # the JAX package re-anchors the residual's sharding here
        # (shard_hints.constrain); one process has nothing to anchor
    return x, aux


def stack_forward(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    enc_out: torch.Tensor | None = None,
    remat: str = "full",
    groups=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over the stack; returns (x, the MoE aux loss
    summed over the layers, float32). ``enc_out`` is the encoder's output,
    which blocks with cross attention attend to.

    ``remat="full"`` recomputes each period in the backward pass, as the
    JAX package's ``jax.checkpoint`` over the scanned period body does:
    ``torch.utils.checkpoint`` without reentrancy keeps only each period's
    input. ``remat="none"`` keeps every activation; the JAX package's
    ``"dots"`` policy has no counterpart here and raises. ``groups`` runs
    one rank's shards, of the periods they hold (the module docstring)."""
    if remat not in ("full", "none"):
        raise NotImplementedError(f"remat={remat!r}: only 'full' and 'none' are ported")
    prog = block_program(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_stacked(params)):
        period = _period(params, i)
        if remat == "full" and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(
                _period_forward, period, cfg, prog, x, positions, causal, enc_out, groups, use_reentrant=False
            )
        else:
            x, a = _period_forward(period, cfg, prog, x, positions, causal, enc_out, groups)
        aux = aux + a
    return x, aux



def _cross(bp: dict, cfg: ModelConfig, x: torch.Tensor, kv_src) -> torch.Tensor:
    """The cross-attention sublayer of a block that has one: ``kv_src`` is
    the encoder output or the layer's cached ``(k, v)``; None skips it."""
    if kv_src is None or "cross" not in bp:
        return x
    return x + attn.cross_attn_forward(bp["cross"], cfg, rmsnorm_apply(bp["ln_x"], x), kv_src)


def _mlp(bp: dict, cfg: ModelConfig, mlp: str, x: torch.Tensor) -> torch.Tensor:
    if mlp == "none":
        return x
    h = rmsnorm_apply(bp["ln2"], x)
    return x + (moe_mod.moe_apply(bp["mlp"], cfg, h) if mlp == "moe" else mlp_apply(bp["mlp"], h, cfg.act))


def stack_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, enc_out=None):
    """Forward pass that also materializes the decode cache; ``enc_out``
    as in :func:`stack_forward`.

    Returns (x, collected) where collected mirrors the per-position
    structure of :func:`repro_torch.models.kvcache.init_cache`, stacked
    over n_periods: ``{"k", "v"}`` for an attention position, the SSD
    state ``{"ssd", "conv"}`` for an SSM one. For sliding-window attention
    the caller crops it to the ring (kvcache.cache_from_prefill).
    """
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
            x = _mlp(bp, cfg, mlp, _cross(bp, cfg, x + out, enc_out))
            # the JAX package re-anchors the residual's sharding here
            # (shard_hints.constrain); one process has nothing to anchor
    collected = {
        pos: {name: torch.stack(leaves) for name, leaves in by_leaf.items()} for pos, by_leaf in per_pos.items()
    }
    return x, collected


def stack_chunk(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos0: int):
    """One prompt chunk (b, C, d) at absolute position ``pos0`` through the
    stack of a decoder-only model, against ``cache``, which is updated in
    place and returned: an attention position writes the chunk's K/V and
    attends to the cache (``attention.attn_chunk``), an SSM position runs
    the scan from its carried state and stores the state after the chunk.
    Activations are O(C x context) instead of whole prefill's O(s^2)."""
    prog = block_program(cfg)
    for i in range(n_periods(cfg)):
        period = _period(params, i)
        period_cache = _period(cache, i)
        for j, (mixer, mlp) in enumerate(prog):
            bp = period[f"pos{j}"]
            c = period_cache[f"pos{j}"]
            h = rmsnorm_apply(bp["ln1"], x)
            if mixer == "attn":
                out, _, _ = attn.attn_chunk(bp["mixer"], cfg, h, c["k"], c["v"], pos0)
            else:
                out, state = ssm_mod.ssm_forward(bp["mixer"], cfg, h, return_state=True, init_state=c)
                c["ssd"].copy_(state["ssd"])
                c["conv"].copy_(state["conv"])
            x = _mlp(bp, cfg, mlp, x + out)
    return x, cache


def stack_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: int, cross_kv=None):
    """One token through the stack; ``cache`` is updated in place (see
    ``attention.attn_decode``; an SSM position's new state is copied into
    its cache leaves) and returned. ``cross_kv`` is the stacked
    cross-attention ``{"k", "v"}`` of each position (enc-dec)."""
    prog = block_program(cfg)
    for i in range(n_periods(cfg)):
        period = _period(params, i)
        period_cache = _period(cache, i)
        period_cross = _period(cross_kv, i) if cross_kv is not None else None
        for j, (mixer, mlp) in enumerate(prog):
            bp = period[f"pos{j}"]
            c = period_cache[f"pos{j}"]
            kv = (period_cross[f"pos{j}"]["k"], period_cross[f"pos{j}"]["v"]) if period_cross else None
            h = rmsnorm_apply(bp["ln1"], x)
            if mixer == "attn":
                out, _, _ = attn.attn_decode(bp["mixer"], cfg, h, c["k"], c["v"], pos)
            else:
                out, state = ssm_mod.ssm_decode(bp["mixer"], cfg, h, c)
                c["ssd"].copy_(state["ssd"])
                c["conv"].copy_(state["conv"])
            x = _mlp(bp, cfg, mlp, _cross(bp, cfg, x + out, kv))
    return x, cache
