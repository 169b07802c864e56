"""Primitive layers: norms, RoPE, dense MLPs, embeddings.

Parameters are plain dicts of tensors with the JAX package's names and
shapes. Every ``*_init`` takes a leading ``lead`` shape, so that
``transformer.stack_init`` draws a whole stack of periods at once, and a
``torch.Generator`` on the device it allocates on. The port's draws have
the same distributions as ``repro/models/layers.py`` but not its bits.

Beside each ``*_init`` stands its logical-axes dict (``*_AXES``), the
names ``repro/models/layers.py`` returns with its params; the reshard
planner reads them (``core/resource_view.py``).

Matrices are cast to the activation dtype at use (``.to(x.dtype)``, a no-op
when the caller pre-cast them, see ``model.cast_params``); norm scales are
always read in fp32, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen, shape, dtype, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        gen = None
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _dense_init(gen, shape, dtype, device, lead=(), in_axis=0):
    fan_in = shape[in_axis]
    return _normal(gen, (*lead, *shape), dtype, device) * (1.0 / fan_in**0.5)


def _embed_init(gen, shape, dtype, device, lead=()):
    return _normal(gen, (*lead, *shape), dtype, device) * 0.02


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device, lead=()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


RMSNORM_AXES = {"scale": ("embed",)}


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _rms(x, params["scale"], eps)


def head_rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: normalize over the trailing head_dim."""
    return _rms(x, scale, eps)


# ---------------------------------------------------------------------------
# RoPE (split-half)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": _dense_init(gen, (d, f), dtype, device, lead),
        "wi_up": _dense_init(gen, (d, f), dtype, device, lead),
        "wo": _dense_init(gen, (f, d), dtype, device, lead),
    }


MLP_AXES = {
    "wi_gate": ("embed", "ffn"),
    "wi_up": ("embed", "ffn"),
    "wo": ("ffn", "embed"),
}


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp_apply(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    gate = _act(act, x @ params["wi_gate"].to(x.dtype))
    up = x @ params["wi_up"].to(x.dtype)
    return (gate * up) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {"tok": _embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device)}


EMBED_AXES = {"tok": ("vocab", "embed")}


def embed_apply(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather first, then cast: the same values as casting the whole table
    return params["tok"][tokens].to(dtype)


def lm_head_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {"w": _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)}


LM_HEAD_AXES = {"w": ("embed", "vocab")}


def lm_head_apply(params: dict | None, embed_params: dict, x: torch.Tensor) -> torch.Tensor:
    if params is None:  # tied embeddings
        return x @ embed_params["tok"].to(x.dtype).T
    return x @ params["w"].to(x.dtype)
