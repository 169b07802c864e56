"""GQA/MQA/MHA attention with RoPE, qk-norm, QKV bias and sliding windows.

Weights are stored 2-D flattened ``(d_model, heads*head_dim)`` as in the JAX
package. Prefill routes the attention product through
``ops.flash_attention`` (the CUDA kernel on the card, the plain version on
the CPU); ``use_kernel=False`` takes the written-out ``_sdpa`` instead.
Chunked-prefill and cross attention are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, apply_rope, head_rmsnorm_apply

NEG_INF = -1e30


def attn_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    d = cfg.d_model
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    params = {
        "wq": _dense_init(gen, (d, h * hd), dtype, device, lead),
        "wk": _dense_init(gen, (d, k * hd), dtype, device, lead),
        "wv": _dense_init(gen, (d, k * hd), dtype, device, lead),
        "wo": _dense_init(gen, (h * hd, d), dtype, device, lead),
    }
    if cfg.qkv_bias:
        params.update(
            bq=torch.zeros((*lead, h * hd), dtype=dtype, device=device),
            bk=torch.zeros((*lead, k * hd), dtype=dtype, device=device),
            bv=torch.zeros((*lead, k * hd), dtype=dtype, device=device),
        )
    if cfg.qk_norm:
        params.update(
            q_norm=torch.ones((*lead, hd), dtype=dtype, device=device),
            k_norm=torch.ones((*lead, hd), dtype=dtype, device=device),
        )
    return params


def attn_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`attn_init`'s params, as in the JAX package."""
    axes = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        axes.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm:
        axes.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return axes


def _project_qkv(params, cfg: ModelConfig, x, positions, rope: bool = True):
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    kk = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias and "bq" in params:
        q = q + params["bq"].to(x.dtype)
        kk = kk + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, h, hd)
    kk = kk.reshape(b, s, k, hd)
    v = v.reshape(b, s, k, hd)
    if cfg.qk_norm and "q_norm" in params:
        q = head_rmsnorm_apply(params["q_norm"], q)
        kk = head_rmsnorm_apply(params["k_norm"], kk)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        kk = apply_rope(kk, positions, cfg.rope_theta)
    # the JAX package pins q's sharding here (shard_hints.constrain); a
    # single-process port has no sharding to pin
    return q, kk, v


def _sdpa(q, k, v, mask, scale):
    """Reference scaled-dot-product attention; q:(b,s,h,d) k/v:(b,t,kh,d)."""
    rep = q.shape[2] // k.shape[2]
    qf = q.float() * scale
    scores = torch.einsum("bshd,bthd->bhst", qf, torch.repeat_interleave(k.float(), rep, dim=2))
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, torch.repeat_interleave(v.float(), rep, dim=2))
    return out.to(q.dtype)


def _causal_mask(s: int, t: int, window: int, device, q_offset: int = 0) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask[None, None]  # (1,1,s,t)


def attn_forward(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    use_kernel: bool = True,
    return_kv: bool = False,
):
    """Full-sequence attention (prefill)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x, positions)
    scale = hd**-0.5
    if use_kernel:
        out = ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=causal, window=cfg.sliding_window, scale=scale,
        )
    else:
        if causal:
            mask = _causal_mask(s, s, cfg.sliding_window, x.device)
        else:
            mask = torch.ones((1, 1, s, s), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, scale)
    out = out.reshape(b, s, h * hd)
    out = out @ params["wo"].to(x.dtype)
    if return_kv:
        return out, k, v
    return out


# ---------------------------------------------------------------------------
# Decode path (single new token, KV cache)
# ---------------------------------------------------------------------------


def attn_decode(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (b, 1, d)
    cache_k: torch.Tensor,  # (b, T, kh, hd)  T = cache capacity
    cache_v: torch.Tensor,
    pos: int,  # index of the new token
):
    """One decode step. Returns (out, cache_k, cache_v).

    The new token's K/V are written into ``cache_k``/``cache_v`` in place
    (the JAX package returns updated copies); the same tensors are returned.
    For sliding-window models the cache is a ring buffer of capacity
    ``min(seq, window)``; masking uses absolute positions tracked via ``pos``.
    """
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    T = cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    if not cfg.sliding_window and not 0 <= pos < T:
        raise ValueError(f"decode position {pos} outside the cache's {T} slots")
    slot = pos % T if cfg.sliding_window else pos
    cache_k[:, slot : slot + 1] = k_new.to(cache_k.dtype)
    cache_v[:, slot : slot + 1] = v_new.to(cache_v.dtype)

    # absolute position of every cache slot
    idx = torch.arange(T, device=x.device)
    if cfg.sliding_window:
        # slot i holds absolute position: the latest p <= pos with p % T == i
        abs_pos = pos - ((pos - idx) % T)
    else:
        abs_pos = idx
    valid = (abs_pos <= pos) & (abs_pos >= 0)
    if cfg.sliding_window:
        valid &= abs_pos > pos - cfg.sliding_window
    mask = valid[None, None, None, :]  # (1,1,1,T)

    out = ops.decode_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask, hd**-0.5)
    out = out.reshape(b, 1, h * hd)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v
