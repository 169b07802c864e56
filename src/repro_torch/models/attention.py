"""GQA/MQA/MHA attention with RoPE, qk-norm, QKV bias and sliding windows.

Weights are stored 2-D flattened ``(d_model, heads*head_dim)`` as in the JAX
package. Prefill routes the attention product through
``ops.flash_attention`` (the CUDA kernel on the card, the plain version on
the CPU); ``use_kernel=False`` takes the written-out ``_sdpa`` instead.
Cross attention (enc-dec) stays plain torch, ``_sdpa``, as the JAX package
computes it in jnp outside any kernel. Chunked prefill (:func:`attn_chunk`)
attends a chunk's queries through the same kernel, right-aligned against
the cached keys.

``attn_forward(..., groups=)`` runs the layer on one rank's shards of a
per-rank world (:func:`_project_qkv_tp`): the planner splits ``wq`` on
its heads, ``wk`` and ``wv`` on their kv heads and ``wo`` on its input,
so the rank attends its own query heads through the same kernel and
all-reduces ``wo``'s output over tp. Where the view cuts a kv head (tp
does not divide the kv heads: at tp4 reduced qwen3's ``wk`` gives each
rank half a head), the k and v projections are gathered over tp and the
rank takes the kv heads its query heads read. ``q_norm`` and ``k_norm``
are whole on every rank and normalise its own heads, so their gradients
are all-reduced over tp.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import tp as TP
from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, apply_rope, head_rmsnorm_apply

NEG_INF = -1e30


def attn_init(gen, cfg: ModelConfig, dtype, device, lead=(), cross: bool = False) -> dict:
    """Projections of one attention layer; a cross-attention layer
    (``cross=True``) has no qkv bias and no qk-norm, as in the JAX package."""
    d = cfg.d_model
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    params = {
        "wq": _dense_init(gen, (d, h * hd), dtype, device, lead),
        "wk": _dense_init(gen, (d, k * hd), dtype, device, lead),
        "wv": _dense_init(gen, (d, k * hd), dtype, device, lead),
        "wo": _dense_init(gen, (h * hd, d), dtype, device, lead),
    }
    if cfg.qkv_bias and not cross:
        params.update(
            bq=torch.zeros((*lead, h * hd), dtype=dtype, device=device),
            bk=torch.zeros((*lead, k * hd), dtype=dtype, device=device),
            bv=torch.zeros((*lead, k * hd), dtype=dtype, device=device),
        )
    if cfg.qk_norm and not cross:
        params.update(
            q_norm=torch.ones((*lead, hd), dtype=dtype, device=device),
            k_norm=torch.ones((*lead, hd), dtype=dtype, device=device),
        )
    return params


def attn_axes(cfg: ModelConfig, cross: bool = False) -> dict:
    """Logical axes of :func:`attn_init`'s params, as in the JAX package."""
    axes = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias and not cross:
        axes.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm and not cross:
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


def local_heads(cfg: ModelConfig, tp: int, tp_rank: int) -> tuple[int, int, int, int]:
    """(first query head, query heads, first kv head, kv heads) that tp
    rank ``tp_rank`` of ``tp`` attends. Refuses a tp that does not divide
    the query heads, or a split whose query heads do not read their kv
    heads in equal groups (the kernel's GQA layout)."""
    h, k = cfg.num_heads, cfg.num_kv_heads
    if h % tp:
        raise ValueError(f"{cfg.name}: tp={tp} does not divide {h} query heads")
    hl, rep = h // tp, h // k
    q0 = tp_rank * hl
    kv0, kv1 = q0 // rep, (q0 + hl - 1) // rep + 1
    kvl = kv1 - kv0
    if hl % kvl or any((q0 + i) // rep - kv0 != i // (hl // kvl) for i in range(hl)):
        raise ValueError(f"{cfg.name}: tp={tp} rank {tp_rank} splits the query heads of a kv head unevenly")
    return q0, hl, kv0, kvl


def _project_qkv_tp(params, cfg: ModelConfig, x, positions, groups):
    """:func:`_project_qkv` on one rank's column shards of ``wq``, ``wk``,
    ``wv`` (and the biases): q (b,s,hl,hd) of the rank's query heads, k and
    v (b,s,kvl,hd) of the kv heads they read."""
    k_all, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    _, hl, kv0, kvl = local_heads(cfg, groups.tp, groups.tp_rank)
    q = x @ params["wq"].to(x.dtype)
    kk = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias and "bq" in params:
        q = q + params["bq"].to(x.dtype)
        kk = kk + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if k_all % groups.tp:
        # the view cut a kv head: gather the projections, take the heads
        kk = TP.gather_from(kk, groups)[..., kv0 * hd : (kv0 + kvl) * hd]
        v = TP.gather_from(v, groups)[..., kv0 * hd : (kv0 + kvl) * hd]
    elif kk.shape[-1] != kvl * hd:
        raise ValueError(f"wk shard of {kk.shape[-1]} columns is not the {kvl} kv heads rank {groups.tp_rank} reads")
    q = q.reshape(b, s, hl, hd)
    kk = kk.reshape(b, s, kvl, hd)
    v = v.reshape(b, s, kvl, hd)
    if cfg.qk_norm and "q_norm" in params:
        q = head_rmsnorm_apply(TP.copy_to(params["q_norm"], groups), q)
        kk = head_rmsnorm_apply(TP.copy_to(params["k_norm"], groups), kk)
    q = apply_rope(q, positions, cfg.rope_theta)
    kk = apply_rope(kk, positions, cfg.rope_theta)
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
    groups=None,
):
    """Full-sequence attention (prefill); ``groups`` runs it on one rank's
    shards (the module docstring)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if groups is not None:
        q, k, v = _project_qkv_tp(params, cfg, x, positions, groups)
        h = q.shape[2]
    else:
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
    if groups is not None:
        out = TP.reduce_from(out, groups)
    if return_kv:
        return out, k, v
    return out


def cross_attn_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, kv_src) -> torch.Tensor:
    """Cross attention (enc-dec). ``kv_src`` is the encoder output
    (forward, prefill) or a precomputed ``(k, v)`` pair (decode). No RoPE;
    every query sees all ``t`` encoder positions."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k, v = kv_src if isinstance(kv_src, tuple) else cross_attn_kv(params, cfg, kv_src)
    mask = torch.ones((1, 1, s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, hd**-0.5).reshape(b, s, h * hd)
    return out @ params["wo"].to(x.dtype)


def cross_attn_kv(params: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention keys and values of ``enc_out``, in its dtype."""
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    b, t, _ = enc_out.shape
    k = (enc_out @ params["wk"].to(enc_out.dtype)).reshape(b, t, kh, hd)
    v = (enc_out @ params["wv"].to(enc_out.dtype)).reshape(b, t, kh, hd)
    return k, v


def attn_chunk(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (b, C, d): a chunk of the prompt
    cache_k: torch.Tensor,  # (b, T, kh, hd)
    cache_v: torch.Tensor,
    pos0: int,  # absolute position of the chunk's first token
):
    """Chunked-prefill attention: write the chunk's K/V into the cache (in
    place) and attend its queries against everything cached so far.
    Returns (out, cache_k, cache_v).

    The keys are contiguous absolute positions ending at the chunk's last
    token, so the queries are right-aligned at ``t - C`` and
    ``ops.flash_attention``'s causal and window masks are the JAX
    package's masks by absolute position. Without a ring they are the
    cache's first ``pos0 + C`` slots after the write. A sliding-window
    ring that the chunk would wrap (``T < pos0 + C``) would lose entries
    the chunk's early queries still see, so its pre-write contents are
    taken in absolute order (positions ``max(0, pos0 - T) .. pos0 - 1``),
    the fresh chunk appended in the compute dtype, as the JAX package
    appends it, and only then the write committed at ``pos0 % T``."""
    b, C, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    T = cache_k.shape[1]
    positions = (pos0 + torch.arange(C, dtype=torch.int32, device=x.device)).expand(b, C)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    ring = bool(cfg.sliding_window) and T < pos0 + C
    slot = pos0 % T if ring else pos0
    if ring and not (C <= T and T % C == 0):
        raise ValueError(f"a chunk of {C} through a ring of {T} slots needs C <= T and T % C == 0")
    if slot + C > T:
        raise ValueError(f"a chunk of {C} at slot {slot} leaves the cache's {T} slots")
    if ring:
        idx = torch.arange(pos0 - min(pos0, T), pos0, device=x.device) % T
        k = torch.cat([cache_k.index_select(1, idx).to(q.dtype), k_new], dim=1)
        v = torch.cat([cache_v.index_select(1, idx).to(q.dtype), v_new], dim=1)
    cache_k[:, slot : slot + C] = k_new.to(cache_k.dtype)
    cache_v[:, slot : slot + C] = v_new.to(cache_v.dtype)
    if not ring:
        # for b > 1 a slice of the slots is not contiguous: the kernel's
        # input is a copy
        k = cache_k[:, : pos0 + C].to(q.dtype)
        v = cache_v[:, : pos0 + C].to(q.dtype)
    out = ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=cfg.sliding_window, scale=hd**-0.5
    )
    out = out.reshape(b, C, h * hd)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v


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
