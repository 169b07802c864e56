"""Decode-time caches: KV ring buffers of attention layers, the SSD
recurrent states of SSM (Mamba-2) layers, and the cross-attention KV of
enc-dec models.

Cache capacity: full attention => ``max_seq``; sliding window =>
``min(max_seq, window)`` (ring buffer, see attention.attn_decode). An SSM
layer keeps ``ssd`` (b, h, 64, n) and ``conv`` (b, CONV_WIDTH-1, conv_ch),
both float32 whatever the cache dtype, as in the JAX package. Leaves are
stacked over ``n_periods`` on a leading axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.transformer import block_program, n_periods


def cache_capacity(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.sliding_window > 0:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda"):
    """Zero cache tree."""
    np_ = n_periods(cfg)
    shape = (np_, batch, cache_capacity(cfg, max_seq), cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {}
    for j, (mixer, _) in enumerate(block_program(cfg)):
        if mixer == "attn":
            cache[f"pos{j}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
            }
        else:
            state = ssm_mod.ssm_init_state(cfg, batch, torch.float32, "meta")  # shapes
            cache[f"pos{j}"] = {
                name: torch.zeros((np_, *leaf.shape), dtype=torch.float32, device=device)
                for name, leaf in state.items()
            }
    return cache


def init_cross_kv(cfg: ModelConfig, batch: int, enc_len: int, dtype=torch.bfloat16, device="cuda"):
    """Zero cross-attention KV of an enc-dec model (None for any other):
    ``{"pos{j}": {"k", "v"}}``, each (n_periods, batch, enc_len, kv heads,
    head dim)."""
    if cfg.family != "encdec":
        return None
    shape = (n_periods(cfg), batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        f"pos{j}": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
        for j in range(len(block_program(cfg)))
    }


def cache_from_prefill(cfg: ModelConfig, collected: dict, cache_dtype=torch.bfloat16, max_seq: int = 0):
    """Convert stack_prefill's collected KV and SSM states into the
    decode-cache layout (SSM states as they are, float32).

    Collected attention KV has shape (np_, b, s, kh, hd); for sliding-window
    models only the trailing ``window`` positions are retained (ring-aligned:
    slot = pos % window, exact when s % window == 0). When ``max_seq`` (the
    decode horizon) exceeds the prompt length the cache is padded to
    ``cache_capacity(cfg, max_seq)`` so subsequent decode steps have slots.
    """
    out = {}
    for j, (mixer, _) in enumerate(block_program(cfg)):
        if mixer != "attn":
            out[f"pos{j}"] = {name: leaf.float() for name, leaf in collected[f"pos{j}"].items()}
            continue
        k, v = collected[f"pos{j}"]["k"], collected[f"pos{j}"]["v"]
        if cfg.sliding_window > 0 and k.shape[2] > cfg.sliding_window:
            w = cfg.sliding_window
            if k.shape[2] % w:
                raise ValueError(f"prefill length {k.shape[2]} is not a multiple of window {w}")
            k, v = k[:, :, -w:], v[:, :, -w:]
        cap = cache_capacity(cfg, max(max_seq, k.shape[2]))
        pad = (0, 0, 0, 0, 0, cap - k.shape[2])  # pad the sequence axis at the end
        out[f"pos{j}"] = {
            "k": F.pad(k.to(cache_dtype), pad),
            "v": F.pad(v.to(cache_dtype), pad),
        }
    return out
