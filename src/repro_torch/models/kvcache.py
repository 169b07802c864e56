"""Decode-time KV caches for attention layers.

Cache capacity: full attention => ``max_seq``; sliding window =>
``min(max_seq, window)`` (ring buffer, see attention.attn_decode). Leaves
are stacked over ``n_periods`` on a leading axis, as in the JAX package.
The SSD recurrent states of SSM layers and the enc-dec cross-attention KV
come with their model families.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import block_program, check_ported, n_periods


def cache_capacity(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.sliding_window > 0:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda"):
    """Zero cache tree."""
    check_ported(cfg)
    np_ = n_periods(cfg)
    shape = (np_, batch, cache_capacity(cfg, max_seq), cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        f"pos{j}": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
        for j in range(len(block_program(cfg)))
    }


def cache_from_prefill(cfg: ModelConfig, collected: dict, cache_dtype=torch.bfloat16, max_seq: int = 0):
    """Convert stack_prefill's collected KV into decode-cache layout.

    Collected attention KV has shape (np_, b, s, kh, hd); for sliding-window
    models only the trailing ``window`` positions are retained (ring-aligned:
    slot = pos % window, exact when s % window == 0). When ``max_seq`` (the
    decode horizon) exceeds the prompt length the cache is padded to
    ``cache_capacity(cfg, max_seq)`` so subsequent decode steps have slots.
    """
    check_ported(cfg)
    out = {}
    for j in range(len(block_program(cfg))):
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
