"""Prefill/decode serving driver: a prompt batch -> prefill -> greedy (or
sampled) autoregressive decode, on one device. The counterpart of
``repro/serve/driver.py``. It serves every family: attention (qwen3),
MoE (mixtral), SSM (mamba2), hybrid (jamba) and enc-dec (seamless); the
elastic serving path is ``serve/loop.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

__all__ = ["demo_batch", "serve_once"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def demo_batch(
    cfg: ModelConfig, batch: int, prompt_len: int, device="cuda", seed: int = 1, frames_len: int = 16
) -> dict:
    """Deterministic synthetic prompt batch: token ids from a seeded
    generator on ``device``, and for an enc-dec model ``frames`` (batch,
    frames_len, d_model) of standard normals from the same generator, the
    audio frontend's stub."""
    dev = M.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, frames_len, cfg.d_model), generator=gen, device=dev)
    return out


def serve_once(
    cfg: ModelConfig,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    temperature: float = 0.0,
    seed: int = 0,
    device="cuda",
    frames_len: int = 16,
) -> dict:
    """Prefill a prompt batch and decode ``gen`` tokens per request
    (``frames_len`` encoder positions for an enc-dec model).

    Parameters come from the port's own init (seed ``seed``), each part
    cast to ``cfg.dtype`` as it is drawn (``init_params(served_dtype=)``:
    the bits of ``model.cast_params`` of the float32 tree). Returns ``{"tokens":
    (batch, gen+1) np.ndarray, "prefill_s": float, "decode_s": float}``:
    the first column is the token argmaxed from the prefill logits, the
    rest are decode-loop emissions.
    """
    dev = M.resolve_device(device)
    horizon = prompt_len + gen
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev, served_dtype=cfg.dtype)
    inputs = demo_batch(cfg, batch, prompt_len, dev, frames_len=frames_len)
    sampler = torch.Generator(device=dev).manual_seed(7)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if temperature > 0:
            probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=sampler)
        return logits[:, -1].argmax(dim=-1, keepdim=True)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache, cross = M.prefill(cfg, params, inputs, max_seq=horizon)
        cur = pick(logits)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        out = [cur]
        t0 = time.perf_counter()
        for i in range(gen):
            logits, cache = M.decode_step(cfg, params, cache, cur, prompt_len + i, cross)
            cur = pick(logits)
            out.append(cur)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return {
        "tokens": torch.cat(out, dim=1).cpu().numpy(),
        "prefill_s": prefill_s,
        "decode_s": decode_s,
    }
