"""Kernel entry points used by the model code.

Dispatch is by the tensors' device and nothing else: CUDA tensors go to the
hand-written kernel, which runs or raises; CPU tensors go to the plain
version in ``ref.py``. Mixed devices raise. There is no fallback from a
failed kernel and no switch in the environment.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref


def _device_of(*tensors: torch.Tensor) -> torch.device:
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    return devices.pop()


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    device = _device_of(q, k, v)
    if device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
    if device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"flash_attention: no path for device {device}")


def decode_attention(q, k, v, mask, scale):
    """Single-token attention against a KV cache. Plain torch on every
    device, as the JAX package leaves it to XLA (no kernel behind it)."""
    return _ref.decode_attention_ref(q, k, v, mask, scale)
