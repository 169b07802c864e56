"""Kernel entry points used by the model and the reshard executor.

Dispatch is by the tensors' device and nothing else: CUDA tensors go to the
hand-written kernel, which runs or raises; CPU tensors go to the plain
version in ``ref.py``. Mixed devices raise. There is no fallback from a
failed kernel and no switch in the environment. Unlike the JAX package's
``ops``, nothing here falls back for shapes: the TPU tiling gates (``C``
a multiple of 128, block-aligned starts) are not the card's, and its
kernels take any shape.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import reshard_pack as _rp
from repro_torch.kernels import reshard_quant as _rq


def _device_of(*tensors: torch.Tensor) -> torch.device:
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    return devices.pop()


def _dispatch(name: str, cuda_fn, ref_fn, tensors, *args):
    device = _device_of(*tensors)
    if device.type == "cuda":
        return cuda_fn(*tensors, *args)
    if device.type == "cpu":
        return ref_fn(*tensors, *args)
    raise ValueError(f"{name}: no path for device {device}")


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Differentiable attention: on the card the kernel's autograd Function
    (forward kernel, backward kernel), on the CPU the plain version under
    plain autograd."""
    device = _device_of(q, k, v)
    if device.type == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    if device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"flash_attention: no path for device {device}")


def decode_attention(q, k, v, mask, scale):
    """Single-token attention against a KV cache. Plain torch on every
    device, as the JAX package leaves it to XLA (no kernel behind it)."""
    return _ref.decode_attention_ref(q, k, v, mask, scale)


# ---------------------------------------------------------------------------
# Reshard row copies. ``starts`` is a host sequence of row offsets (a list,
# numpy array or CPU tensor): the wrappers check it on the host.
# ---------------------------------------------------------------------------


def pack_rows(src, starts, block_rows: int):
    """Gather blocks of ``block_rows`` rows of ``src`` (R, C) at ``starts``
    into a fresh (nb*block_rows, C) staging buffer."""
    return _dispatch("pack_rows", _rp.pack_rows_cuda, _ref.pack_rows_ref, (src,), starts, block_rows)


def unpack_rows(buf, starts, block_rows: int, out_rows: int):
    """Scatter buffer blocks into a fresh zero (out_rows, C) array."""
    return _dispatch(
        "unpack_rows", _rp.unpack_rows_cuda, _ref.unpack_rows_ref, (buf,), starts, block_rows, out_rows
    )


def scatter_rows(dst, buf, starts, block_rows: int):
    """Overwrite-scatter buffer blocks into ``dst`` in place; returns
    ``dst``. Rows not named keep their bytes; the last block wins."""
    return _dispatch(
        "scatter_rows", _rp.scatter_rows_cuda, _ref.scatter_rows_ref, (dst, buf), starts, block_rows
    )


def relayout_rows(dst, src, starts, block_rows: int):
    """Copy the named row blocks of ``src`` into ``dst`` at the same rows,
    in place, with no staging buffer; returns ``dst``."""
    return _dispatch(
        "relayout_rows", _rp.relayout_rows_cuda, _ref.relayout_rows_ref, (dst, src), starts, block_rows
    )


# ---------------------------------------------------------------------------
# The compressed wire: quantizing pack, dequantizing scatter
# ---------------------------------------------------------------------------


def pack_quant_rows(src, starts, block_rows: int, fmt: str):
    """Gather tiles of ``block_rows`` rows of ``src`` (R, C) and quantize
    each (``fmt`` int8 or fp8_e4m3): ((nb*block_rows, C) payload, (nb, 1)
    float32 scales)."""
    return _dispatch(
        "pack_quant_rows", _rq.pack_quant_rows_cuda, _ref.pack_quant_rows_ref, (src,), starts, block_rows, fmt
    )


def dequant_scatter_rows(dst, buf, scales, starts, block_rows: int):
    """Dequantize tiles and overwrite-scatter them into ``dst`` in place;
    returns ``dst``. Rows not named keep their bytes; the last tile wins."""
    return _dispatch(
        "dequant_scatter_rows", _rq.dequant_scatter_rows_cuda, _ref.dequant_scatter_rows_ref,
        (dst, buf, scales), starts, block_rows,
    )
