"""Kernel entry points used by the model and the reshard executor.

Dispatch is by the tensors' device and nothing else: CUDA tensors go to the
hand-written kernel, which runs or raises; CPU tensors go to the plain
version in ``ref.py``. Mixed devices raise. There is no fallback from a
failed kernel and no switch in the environment. Unlike the JAX package's
``ops``, nothing here falls back for shapes: the TPU tiling gates (``C``
a multiple of 128, block-aligned starts) are not the card's, and its
kernels take any shape (the SSD kernel's chunk, head and state limits
are the model's sizes; the ragged sequence is padded here, as in the JAX
package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import reshard_pack as _rp
from repro_torch.kernels import reshard_quant as _rq
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_scan as _ssd


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


def rmsnorm(x, scale, eps: float = 1e-6):
    """Row RMSNorm over the last axis (no model code calls it, as in the
    JAX package: the model's norms are plain)."""
    return _dispatch("rmsnorm", _rms.rmsnorm_cuda, _ref.rmsnorm_ref, (x, scale), eps)


# ---------------------------------------------------------------------------
# SSD scan: the intra-chunk kernel + the plain inter-chunk recurrence
# ---------------------------------------------------------------------------


def _pad_seq(pad: int, x, dt, B, C):
    """Pad the sequence axis at the end with zeros (``dt = 0``: a no-op
    step, no contribution and unit decay)."""
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)))


def ssd_scan_chunked(x, dt, A, B, C, chunk: int, init_state, intra):
    """The chunked SSD scan around an intra-chunk function, as the JAX
    package's ``ops.ssd_scan`` runs it around its Pallas kernel: pad the
    sequence to a chunk multiple, the within-chunk inclusive cumsum of
    ``dt*A``, ``intra(x, dt, cum, B, C, chunk) -> (y_intra, S)``, the
    per-chunk decay and the inter-chunk recurrence, then the crop.
    Shapes as :func:`ssd_scan`. On the card ``intra`` is the kernel; the
    CPU tests pass ``ref.ssd_intra_chunk_ref`` to test this glue."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = _pad_seq(pad, x, dt, B, C)
    sp = s + pad
    nc, q = sp // chunk, chunk
    cum = torch.cumsum(dt.reshape(b, nc, q, h) * A[None, None, None, :], dim=2)
    y_intra, S = intra(
        x.contiguous(), dt.contiguous(), cum.reshape(b, sp, h), B.contiguous(), C.contiguous(), chunk
    )
    y_inter, final = _ref.ssd_inter_ref(
        cum, C.reshape(b, nc, q, n).float(), S, torch.exp(cum[:, :, -1, :]), init_state.float()
    )
    y = (y_intra.reshape(b, nc, q, h, p) + y_inter).reshape(b, sp, h, p)
    return (y[:, :s] if pad else y), final


def _ssd_scan_cuda(x, dt, A, B, C, chunk, init_state):
    return ssd_scan_chunked(x, dt, A, B, C, chunk, init_state, _ssd.ssd_intra_chunk)


def _ssd_scan_cpu(x, dt, A, B, C, chunk, init_state):
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = _pad_seq(pad, x, dt, B, C)
    y, final = _ref.ssd_scan_ref(x, dt, A, B, C, chunk, init_state)
    return (y[:, :s] if pad else y), final


def ssd_scan(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked Mamba-2 SSD scan. x (b,s,h,p) float; dt (b,s,h) float32
    post-softplus; A (h,) float32 negative; B, C (b,s,n) float32;
    init_state (b,h,p,n) or None. Returns (y (b,s,h,p) float32, final state
    (b,h,p,n) float32).

    On the card: :func:`ssd_scan_chunked` around the intra-chunk kernel (a
    gradient through it raises, ``kernels/ssd_scan.py``). On the CPU: the
    plain scan whole, on the padded sequence, as the JAX package's ``ops``
    runs its reference."""
    return _dispatch("ssd_scan", _ssd_scan_cuda, _ssd_scan_cpu, (x, dt, A, B, C), chunk, init_state)


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
