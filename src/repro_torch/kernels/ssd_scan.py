"""The Mamba-2 SSD intra-chunk block on the GPU: the wrapper of the
hand-written CUDA kernel in ``csrc/ssd_scan.cu`` and the
``torch.autograd.Function`` around it.

It replaces the TPU kernel ``repro/kernels/ssd_scan.py``
(``ssd_intra_chunk_pallas``) and computes what it computes: per (batch,
head, chunk), ``y = ((C·Bᵀ) ∘ L ∘ dtᵀ)·x`` with ``L[t, s] = exp(cum_t -
cum_s)`` for ``s <= t``, and the chunk state ``S = Σ_s exp(cum_last -
cum_s)·dt_s·x_s ⊗ B_s``, in float32. Its plain version is
:func:`repro_torch.kernels.ref.ssd_intra_chunk_ref`; ``ops.ssd_scan`` runs the
chunked scan around it (padding, the within-chunk cumsum, the inter-chunk
recurrence) and passes this kernel on the card.

The wrapper refuses what the kernel does not compute: a sequence that is
not a multiple of the chunk (``ops.ssd_scan`` pads with ``dt = 0`` first),
a chunk above 64, a head dim above 64, a state above 128, ``x`` other than
float32/bfloat16, ``dt``/``cum``/``B``/``C`` other than float32, and
non-contiguous or non-CUDA tensors.

The TPU kernel has no backward, and neither has this one yet: the
autograd Function's backward raises ``NotImplementedError`` naming ROADMAP
queue 1 item 14, so a gradient through the card's scan fails loudly
instead of coming out wrong. On the CPU the plain version trains under
plain autograd.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BACKWARD_TODO = (
    "the backward of the SSD intra-chunk kernel is not written yet (ROADMAP queue 1 item 14: "
    "SSM training); on the card the SSD scan runs forward only"
)

# Kernel launches in this process; bumped once per launch, nowhere else.
launches = 0

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded at first use, its argument
    types set once."""
    global _LIB
    if _LIB is None:
        lib = build.load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd_intra_chunk.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.repro_ssd_intra_chunk.restype = ctypes.c_int
        lib.repro_ssd_error_string.argtypes = [ctypes.c_int]
        lib.repro_ssd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_args(x, dt, cum, B, C, chunk: int) -> None:
    """Raise ``ValueError`` for anything the kernel does not compute."""
    if x.dim() != 4:
        raise ValueError(f"want x (b, s, h, p), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1] if B.dim() == 3 else -1
    for name, t, shape in (("dt", dt, (b, s, h)), ("cum", cum, (b, s, h)), ("B", B, (b, s, n)), ("C", C, (b, s, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32, got {t.dtype}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x: want float32 or bfloat16, got {x.dtype}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{MAX_CHUNK}")
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk} (ops.ssd_scan pads it)")
    if not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE):
        raise ValueError(f"head dim {p} / state {n} outside 1..{MAX_HEAD_DIM} / 1..{MAX_STATE}")
    if min(b, s, h) == 0 or b * (s // chunk) >= 2**31 or h > 4 * 65535:
        raise ValueError(f"unsupported sizes b={b} s={s} h={h}")
    tensors = (x, dt, cum, B, C)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, dt, cum, B and C must be contiguous")
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"ssd_intra_chunk_cuda needs CUDA tensors on one device, got {[str(t.device) for t in tensors]}")


def ssd_intra_chunk_cuda(x, dt, cum, B, C, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on torch's current stream; no synchronisation.
    Returns (y_intra (b,s,h,p) float32, S (b,nc,h,p,n) float32)."""
    global launches
    check_args(x, dt, cum, B, C, chunk)
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return ssd_intra_chunk_cuda(x, dt, cum, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    lib = _LIB or _lib()
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    S = torch.empty((b, s // chunk, h, p, n), dtype=torch.float32, device=x.device)
    err = lib.repro_ssd_intra_chunk(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), S.data_ptr(),
        b, s, h, p, n, chunk, _DTYPE_CODES[x.dtype], torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        msg = lib.repro_ssd_error_string(err).decode()
        raise RuntimeError(f"ssd intra-chunk launch failed: cudaError {err} ({msg})")
    launches += 1
    return y, S


class SSDIntraChunk(torch.autograd.Function):
    """The kernel as an autograd node whose backward refuses: a raw-pointer
    kernel is not connected to autograd, so without this node a gradient
    through the card's scan would silently miss the intra-chunk terms."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C, chunk: int):
        return ssd_intra_chunk_cuda(x, dt, cum, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dS):
        raise NotImplementedError(BACKWARD_TODO)


def ssd_intra_chunk(x, dt, cum, B, C, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk block on the card; a gradient through it raises."""
    return SSDIntraChunk.apply(x, dt, cum, B, C, chunk)
