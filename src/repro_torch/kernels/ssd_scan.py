"""The Mamba-2 SSD intra-chunk block on the GPU: the wrappers of the
hand-written CUDA kernels in ``csrc/ssd_scan.cu`` (forward) and
``csrc/ssd_scan_bwd.cu`` (backward), and the ``torch.autograd.Function``
that joins them.

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

The TPU kernel has no backward. This module adds the port's own, a
second hand-written kernel in ``csrc/ssd_scan_bwd.cu``
(:func:`ssd_intra_chunk_bwd_cuda`): from the gradients of ``y_intra`` and
``S`` it gives those of x, dt, cum, B and C, deterministically (no
atomics: the same inputs give the same bits). :class:`SSDIntraChunk` joins
the two as an autograd node; its plain counterpart is
``ref.SSDIntraChunkRef``. On the CPU the plain version trains under plain
autograd.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process, forward and backward; each bumped once
# per launch of its kernel, nowhere else.
launches = 0
bwd_launches = 0

_LIB: ctypes.CDLL | None = None
_BWD_LIB: ctypes.CDLL | None = None


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


def _bwd_lib() -> ctypes.CDLL:
    """The backward kernel's library, built and loaded at first use."""
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = build.load("ssd_scan_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd_bwd_groups.argtypes = [i] * 6
        lib.repro_ssd_bwd_groups.restype = ctypes.c_int
        lib.repro_ssd_intra_chunk_bwd.argtypes = [p] * 13 + [i] * 7 + [p]
        lib.repro_ssd_intra_chunk_bwd.restype = ctypes.c_int
        lib.repro_ssd_bwd_error_string.argtypes = [ctypes.c_int]
        lib.repro_ssd_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def check_args(x, dt, cum, B, C, chunk: int) -> None:
    """Raise ``ValueError`` for anything the kernel does not compute."""
    _check_shapes(x, dt, cum, B, C, chunk)
    _check_devices("ssd_intra_chunk_cuda", (x, dt, cum, B, C))


def check_bwd_args(x, dt, cum, B, C, dy, dS, chunk: int) -> None:
    """Raise ``ValueError`` for anything the backward kernel does not take:
    the forward's inputs as :func:`check_args` takes them, ``dy`` (b, s, h,
    p) and ``dS`` (b, s // chunk, h, p, n) float32 and contiguous, all on
    one CUDA device."""
    _check_shapes(x, dt, cum, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    for name, t, shape in (("dy", dy, (b, s, h, p)), ("dS", dS, (b, s // chunk, h, p, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_devices("ssd_intra_chunk_bwd_cuda", (x, dt, cum, B, C, dy, dS))


def _check_devices(name: str, tensors) -> None:
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors on one device, got {[str(t.device) for t in tensors]}")


def _check_shapes(x, dt, cum, B, C, chunk: int) -> None:
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
    if not all(t.is_contiguous() for t in (x, dt, cum, B, C)):
        raise ValueError("x, dt, cum, B and C must be contiguous")


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


def ssd_intra_chunk_bwd_cuda(x, dt, cum, B, C, dy, dS, chunk: int):
    """Launch the backward kernel on torch's current stream; no
    synchronisation. ``dy``, ``dS``: the gradients of ``y_intra`` and ``S``.
    Returns (dx in x's dtype, ddt, dcum, dB, dC float32), what
    ``ref.ssd_intra_chunk_bwd_ref`` computes. dB and dC sum over heads:
    each head group's partial goes to a scratch and a second launch adds
    the groups in order."""
    global bwd_launches
    check_bwd_args(x, dt, cum, B, C, dy, dS, chunk)
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return ssd_intra_chunk_bwd_cuda(x, dt, cum, B, C, dy, dS, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    lib = _BWD_LIB or _bwd_lib()
    groups = lib.repro_ssd_bwd_groups(b, s, h, p, n, chunk)
    if groups < 1:
        raise RuntimeError(f"ssd backward: no launch for b={b} s={s} h={h} p={p} n={n} chunk={chunk}")
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    dcum = torch.empty_like(ddt)
    dB = torch.empty((b, s, n), dtype=torch.float32, device=x.device)
    dC = torch.empty_like(dB)
    part = torch.empty((2, groups, b, s, n), dtype=torch.float32, device=x.device) if groups > 1 else None
    err = lib.repro_ssd_intra_chunk_bwd(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(), dS.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dcum.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        None if part is None else part.data_ptr(), b, s, h, p, n, chunk, _DTYPE_CODES[x.dtype],
        torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        msg = lib.repro_ssd_bwd_error_string(err).decode()
        raise RuntimeError(f"ssd intra-chunk backward launch failed: cudaError {err} ({msg})")
    bwd_launches += 1
    return dx, ddt, dcum, dB, dC


class SSDIntraChunk(torch.autograd.Function):
    """The two kernels as an autograd node: the forward kernel, and the
    backward kernel on the saved inputs. A raw-pointer kernel is not
    connected to autograd; this node is what connects it."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C, chunk: int):
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, dt, cum, B, C)
        ctx.chunk = chunk
        return ssd_intra_chunk_cuda(x, dt, cum, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dS):
        x, dt, cum, B, C = ctx.saved_tensors
        grads = ssd_intra_chunk_bwd_cuda(x, dt, cum, B, C, dy.contiguous(), dS.contiguous(), ctx.chunk)
        return (*grads, None)


def ssd_intra_chunk(x, dt, cum, B, C, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk block on the card, differentiable through the
    backward kernel."""
    return SSDIntraChunk.apply(x, dt, cum, B, C, chunk)
