"""Row RMSNorm on the GPU: the wrapper of the hand-written CUDA kernel in
``csrc/rmsnorm.cu``.

It replaces the TPU kernel ``repro/kernels/rmsnorm.py``
(``rmsnorm_pallas``) and computes what it computes over the last axis of
``x (..., d)``: the float32 mean of squares, ``rsqrt(var + eps)``, times
``scale (d,)``, cast back to ``x``'s dtype. Its plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`; ``ops.rmsnorm`` picks between
the two by the tensors' device. Unlike the TPU kernel, it takes any ``d``
and any row count, so nothing falls back for shape. As in the JAX package,
no model code calls it: the model's norms stay plain
(``models/layers.py``). The TPU kernel has no backward, and this wrapper is
not differentiable either.

The wrapper refuses ``x`` other than float32/bfloat16, a scale other than
float32/bfloat16 or not of shape ``(d,)``, and non-contiguous or non-CUDA
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; bumped once per launch, nowhere else.
launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    fn = lib.repro_rmsnorm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_int64, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.repro_rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.repro_rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def check_args(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise ``ValueError`` for anything the kernel does not compute."""
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"want x (..., d) with d > 0, got {tuple(x.shape)}")
    if tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"scale: want ({x.shape[-1]},), got {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise ValueError(f"x {x.dtype} / scale {scale.dtype}: want float32 or bfloat16")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"rmsnorm_cuda needs CUDA tensors on one device, got {x.device}, {scale.device}")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on torch's current stream; no synchronisation.
    An empty ``x`` launches nothing."""
    global launches
    check_args(x, scale)
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, x.shape[-1],
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], float(eps), stream,
        )
    if err != 0:
        msg = lib.repro_rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm launch failed: cudaError {err} ({msg})")
    launches += 1
    return out
