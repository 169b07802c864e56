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

The kernel has two bodies (``csrc/rmsnorm.cu``): a row held in registers,
read from device memory once, for aligned rows of at most
:data:`REG_VECS` 16-byte vectors a lane (d up to 6144 in bf16, 3072 in
f32), and a body that reads the row twice for the rest; :func:`body` picks
one, and :data:`body_launches` counts the launches of each. Both give the
same bits on an aligned row.

The wrapper refuses ``x`` other than float32/bfloat16, a scale other than
float32/bfloat16 or not of shape ``(d,)``, and non-contiguous or non-CUDA
tensors. A call costs about one launch on the host: the library is loaded
once with its argument types set, the stream is read raw, and the device
context is entered only where ``x`` is not on the current device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The most 16-byte vectors of a row a lane of the register body holds:
# kMaxVecs in csrc/rmsnorm.cu.
REG_VECS = 24

# Kernel launches in this process; bumped once per launch, nowhere else.
launches = 0
# The same launches by body: "registers" (the row read once) and
# "two_reads".
body_launches = {"registers": 0, "two_reads": 0}

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded at first use, its argument
    types set once and its register cap checked."""
    global _LIB
    if _LIB is not None:
        return _LIB
    # PyDLL: a call keeps the GIL; the entry returns in microseconds, less
    # than releasing and taking back the GIL costs.
    lib = ctypes.PyDLL(str(build.build_all(["rmsnorm"])["rmsnorm"]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rmsnorm.argtypes = [p, p, p, ctypes.c_int64, i, i, i, ctypes.c_float, i, p]
    lib.repro_rmsnorm.restype = ctypes.c_int
    lib.repro_rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.repro_rmsnorm_error_string.restype = ctypes.c_char_p
    lib.repro_rmsnorm_max_vecs.restype = ctypes.c_int
    if lib.repro_rmsnorm_max_vecs() != REG_VECS:
        raise RuntimeError(f"rmsnorm: the library holds {lib.repro_rmsnorm_max_vecs()} vectors a lane, "
                           f"the wrapper expects {REG_VECS}")
    _LIB = lib
    return lib


def body(d: int, itemsize: int, aligned: bool) -> int:
    """The body a row of ``d`` elements of ``itemsize`` bytes takes: the
    register body's 16-byte vectors a lane (the fewest that hold the row),
    where the row and every pointer are 16-byte aligned (``aligned``) and
    that is at most :data:`REG_VECS`; else 0, the two-read body."""
    vec = 16 // itemsize
    nv = -(-d // (32 * vec))
    return nv if aligned and d % vec == 0 and nv <= REG_VECS else 0


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
    d = x.shape[-1] if x.dim() else 0
    index = x.get_device()  # -1 on the CPU
    x_code, s_code = _DTYPE_CODES.get(x.dtype), _DTYPE_CODES.get(scale.dtype)
    # the refusals of check_args, in cheap tests first
    if not (d and index >= 0 and scale.get_device() == index and x_code is not None and s_code is not None
            and scale.shape == (d,) and x.is_contiguous() and scale.is_contiguous()):
        check_args(x, scale)
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return rmsnorm_cuda(x, scale, eps)
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    lib = _LIB or _lib()
    xp, sp, yp = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    nv = body(d, x.element_size(), (xp | sp | yp) & 15 == 0)
    err = lib.repro_rmsnorm(xp, sp, yp, rows, d, x_code, s_code, eps, nv, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        msg = lib.repro_rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm launch failed: cudaError {err} ({msg})")
    launches += 1
    body_launches["registers" if nv else "two_reads"] += 1
    return out
