"""Flash attention (forward) on the GPU: the wrapper of the hand-written
CUDA kernel in ``csrc/flash_attention.cu``.

It replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_pallas``) and computes the same function: causal and
sliding-window masks, GQA (q head ``hi`` reads kv head ``hi // (h/kh)``),
queries right-aligned at ``t - s``, fp32 arithmetic, output in q's dtype.
Its plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`;
``ops.flash_attention`` picks between the two by the tensors' device.

Unlike the TPU kernel, it takes any ``s`` and ``t`` (the ragged edge is
masked in the kernel), so nothing falls back to the plain version on the
card. It refuses what it does not compute: a head dim outside
:data:`HEAD_DIMS`, a dtype other than float32/bfloat16, non-contiguous or
non-CUDA tensors, storage not 16-byte aligned, and causal ``t < s``, where
the first query rows would see no key at all (no caller builds that case).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # grid.y = heads, grid.z = batch

# Kernel launches in this process; bumped once per launch, nowhere else.
launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int):
    """Raise ``ValueError`` for anything the kernel does not compute."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (b,s,h,d), k = v (b,t,kh,d); got {q.shape}, {k.shape}, {v.shape}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    if kh == 0 or h % kh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want all float32 or all bfloat16")
    if min(b, s, t) == 0 or b > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError(f"unsupported sizes b={b} s={s} t={t} h={h}")
    if causal and t < s:
        raise ValueError(f"causal attention with t={t} < s={s}: the first query rows see no key")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the kernel loads 16 bytes a thread)")


def flash_attention_cuda(
    q: torch.Tensor,  # (b, s, h, d)
    k: torch.Tensor,  # (b, t, kh, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch the kernel on torch's current stream; no synchronisation."""
    global launches
    check_args(q, k, v, causal, window)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_cuda needs CUDA tensors on one device, got {q.device}, {k.device}, {v.device}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kh, d, _DTYPE_CODES[q.dtype], int(causal), int(window),
            float(scale), stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash attention launch failed: cudaError {err} ({msg})")
    launches += 1
    return out
