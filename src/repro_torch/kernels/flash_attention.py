"""Flash attention on the GPU: the wrappers of the hand-written CUDA kernels
and the ``torch.autograd.Function`` that joins them.

Two routes, chosen by :func:`route`, a pure function of (dtype, head dim)
taken before the launch, a dispatch by shape and not a fallback:

- ``"tensor_cores"``, bf16 at head dims 64, 128 and 256:
  ``csrc/flash_attention_tc.cu`` (forward) and
  ``csrc/flash_attention_bwd_tc.cu`` (backward), bf16 products on wgmma
  with fp32 sums and softmax statistics;
- ``"cuda_cores"``, float32 (TF32 would miss its tolerance) and bf16 at
  head dims 16 and 32: ``csrc/flash_attention.cu`` and
  ``csrc/flash_attention_bwd.cu``, fp32 FMAs throughout.

A launch that fails raises; nothing retries on the other route. Passing
``route=`` names a route explicitly (``chip_smoke.py`` runs both where both
take the case); the tensor-core route refuses what it does not take.

It replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_pallas``) and computes the same function: causal and
sliding-window masks, GQA (q head ``hi`` reads kv head ``hi // (h/kh)``),
queries right-aligned at ``t - s``, fp32 softmax statistics, output in
q's dtype.
Its plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`;
``ops.flash_attention`` picks between the two by the tensors' device, and
on the card calls :func:`flash_attention`, the autograd Function: its
forward launches the forward kernel (writing each row's log-sum-exp when a
gradient will be needed) and its backward launches the backward kernel,
which computes dq, dk and dv (dk and dv summed over each GQA group)
deterministically. The TPU kernel has no backward; the JAX package trains
through its plain version.

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
TC_HEAD_DIMS = (64, 128, 256)
ROUTES = ("tensor_cores", "cuda_cores")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # heads and batch are grid dimensions

# Kernel launches in this process; each is bumped once per launch of its
# kernel, nowhere else. ``launches`` and ``bwd_launches`` count every
# launch; the ``tc_`` and ``cc_`` counts split them by route.
launches = 0
bwd_launches = 0
tc_launches = 0
cc_launches = 0
tc_bwd_launches = 0
cc_bwd_launches = 0


def route(dtype: torch.dtype, d: int) -> str:
    """The route of a (dtype, head dim): the tensor cores for bf16 at
    :data:`TC_HEAD_DIMS`, the CUDA cores for everything else."""
    return "tensor_cores" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "cuda_cores"


def _pick_route(q: torch.Tensor, chosen: str | None) -> str:
    if chosen is None:
        return route(q.dtype, q.shape[-1])
    if chosen not in ROUTES:
        raise ValueError(f"route {chosen!r} not in {ROUTES}")
    if chosen == "tensor_cores" and route(q.dtype, q.shape[-1]) != chosen:
        raise ValueError(f"the tensor-core route takes bf16 at head dims {TC_HEAD_DIMS}, "
                         f"not {q.dtype} at {q.shape[-1]}")
    return chosen


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> (its launch function, its error-string function, the launch's argument types)
_ENTRY = {
    "flash_attention": ("repro_flash_attention_fwd", "repro_cuda_error_string", [_P] * 5 + [_I] * 9 + [_F, _P]),
    "flash_attention_tc": ("repro_flash_attention_fwd_tc", "repro_flash_tc_error_string",
                           [_P] * 5 + [_I] * 8 + [_F, _P]),
    "flash_attention_bwd": ("repro_flash_attention_bwd", "repro_flash_bwd_error_string",
                            [_P] * 10 + [_I] * 9 + [_F, _P]),
    "flash_attention_bwd_tc": ("repro_flash_attention_bwd_tc", "repro_flash_bwd_tc_error_string",
                               [_P] * 10 + [_I] * 8 + [_F, _P]),
}


def _entry(name: str):
    """(launch function, error-string function) of library ``name``, loaded
    (built first if needed) and typed."""
    lib = build.load(name)
    fn_name, err_name, argtypes = _ENTRY[name]
    fn, err_fn = getattr(lib, fn_name), getattr(lib, err_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    return fn, err_fn


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
    return_lse: bool = False,
    route: str | None = None,
):
    """Launch the forward kernel of ``route`` (default :func:`route` of the
    inputs) on torch's current stream; no synchronisation. Returns the
    output, or (output, lse) with ``return_lse``: each row's log-sum-exp of
    the scaled scores, fp32, ``(b, h, s)``."""
    global launches, tc_launches, cc_launches
    check_args(q, k, v, causal, window)
    chosen = _pick_route(q, route)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_cuda needs CUDA tensors on one device, got {q.device}, {k.device}, {v.device}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if chosen == "tensor_cores":
            fn, msg = _entry("flash_attention_tc")
            err = fn(*ptrs, b, s, t, h, kh, d, int(causal), int(window), float(scale), stream)
        else:
            fn, msg = _entry("flash_attention")
            err = fn(*ptrs, b, s, t, h, kh, d, _DTYPE_CODES[q.dtype], int(causal), int(window), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed ({chosen}): cudaError {err} ({msg(err).decode()})")
    launches += 1
    if chosen == "tensor_cores":
        tc_launches += 1
    else:
        cc_launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels of ``route`` (default :func:`route` of
    the inputs) on torch's current stream: (dq, dk, dv) of the forward that
    gave ``out`` and ``lse``, for the output gradient ``dout``; no
    synchronisation."""
    global bwd_launches, tc_bwd_launches, cc_bwd_launches
    check_args(q, k, v, causal, window)
    chosen = _pick_route(q, route)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    for name, x, shape, dtype in (("out", out, q.shape, q.dtype), ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (b, h, s), torch.float32)):
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {tuple(shape)} {dtype}, got {tuple(x.shape)} {x.dtype}")
    tensors = (q, k, v, out, lse, dout)
    if not all(x.is_cuda and x.device == q.device for x in tensors):
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors on one device, got {[str(x.device) for x in tensors]}")
    if any(x.data_ptr() % 16 for x in (out, dout)):
        raise ValueError("out and dout must start on a 16-byte boundary")
    if scale is None:
        scale = d**-0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if chosen == "tensor_cores":
            fn, msg = _entry("flash_attention_bwd_tc")
            err = fn(*ptrs, b, s, t, h, kh, d, int(causal), int(window), float(scale), stream)
        else:
            fn, msg = _entry("flash_attention_bwd")
            err = fn(*ptrs, b, s, t, h, kh, d, _DTYPE_CODES[q.dtype], int(causal), int(window), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed ({chosen}): cudaError {err} ({msg(err).decode()})")
    bwd_launches += 1
    if chosen == "tensor_cores":
        tc_bwd_launches += 1
    else:
        cc_bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient, both on
    one route (``None``: :func:`route` of the inputs)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float | None, route: str | None = None):
        need_grad = any(ctx.needs_input_grad[:3])
        res = flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale, return_lse=need_grad,
                                   route=route)
        if not need_grad:
            return res
        out, lse = res
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale, route=route)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, scale: float | None = None,
                    route: str | None = None):
    """Attention on the card, differentiable: the forward kernel, and the
    backward kernel when autograd asks for a gradient."""
    return FlashAttention.apply(q, k, v, causal, window, scale, route)
