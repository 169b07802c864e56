"""The meta routes of the kernels the model's step reaches: flash attention
forward and backward, the SSD intra-chunk block forward and backward, and
RMSNorm.

A meta route is shape-only. It returns empty meta tensors of the shapes
and dtypes the CUDA kernel returns, allocates on meta what the kernel
allocates (the forward's log-sum-exp, saved for the backward; the
backward's row sums), and records the kernel's work (``kernels/work.py``:
the FLOPs of the products over the tiles it visits, the bytes it moves)
into every open ``work.recording()``. The plain version never runs here:
at ``prefill_32k`` its scores alone would be 32 x 32 x 32768^2 floats in
the dry run's peak.

``ops`` takes these routes for meta tensors and nothing else; each entry
refuses a tensor that is not on the meta device, so a CUDA tensor never
reaches them and a meta tensor never reaches a kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import work


def _check_meta(name: str, tensors) -> None:
    if not all(t.device.type == "meta" for t in tensors):
        raise ValueError(f"{name}: the meta route takes meta tensors, got {[str(t.device) for t in tensors]}")


def _flash_dims(q, k, v, causal: bool):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"want q (b,s,h,d), k = v (b,t,kh,d); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if kh == 0 or h % kh or d not in _fa.HEAD_DIMS or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention does not take heads {h}/{kh}, head dim {d}, dtype {q.dtype}")
    if causal and t < s:
        raise ValueError(f"causal attention with t={t} < s={s}: the first query rows see no key")
    return b, s, t, h, kh, d


class FlashAttentionMeta(torch.autograd.Function):
    """The flash kernels' shapes and work: the forward, and the backward
    when autograd asks for a gradient, on :func:`flash_attention.route`'s
    route."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        _check_meta("flash_attention", (q, k, v))
        dims = _flash_dims(q, k, v, causal)
        b, s, t, h, kh, d = dims
        need_grad = any(ctx.needs_input_grad[:3])
        route = _fa.route(q.dtype, d)
        work.record("flash_attention",
                    *work.flash_fwd_work(*dims, causal, window, q.element_size(), route, lse=need_grad))
        out = torch.empty_like(q)
        if need_grad:
            lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.opts = (dims, causal, window, route)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _, _ = ctx.saved_tensors
        dims, causal, window, route = ctx.opts
        b, s, _, h, _, _ = dims
        work.record("flash_attention_bwd", *work.flash_bwd_work(*dims, causal, window, q.element_size(), route))
        dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        del dsum
        return (*grads, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, scale: float | None = None):
    """Attention on meta tensors, differentiable (``scale`` changes no
    shape or work)."""
    return FlashAttentionMeta.apply(q, k, v, causal, window)


class SSDIntraChunkMeta(torch.autograd.Function):
    """The SSD block kernels' shapes and work, forward and backward."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C, chunk: int):
        _check_meta("ssd_intra_chunk", (x, dt, cum, B, C))
        b, s, h, p = x.shape
        n = B.shape[-1]
        if s % chunk:
            raise ValueError(f"sequence {s} is not a multiple of chunk {chunk} (ops.ssd_scan pads it)")
        dims = (b, s, h, p, n, chunk)
        work.record("ssd_intra_chunk", work.ssd_fwd_flops(*dims), work.ssd_fwd_bytes(*dims, x.element_size()))
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, dt, cum, B, C)
        ctx.dims = dims
        y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
        S = torch.empty((b, s // chunk, h, p, n), dtype=torch.float32, device=x.device)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        x, dt, cum, B, C = ctx.saved_tensors
        dims = ctx.dims
        work.record("ssd_intra_chunk_bwd", work.ssd_bwd_flops(*dims), work.ssd_bwd_bytes(*dims, x.element_size()))
        return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(cum), torch.empty_like(B),
                torch.empty_like(C), None)


def ssd_intra_chunk(x, dt, cum, B, C, chunk: int):
    """The intra-chunk block on meta tensors, differentiable."""
    return SSDIntraChunkMeta.apply(x, dt, cum, B, C, chunk)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm on meta tensors (not differentiable, as the kernel is not)."""
    _check_meta("rmsnorm", (x, scale))
    if x.dim() < 1 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"want x (..., d) and scale (d,), got {tuple(x.shape)}, {tuple(scale.shape)}")
    d = x.shape[-1]
    work.record("rmsnorm", 0, work.rmsnorm_bytes(x.numel() // max(d, 1), d, x.element_size(), scale.element_size()))
    return torch.empty_like(x)
