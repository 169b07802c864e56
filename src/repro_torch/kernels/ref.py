"""Plain-PyTorch versions of the kernels in this package.

Each one is written out as its counterpart in ``repro/kernels/ref.py``:
fp32 scores, a ``-1e30`` mask value, softmax, cast back to the input dtype.
The reshard row copies follow ``pack_rows_ref`` & co. there: a loop of
slice copies in block order; the compressed wire's quantizers follow
``pack_quant_rows_ref`` and ``dequant_scatter_rows_ref``; the Mamba-2 SSD
scan and RMSNorm follow ``ssd_scan_ref`` and ``rmsnorm_ref``, with
:func:`ssd_intra_chunk_ref` the function of the TPU kernel
``_ssd_chunk_kernel`` over its whole grid. They are the CPU path of
``ops.py`` and what the CUDA kernels are held against on the card.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (b, s, h, d)
    k: torch.Tensor,  # (b, t, kh, d)
    v: torch.Tensor,  # (b, t, kh, d)
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    rep = h // kh
    if scale is None:
        scale = d**-0.5
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v.float(), rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, kf)
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)  # right-aligned when t != s
    kpos = torch.arange(t, device=q.device)[None, :]
    if causal:
        mask = kpos <= qpos
    else:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    return out.to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (b, 1, h, d)
    k: torch.Tensor,  # (b, T, kh, d)
    v: torch.Tensor,
    mask: torch.Tensor,  # broadcastable to (b, 1, 1, T)
    scale: float,
) -> torch.Tensor:
    h, kh = q.shape[2], k.shape[2]
    rep = h // kh
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v.float(), rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, kf)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunked scan
# ---------------------------------------------------------------------------


def ssd_intra_chunk_ref(
    x: torch.Tensor,  # (b, s, h, p) float
    dt: torch.Tensor,  # (b, s, h) float32, post-softplus
    cum: torch.Tensor,  # (b, s, h) float32, within-chunk inclusive cumsum of dt*A
    B: torch.Tensor,  # (b, s, n) float32
    C: torch.Tensor,  # (b, s, n) float32
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """What ``repro/kernels/ssd_scan.py::_ssd_chunk_kernel`` computes over
    its whole (batch, head, chunk) grid. Per chunk of ``q`` steps and head:
    ``y = ((C·Bᵀ) ∘ L ∘ dtᵀ)·x`` with ``L[t, s] = exp(cum_t - cum_s)`` for
    ``s <= t`` (else 0), and the chunk's state ``S = Σ_s exp(cum_last -
    cum_s)·dt_s·x_s ⊗ B_s``. Returns (y_intra (b,s,h,p) f32, S (b,nc,h,p,n)
    f32). ``s`` must be a multiple of ``chunk``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc, q = s // chunk, chunk
    xf = x.float().reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    cumc = cum.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)
    diff = cumc[:, :, :, None, :] - cumc[:, :, None, :, :]  # (b,nc,t,s,h)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (b,nc,t,s)
    M = CB[..., None] * L * dtc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", M, xf).reshape(b, s, h, p)
    decay_to_end = torch.exp(cumc[:, :, -1:, :] - cumc)  # (b,nc,q,h)
    S = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_to_end * dtc, Bc, xf)
    return y, S


def ssd_inter_ref(cum, Cc, S, chunk_decay, init_state):
    """The inter-chunk recurrence (``repro/kernels/ops.py::_ssd_inter``), a
    loop over chunks. cum (b,nc,q,h); Cc (b,nc,q,n); S (b,nc,h,p,n);
    chunk_decay (b,nc,h); init_state (b,h,p,n). Returns (y_inter
    (b,nc,q,h,p), final state (b,h,p,n))."""
    carry, h_prevs = init_state, []
    for c in range(S.shape[1]):
        h_prevs.append(carry)  # the state entering chunk c
        carry = chunk_decay[:, c, :, None, None] * carry + S[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (b,nc,h,p,n)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) * torch.exp(cum)[..., None]
    return y_inter, carry


def ssd_scan_ref(
    x: torch.Tensor,  # (b, s, h, p) float
    dt: torch.Tensor,  # (b, s, h) float32, post-softplus
    A: torch.Tensor,  # (h,) float32, negative
    B: torch.Tensor,  # (b, s, n) float32
    C: torch.Tensor,  # (b, s, n) float32
    chunk: int,
    init_state: torch.Tensor | None = None,  # (b, h, p, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan (``repro/kernels/ref.py::ssd_scan_ref``):
    intra-chunk quadratic part, chunk states, inter-chunk recurrence.
    Returns (y (b,s,h,p) float32, final state (b,h,p,n) float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc, q = s // chunk, chunk
    cum = torch.cumsum(dt.reshape(b, nc, q, h) * A[None, None, None, :], dim=2)  # inclusive
    y_intra, S = ssd_intra_chunk_ref(x, dt, cum.reshape(b, s, h), B, C, chunk)
    h0 = x.new_zeros((b, h, p, n), dtype=torch.float32) if init_state is None else init_state.float()
    y_inter, final = ssd_inter_ref(cum, C.reshape(b, nc, q, n).float(), S, torch.exp(cum[:, :, -1, :]), h0)
    y = y_intra.reshape(b, nc, q, h, p) + y_inter
    return y.reshape(b, s, h, p), final


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Row RMSNorm over the last axis: float32 mean of squares,
    ``rsqrt(var + eps)``, times the scale, cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Reshard row copies (staging-buffer assembly)
# ---------------------------------------------------------------------------


def _not_int64(what: str, starts) -> ValueError:
    """The refusal of starts that are not all int64 integers, naming the
    first start that is not an integer (a fractional one first), else the
    first past int64."""
    odd = [s for s in starts if not isinstance(s, (int, np.integer))]
    if odd:
        bad = next((s for s in odd if not (isinstance(s, (float, np.floating)) and float(s).is_integer())), odd[0])
        return ValueError(f"{what}: start {bad!r} is not an integer")
    big = next(s for s in starts if not -(2**63) <= int(s) < 2**63)
    return ValueError(f"{what}: start {big} lies past int64")


def row_starts(starts, block_rows: int, rows: int, what: str) -> np.ndarray:
    """``starts`` as a host int64 array, checked: every block of
    ``block_rows`` rows from a start lies inside ``rows`` rows.

    The JAX references clamp a start that runs past the end back into range
    (``dynamic_slice``) and truncate a float start; no caller builds either,
    so the port refuses both on every device, whatever the form of
    ``starts`` (list, tuple, numpy array, tensor), instead of moving other
    rows than were named. Integers of any kind pass, and so does an empty
    sequence.
    """
    if isinstance(starts, torch.Tensor):
        if starts.is_floating_point() or starts.is_complex():
            raise _not_int64(what, starts.reshape(-1)[:8].tolist())
        starts = starts.detach().cpu().numpy()
    if isinstance(starts, list) and len(starts) > 1:  # struct reads a long list of ints ~2x faster
        try:
            out = np.frombuffer(bytearray(struct.pack(f"{len(starts)}q", *starts)), dtype=np.int64)
        except struct.error:
            raise _not_int64(what, starts) from None
    else:
        arr = np.asarray(starts)
        if arr.size and arr.dtype.kind not in "iub":
            raise _not_int64(what, starts if isinstance(starts, (list, tuple)) else arr.reshape(-1).tolist())
        out = arr.astype(np.int64).reshape(-1)
    if block_rows < 1:
        raise ValueError(f"{what}: block_rows {block_rows} < 1")
    if out.size:
        lo, hi = (int(out[0]),) * 2 if out.size == 1 else (out.min(), out.max())
        if lo < 0 or hi + block_rows > rows:
            bad = out[(out < 0) | (out + block_rows > rows)]
            raise ValueError(
                f"{what}: blocks of {block_rows} rows at starts {bad[:8].tolist()} "
                f"leave the {rows} rows of the array"
            )
    return out


def disjoint_blocks(st: np.ndarray, block_rows: int) -> bool:
    """Whether no row lies in two of the blocks of ``block_rows`` rows at
    the starts ``st`` (one sort)."""
    s = np.sort(st)
    return bool(np.all(np.diff(s) >= block_rows))


def pack_rows_ref(src: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    """Gather ``len(starts)`` blocks of ``block_rows`` rows of ``src`` (R, C)
    into a fresh (nb*block_rows, C) buffer, block by block."""
    st = row_starts(starts, block_rows, src.shape[0], "pack_rows")
    out = src.new_empty((st.size * block_rows, src.shape[1]))
    for i, s in enumerate(st.tolist()):
        out[i * block_rows : (i + 1) * block_rows] = src[s : s + block_rows]
    return out


def unpack_rows_ref(buf: torch.Tensor, starts, block_rows: int, out_rows: int) -> torch.Tensor:
    """Scatter buffer blocks into a zero (out_rows, C) array, in block
    order (the last block wins where blocks overlap)."""
    st = row_starts(starts, block_rows, out_rows, "unpack_rows")
    out = buf.new_zeros((out_rows, buf.shape[1]))
    for i, s in enumerate(st.tolist()):
        out[s : s + block_rows] = buf[i * block_rows : (i + 1) * block_rows]
    return out


def scatter_rows_ref(dst: torch.Tensor, buf: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    """Overwrite-scatter buffer blocks into ``dst`` in place and return it:
    rows no block names keep their bytes, the last block wins where blocks
    overlap, and applying it twice changes nothing."""
    st = row_starts(starts, block_rows, dst.shape[0], "scatter_rows")
    for i, s in enumerate(st.tolist()):
        dst[s : s + block_rows] = buf[i * block_rows : (i + 1) * block_rows]
    return dst


def relayout_rows_ref(dst: torch.Tensor, src: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    """Copy the named row blocks of ``src`` into ``dst`` at the same rows,
    in place, and return ``dst`` (pack then scatter with one offset table,
    without the staging buffer)."""
    st = row_starts(starts, block_rows, dst.shape[0], "relayout_rows")
    for s in st.tolist():
        dst[s : s + block_rows] = src[s : s + block_rows]
    return dst


# ---------------------------------------------------------------------------
# The compressed wire: per-tile symmetric quantization
# ---------------------------------------------------------------------------

# the floor of a tile's scale: all-zero (and denormal) tiles quantize to 0
QUANT_EPS = 1e-12
WIRE_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}
WIRE_QDTYPE = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


def _block_rows_index(st: np.ndarray, block_rows: int, device) -> torch.Tensor:
    return torch.as_tensor((st[:, None] + np.arange(block_rows)).reshape(-1), device=device)


def pack_quant_rows_ref(src: torch.Tensor, starts, block_rows: int, fmt: str):
    """Gather ``len(starts)`` tiles of ``block_rows`` rows of ``src`` (R, C)
    and quantize each symmetrically with its own scale, as
    ``repro.kernels.ref.pack_quant_rows_ref``: ``scale = max(absmax, eps) *
    float32(1/qmax)`` (the reciprocal folded to one float32 constant), ``q =
    x / scale``; int8 rounds half to even and clips to +-127, fp8-e4m3
    casts. Returns ((nb*block_rows, C) quantized, (nb, 1) float32 scales)."""
    st = row_starts(starts, block_rows, src.shape[0], "pack_quant_rows")
    nb, C = st.size, src.shape[1]
    qmax = WIRE_QMAX[fmt]
    if nb == 0:
        return (torch.empty((0, C), dtype=WIRE_QDTYPE[fmt], device=src.device),
                torch.empty((0, 1), dtype=torch.float32, device=src.device))
    blocks = src[_block_rows_index(st, block_rows, src.device)].to(torch.float32)
    blocks = blocks.reshape(nb, block_rows, C)
    absmax = torch.amax(torch.abs(blocks), dim=(1, 2))
    scales = torch.clamp_min(absmax, QUANT_EPS) * float(np.float32(1.0 / qmax))
    y = blocks / scales[:, None, None]
    if fmt == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = y.to(torch.float8_e4m3fn)
    return q.reshape(nb * block_rows, C), scales[:, None]


def dequant_scatter_rows_ref(dst: torch.Tensor, buf: torch.Tensor, scales: torch.Tensor, starts, block_rows: int):
    """Dequantize each tile with its sidecar scale (``q * scale`` in float32,
    cast to ``dst``'s dtype) and overwrite-scatter it into ``dst`` in place,
    as ``repro.kernels.ref.dequant_scatter_rows_ref``: rows no tile names
    keep their bytes, the last tile wins where tiles overlap. Returns ``dst``."""
    st = row_starts(starts, block_rows, dst.shape[0], "dequant_scatter_rows")
    nb, C = st.size, dst.shape[1]
    if tuple(buf.shape) != (nb * block_rows, C) or tuple(scales.shape) != (nb, 1):
        raise ValueError(
            f"dequant_scatter_rows: buffer {tuple(buf.shape)} / scales {tuple(scales.shape)} are not "
            f"{nb} tiles of {block_rows} rows of {C}"
        )
    if nb == 0:
        return dst
    blocks = buf.reshape(nb, block_rows, C).to(torch.float32)
    deq = (blocks * scales.reshape(nb)[:, None, None]).to(dst.dtype)
    if disjoint_blocks(st, block_rows):  # no row named twice: one indexed write
        dst[_block_rows_index(st, block_rows, dst.device)] = deq.reshape(nb * block_rows, C)
        return dst
    for i, s in enumerate(st.tolist()):
        dst[s : s + block_rows] = deq[i]
    return dst


def quant_round_trip_ref(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """What the compressed wire delivers for every row of ``x`` (rows = dim
    0, one tile each, the executor's ``block_rows=1``): dequantize(quantize)."""
    x2 = x.reshape(x.shape[0], -1)
    rows = np.arange(x2.shape[0])
    q, scales = pack_quant_rows_ref(x2, rows, 1, fmt)
    return dequant_scatter_rows_ref(torch.empty_like(x2), q, scales, rows, 1).reshape(x.shape)
