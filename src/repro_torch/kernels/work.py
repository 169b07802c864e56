"""The work of the port's kernels as closed forms of their shapes: the
FLOPs of their products and the device-memory bytes they move.

Two kinds of number, one place for both:

- a **bound**: the least work of the function (each input read once, each
  output written once; the products over the pairs the mask lets through).
  ``chip_smoke.py`` divides it by the card's rates for ``bound_ms``;
- a **kernel record**: what the CUDA kernel does for those shapes. A
  flash kernel computes whole tiles, so its products count every (query
  block, key tile) pair it visits (:func:`flash_tiles`, the loop bounds of
  ``csrc/flash_attention*.cu``). Its bytes are the compulsory ones, as in
  the bound, plus the buffers the kernel writes for its own use (the
  forward's log-sum-exp, the backward's row sums): the re-reads of K and V
  tiles across query blocks are not counted.

The meta routes (``kernels/meta.py``) append kernel records to every
:func:`recording` that is open; the dry run (``launch/dryrun.py``) adds
them to what ``FlopCounterMode`` and its byte counter see, since a meta
route runs no aten op that does the work. Nothing here touches a device.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.launch.mesh import SM_COUNT

# (query rows, keys) of a block's tile in each flash kernel, by route and
# head dim: the template arguments of csrc/flash_attention_tc.cu's launch
# (64 * NWG rows, BK keys), the CUDA-core kernels' kBlockQ/kBlockK and
# kBQ/kBK, and the tensor-core backward's kB
FWD_TILES = {"tensor_cores": {64: (128, 64), 128: (128, 128), 256: (64, 64)}, "cuda_cores": (64, 64)}
BWD_TILES = {"tensor_cores": (64, 64), "cuda_cores": (32, 32)}
FWD_PRODUCTS = 2  # S = QK^T and O = PV
BWD_PRODUCTS = 7  # dkdv: S, dP, dV, dK; dq: S, dP, dQ
BWD_LEAST_PRODUCTS = 5  # S, dP, dV, dK, dQ


@dataclass(frozen=True)
class KernelWork:
    """One kernel launch's work: its name, the FLOPs of its products and
    the bytes it moves to and from device memory."""

    name: str
    flops: int
    bytes: int


_RECORDINGS: list[list[KernelWork]] = []


@contextlib.contextmanager
def recording():
    """Collect the :class:`KernelWork` of every meta-route launch made
    inside the block, in order, into the list it yields."""
    out: list[KernelWork] = []
    _RECORDINGS.append(out)
    try:
        yield out
    finally:
        _RECORDINGS.remove(out)


def record(name: str, flops: int, nbytes: int) -> None:
    work = KernelWork(name, int(flops), int(nbytes))
    for out in _RECORDINGS:
        out.append(work)


def nbytes(*shapes_dtypes) -> int:
    """Bytes of ``(shape, dtype)`` pairs or tensors, summed."""
    total = 0
    for x in shapes_dtypes:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        else:
            shape, dtype = x
            total += int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return total


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def _key_span(q_first, q_last, s: int, t: int, causal: bool, window: int):
    """[begin, end) of the keys rows ``q_first..q_last`` see, queries
    right-aligned at ``t - s`` (numpy arrays of row indices)."""
    off = t - s
    end = np.minimum(t, q_last + off + 1) if causal else np.full_like(q_last, t)
    begin = np.maximum(0, q_first + off - window + 1) if window > 0 else np.zeros_like(q_first)
    return begin, end


def attended_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, per (batch row, head)."""
    rows = np.arange(s, dtype=np.int64)
    begin, end = _key_span(rows, rows, s, t, causal, window)
    return int(np.maximum(end - begin, 0).sum())


def flash_tiles(s: int, t: int, causal: bool, window: int, bq: int, bk: int) -> int:
    """(query block, key tile) pairs a flash kernel visits per (batch row,
    head): each block of ``bq`` query rows walks the ``bk``-key tiles from
    the first its first row sees to the last its last row sees."""
    q0 = np.arange(0, s, bq, dtype=np.int64)
    begin, end = _key_span(q0, np.minimum(q0 + bq, s) - 1, s, t, causal, window)
    tiles = (end + bk - 1) // bk - begin // bk
    return int(np.maximum(tiles, 0).sum())


def _fwd_tile(route: str, d: int) -> tuple[int, int]:
    tiles = FWD_TILES[route]
    return tiles[d] if route == "tensor_cores" else tiles


def flash_fwd_bound(b, s, t, h, kh, d, causal, window, itemsize) -> tuple[int, int]:
    """(FLOPs, bytes) of the least forward: QK^T and PV over the attended
    pairs; q, k, v read and o written once."""
    flops = 2 * FWD_PRODUCTS * d * b * h * attended_pairs(s, t, causal, window)
    return flops, itemsize * d * (2 * b * s * h + 2 * b * t * kh)


def flash_bwd_bound(b, s, t, h, kh, d, causal, window, itemsize) -> tuple[int, int]:
    """(FLOPs, bytes) of the least backward: S again, dP, dV, dK and dQ
    over the attended pairs; q, k, v, o, dout and the f32 log-sum-exp read,
    dq, dk and dv written once."""
    flops = 2 * BWD_LEAST_PRODUCTS * d * b * h * attended_pairs(s, t, causal, window)
    nb = itemsize * d * (3 * b * s * h + 2 * b * t * kh) + 4 * b * h * s
    return flops, nb + itemsize * d * (b * s * h + 2 * b * t * kh)


def flash_fwd_work(b, s, t, h, kh, d, causal, window, itemsize, route: str, lse: bool) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward launch on ``route``: its products over
    every tile it visits, the bound's bytes and the log-sum-exp it writes
    for a backward (``lse``)."""
    bq, bk = _fwd_tile(route, d)
    flops = 2 * FWD_PRODUCTS * d * bq * bk * b * h * flash_tiles(s, t, causal, window, bq, bk)
    _, nb = flash_fwd_bound(b, s, t, h, kh, d, causal, window, itemsize)
    return flops, nb + (4 * b * h * s if lse else 0)


def flash_bwd_work(b, s, t, h, kh, d, causal, window, itemsize, route: str) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward launch on ``route`` (its row-dot,
    dk/dv and dq kernels): seven products over every tile the dq kernel
    visits (the dk/dv kernel walks the same pairs from the key side), the
    bound's bytes and the f32 row sums written and read twice."""
    bq, bk = BWD_TILES[route]
    flops = 2 * BWD_PRODUCTS * d * bq * bk * b * h * flash_tiles(s, t, causal, window, bq, bk)
    _, nb = flash_bwd_bound(b, s, t, h, kh, d, causal, window, itemsize)
    return flops, nb + 3 * 4 * b * h * s


# ---------------------------------------------------------------------------
# The SSD intra-chunk block
# ---------------------------------------------------------------------------


def ssd_fwd_flops(b, s, h, p, n, chunk) -> int:
    """The least f32 work of the forward block: C.B^T and M.x over the
    causal half of each chunk (C.B^T once a batch row and chunk), and the
    chunk state over all of it."""
    nc, pairs = s // chunk, chunk * (chunk + 1) // 2
    return b * nc * (2 * n * pairs + h * (2 * p * pairs + 2 * chunk * p * n))


def ssd_fwd_bytes(b, s, h, p, n, chunk, x_itemsize) -> int:
    """x, dt, cum, B and C read, y and S (f32) written once."""
    nc = s // chunk
    return x_itemsize * b * s * h * p + 4 * (2 * b * s * h + 2 * b * s * n) + 4 * (b * s * h * p + b * nc * h * p * n)


def ssd_bwd_flops(b, s, h, p, n, chunk) -> int:
    """The least f32 work of the backward: C.B^T over the causal half of a
    chunk once a (batch row, chunk); a head's G = dy.x^T and M^T.dy over the
    causal half, dS.B_s and dS^T.x_s over every step; D.B and D^T.C over the
    causal half once a (batch row, chunk), D summed over the heads first
    (linear in D, C and B the same for every head), as csrc/ssd_scan_bwd.cu
    forms them (2 FLOPs a multiply-add)."""
    pairs = chunk * (chunk + 1) // 2
    return b * (s // chunk) * (2 * n * pairs + 4 * n * pairs + h * (4 * p * pairs + 4 * chunk * p * n))


def ssd_bwd_bytes(b, s, h, p, n, chunk, x_itemsize) -> int:
    """The forward's inputs, dy and dS read; dx (x's dtype), ddt, dcum, dB
    and dC (f32) written once."""
    fwd_in = x_itemsize * b * s * h * p + 4 * (2 * b * s * h + 2 * b * s * n)
    grads_in = 4 * (b * s * h * p + b * (s // chunk) * h * p * n)
    return 2 * fwd_in + grads_in


def _head_groups(b, s, h, chunk, blocks_per_sm: int, sms: int) -> int:
    bcs = b * (s // chunk)
    groups = min(h, max(1, blocks_per_sm * sms // bcs))
    return -(-h // -(-h // groups))


def ssd_tensor_core_flops(b, s, h, p, n, chunk, x_is_bf16: bool, sms: int = SM_COUNT) -> int:
    """The TF32 tensor-core FLOPs the SSD kernel issues (mma.sync m16n8k8, 2048
    FLOPs each): C.B^T once a block in 3 products (4 x 8 tiles, 16 k-steps);
    a head's y = M.x over the k-steps at or below the diagonal (20 of the 32
    k-step rows of its 4 m-tiles, 8 n-tiles) and S = x^T.(w o B) (4 x 16
    tiles, 8 k-steps), each in 3 products, or 2 for a bf16 x (exact in TF32).
    A block takes a group of heads, as many groups as one wave of two blocks
    an SM holds (csrc/ssd_scan.cu); ``sms`` is the card's SM count."""
    bcs = b * (s // chunk)
    groups = _head_groups(b, s, h, chunk, 2, sms)
    per_head = (20 * 8 + 4 * 16 * 8) * (2 if x_is_bf16 else 3)
    return 2048 * (bcs * groups * 4 * 8 * 16 * 3 + bcs * h * per_head)


def ssd_bwd_tensor_core_flops(b, s, h, p, n, chunk, x_is_bf16: bool, sms: int = SM_COUNT) -> int:
    """The TF32 tensor-core FLOPs the SSD backward issues (mma.sync m16n8k8,
    2048 FLOPs each), on the 16 x 16 blocks at or below the diagonal where
    an operand is causal: once a block, C.B^T (10 blocks of 2 n-tiles, 16
    k-steps) and D^T.C and D.B of D summed over its heads (20 m-tile k-steps
    of 16 n-tiles each), 3 products each; a head's G = dy.x^T (10 blocks of
    2 n-tiles, 8 k-steps) and x.dS (4 x 16 tiles, 8 k-steps), 3 products
    each or 2 for a bf16 x (exact in TF32), B.dS^T (4 x 8 tiles, 16
    k-steps) and M^T.dy (20 m-tile k-steps of 8 n-tiles), 3 products each.
    A block takes a group of heads, as many groups as one wave of one block
    an SM holds (csrc/ssd_scan_bwd.cu)."""
    bcs = b * (s // chunk)
    groups = _head_groups(b, s, h, chunk, 1, sms)
    x_passes = 2 if x_is_bf16 else 3
    per_block = (10 * 2 * 16 + 2 * 20 * 16) * 3
    per_head = (10 * 2 * 8 + 4 * 16 * 8) * x_passes + (4 * 8 * 16 + 20 * 8) * 3
    return 2048 * (bcs * groups * per_block + bcs * h * per_head)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_bytes(rows: int, d: int, x_itemsize: int, scale_itemsize: int) -> int:
    """x read and the output written once, the scale read once. The kernel
    has no products."""
    return 2 * rows * d * x_itemsize + d * scale_itemsize
