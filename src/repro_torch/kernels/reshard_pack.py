"""Row copies of the reshard data plane on the GPU: the wrappers of the four
hand-written CUDA kernels in ``csrc/reshard_pack.cu``.

They replace the TPU kernels of ``repro/kernels/reshard_pack.py``
(``pack_rows_pallas``, ``scatter_rows_pallas``, ``relayout_rows_pallas``,
``unpack_rows_pallas``) and compute what the JAX references compute on a
row-major ``(rows, C)`` array of any dtype, for any start:

- :func:`pack_rows_cuda` gathers ``nb`` blocks of ``block_rows`` rows into a
  fresh ``(nb*block_rows, C)`` staging buffer;
- :func:`scatter_rows_cuda` overwrite-scatters the buffer's blocks into
  ``dst`` **in place** and returns ``dst`` (the torch counterpart of the JAX
  package's donation and ``input_output_aliases``);
- :func:`relayout_rows_cuda` copies the named blocks of ``src`` into ``dst``
  at the same rows, in place;
- :func:`unpack_rows_cuda` scatters into a fresh ``(out_rows, C)`` output and
  zero-fills the rows no block covers, as the reference does (the TPU kernel
  leaves them undefined).

A TPU grid runs in order, so a repeated start resolves to the last block; a
CUDA grid does not. The wrappers resolve the last writer of every
destination row on the host (:func:`last_writer_segments`) and launch
segments that write each row once, so repeated and overlapping starts give
the reference's sequential result. Starts that would leave the array raise
``ValueError`` (``ref.row_starts``), where the JAX reference clamps them.

Each wrapper launches on torch's current stream, does not synchronise,
raises if the launch fails, and adds one to its entry of :data:`launches`
where it launches; ``nb == 0`` launches nothing. The plain versions are
``repro_torch.kernels.ref.*_rows_ref``; ``ops`` picks between the two by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import row_starts

# Kernel launches in this process, by kernel; each is bumped once per
# launch, nowhere else.
launches = {"pack_rows": 0, "unpack_rows": 0, "scatter_rows": 0, "relayout_rows": 0}

_ENTRY = {name: f"repro_{name}" for name in launches}


def _lib() -> ctypes.CDLL:
    lib = build.load("reshard_pack")
    if lib.repro_pack_rows.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for entry in _ENTRY.values():
            fn = getattr(lib, entry)
            fn.argtypes = [p, p, p, i64, i64, i64, p]
            fn.restype = ctypes.c_int
        lib.repro_rows_error_string.argtypes = [ctypes.c_int]
        lib.repro_rows_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# Host-side segment tables: (src_row, dst_row, rows) int64 triples
# ---------------------------------------------------------------------------


def _merge(src_rows: np.ndarray, dst_rows: np.ndarray) -> np.ndarray:
    """Row pairs sorted by ``dst_rows`` -> segments of consecutive pairs."""
    n = dst_rows.size
    brk = np.flatnonzero((np.diff(dst_rows) != 1) | (np.diff(src_rows) != 1)) + 1
    first = np.concatenate([[0], brk])
    lens = np.diff(np.concatenate([first, [n]]))
    return np.stack([src_rows[first], dst_rows[first], lens], axis=1).astype(np.int64)


def last_writer_segments(starts: np.ndarray, block_rows: int) -> np.ndarray:
    """Segments ``(buf_row, dst_row, rows)`` that write every row some block
    names exactly once, with the bytes of the last block naming it."""
    nb = starts.size
    if nb == 0:
        return np.zeros((0, 3), np.int64)
    s = np.sort(starts)
    if np.all(np.diff(s) >= block_rows):  # disjoint blocks: one segment each
        return np.stack(
            [np.arange(nb) * block_rows, starts, np.full(nb, block_rows)], axis=1
        ).astype(np.int64)
    # repeated or overlapping blocks: the writer of a row with the largest
    # buffer row is the last block (buffer rows grow with the block index)
    dst_rows = (starts[:, None] + np.arange(block_rows)).reshape(-1)
    rows, inverse = np.unique(dst_rows, return_inverse=True)
    winner = np.full(rows.size, -1, np.int64)
    np.maximum.at(winner, inverse, np.arange(nb * block_rows))
    return _merge(winner, rows)


def covered_segments(starts: np.ndarray, block_rows: int) -> np.ndarray:
    """Segments ``(row, row, rows)`` over the union of the named blocks."""
    if starts.size == 0:
        return np.zeros((0, 3), np.int64)
    s = np.unique(starts)
    ends = s + block_rows
    new = np.concatenate([[True], s[1:] > ends[:-1]])
    lo = s[new]
    hi = ends[np.concatenate([np.flatnonzero(new)[1:] - 1, [s.size - 1]])]
    return np.stack([lo, lo, hi - lo], axis=1).astype(np.int64)


def unpack_segments(starts: np.ndarray, block_rows: int, out_rows: int) -> np.ndarray:
    """:func:`last_writer_segments` plus zero segments ``(-1, row, rows)``
    for the rows of ``out_rows`` that no block covers."""
    segs = last_writer_segments(starts, block_rows)
    cov = covered_segments(starts, block_rows)
    gap_lo = np.concatenate([[0], cov[:, 1] + cov[:, 2]])
    gap_hi = np.concatenate([cov[:, 1], [out_rows]])
    keep = gap_hi > gap_lo
    zeros = np.stack(
        [np.full(int(keep.sum()), -1), gap_lo[keep], (gap_hi - gap_lo)[keep]], axis=1
    ).astype(np.int64)
    return np.concatenate([segs, zeros])


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _check_2d(what: str, *tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    for x in tensors:
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{what}: want CUDA tensors on one device, got {[str(t.device) for t in tensors]}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{what}: want contiguous 2-D (rows, C) tensors, got {tuple(x.shape)}")
        if x.dtype != tensors[0].dtype:
            raise ValueError(f"{what}: dtypes differ: {[t.dtype for t in tensors]}")
    return device


def _table(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int64 host table on the card, copied on the current stream (the
    pinned host buffer stays reserved until that copy has run)."""
    host = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).pin_memory()
    return host.to(device, non_blocking=True)


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, table: np.ndarray, n: int, rows: int, row_bytes: int) -> None:
    lib = _lib()
    device = a.device
    with torch.cuda.device(device):
        dev_table = _table(table, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, _ENTRY[name])(
            a.data_ptr(), b.data_ptr(), dev_table.data_ptr(), int(n), int(rows), int(row_bytes), stream
        )
    if err != 0:
        msg = lib.repro_rows_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
    launches[name] += 1


def pack_rows_cuda(src: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    device = _check_2d("pack_rows", src)
    st = row_starts(starts, block_rows, src.shape[0], "pack_rows")
    out = torch.empty((st.size * block_rows, src.shape[1]), dtype=src.dtype, device=device)
    if out.numel():
        _launch("pack_rows", out, src, st, st.size, block_rows, src.shape[1] * src.element_size())
    return out


def scatter_rows_cuda(dst: torch.Tensor, buf: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    _check_2d("scatter_rows", dst, buf)
    st = row_starts(starts, block_rows, dst.shape[0], "scatter_rows")
    if buf.shape != (st.size * block_rows, dst.shape[1]):
        raise ValueError(
            f"scatter_rows: buffer {tuple(buf.shape)} is not {st.size} blocks of {block_rows} rows of {dst.shape[1]}"
        )
    if buf.numel():
        segs = last_writer_segments(st, block_rows)
        _launch("scatter_rows", dst, buf, segs, len(segs), int(segs[:, 2].max()), dst.shape[1] * dst.element_size())
    return dst


def relayout_rows_cuda(dst: torch.Tensor, src: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    _check_2d("relayout_rows", dst, src)
    if src.shape != dst.shape:
        raise ValueError(f"relayout_rows: src {tuple(src.shape)} and dst {tuple(dst.shape)} differ")
    st = row_starts(starts, block_rows, dst.shape[0], "relayout_rows")
    if st.size and dst.shape[1]:
        segs = covered_segments(st, block_rows)
        _launch("relayout_rows", dst, src, segs, len(segs), int(segs[:, 2].max()), dst.shape[1] * dst.element_size())
    return dst


def unpack_rows_cuda(buf: torch.Tensor, starts, block_rows: int, out_rows: int) -> torch.Tensor:
    device = _check_2d("unpack_rows", buf)
    st = row_starts(starts, block_rows, out_rows, "unpack_rows")
    if buf.shape[0] != st.size * block_rows:
        raise ValueError(f"unpack_rows: buffer {tuple(buf.shape)} is not {st.size} blocks of {block_rows} rows")
    if st.size == 0:  # nothing to scatter: the zero output, no launch
        return torch.zeros((out_rows, buf.shape[1]), dtype=buf.dtype, device=device)
    out = torch.empty((out_rows, buf.shape[1]), dtype=buf.dtype, device=device)
    if out.numel():
        segs = unpack_segments(st, block_rows, out_rows)
        _launch("unpack_rows", out, buf, segs, len(segs), int(segs[:, 2].max()), buf.shape[1] * buf.element_size())
    return out
