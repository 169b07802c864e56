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

A moved row takes microseconds on the device, so the host work around a
launch decides what a call costs. :func:`scatter_rows_cuda` and
:func:`relayout_rows_cuda` therefore merge their segments into one per
contiguous run (:func:`coalesced_segments`) and hand the kernel the table
by value, as int32 triples in its parameters: no allocation, no copy to the
card, no event (:func:`table_form` "param"). A table of more than
:data:`PARAM_SEGS` segments goes through a pinned host ring into a device
table kept per stream ("device"), still in one launch. :data:`table_launches`
counts the launches of the two kernels by form. pack_rows and unpack_rows
copy an int64 table to the card per call (:func:`_table`).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import row_starts

# Kernel launches in this process, by kernel; each is bumped once per
# launch, nowhere else.
launches = {"pack_rows": 0, "unpack_rows": 0, "scatter_rows": 0, "relayout_rows": 0}
# scatter_rows and relayout_rows launches by the form of their segment table
table_launches = {"param": 0, "device": 0}

# The most segments a by-value table holds: kParamSegs in csrc/reshard_pack.cu.
PARAM_SEGS = 2720
INT32_MAX = 2**31 - 1
# Pinned host slots that stage tables past PARAM_SEGS for their copy.
_RING_SLOTS = 4

_ENTRY = {name: f"repro_{name}" for name in launches}


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernels' library, built and loaded at first use, its entries'
    argument types set once."""
    global _LIB
    if _LIB is not None:
        return _LIB
    # PyDLL: a call keeps the GIL. An entry returns in microseconds, less
    # than releasing and taking back the GIL costs, and taking it back can
    # wait a switch interval while another thread runs.
    lib = ctypes.PyDLL(str(build.build_all(["reshard_pack"])["reshard_pack"]))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in ("pack_rows", "unpack_rows"):
        fn = getattr(lib, _ENTRY[name])
        fn.argtypes = [p, p, p, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    for name in ("scatter_rows", "relayout_rows"):
        fn = getattr(lib, _ENTRY[name])
        fn.argtypes = [p, p, p, i64, i64, p, p]
        fn.restype = ctypes.c_int
    lib.repro_rows_error_string.argtypes = [ctypes.c_int]
    lib.repro_rows_error_string.restype = ctypes.c_char_p
    lib.repro_rows_param_segs.restype = ctypes.c_int
    if lib.repro_rows_param_segs() != PARAM_SEGS:
        raise RuntimeError(
            f"reshard_pack: the library holds {lib.repro_rows_param_segs()} segments by value, "
            f"the wrapper expects PARAM_SEGS = {PARAM_SEGS}"
        )
    _LIB = lib
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


def coalesced_segments(starts: np.ndarray, block_rows: int, relayout: bool = False) -> np.ndarray:
    """The segments that :func:`scatter_rows_cuda` (source rows are buffer
    rows) or, with ``relayout``, :func:`relayout_rows_cuda` (source row ==
    destination row) launch, each destination row written once, by its last
    writer. Disjoint blocks, in the order given, merge where the next
    block's rows follow on in both arrays (a scatter's buffer rows always
    do), so sorted blocks give one segment per contiguous run; repeated or
    overlapping blocks take :func:`last_writer_segments` or
    :func:`covered_segments`, which merge their runs. One start, and sorted
    disjoint starts, need no sort."""
    nb = starts.size
    if nb == 0:
        return np.zeros((0, 3), np.int64)
    if nb == 1:
        s = int(starts[0])
        return np.array([[s if relayout else 0, s, block_rows]], np.int64)
    gaps = np.diff(starts)
    if gaps.min() < block_rows and np.diff(np.sort(starts)).min() < block_rows:
        return covered_segments(starts, block_rows) if relayout else last_writer_segments(starts, block_rows)
    breaks = gaps != block_rows
    if breaks.all():  # no block follows on from the one before: a segment each
        out = np.empty((nb, 3), np.int64)
        out[:, 1] = starts
        out[:, 0] = starts if relayout else np.arange(0, nb * block_rows, block_rows)
        out[:, 2] = block_rows
        return out
    first = np.concatenate([[0], np.flatnonzero(breaks) + 1])
    out = np.empty((first.size, 3), np.int64)
    out[:, 1] = starts[first]
    out[:, 0] = out[:, 1] if relayout else first * block_rows
    out[:, 2] = np.diff(np.append(first, nb)) * block_rows
    return out


def row_table(segs: np.ndarray, rows: int) -> np.ndarray:
    """``segs`` as the kernels' int32 triples, for arrays of at most ``rows``
    rows (every row index and count in ``segs`` lies below it). Arrays of
    more rows than int32 holds are refused."""
    if rows > INT32_MAX:
        raise ValueError(f"row tables hold int32 rows: an array of {rows} rows has more than {INT32_MAX}")
    return np.ascontiguousarray(segs, dtype=np.int32)


def table_form(n: int) -> str:
    """How a table of ``n`` segments reaches the kernel: "param" (by value,
    in its parameters) up to :data:`PARAM_SEGS`, "device" past it."""
    return "param" if n <= PARAM_SEGS else "device"


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


class _DeviceTables:
    """Where tables past :data:`PARAM_SEGS` go: a ring of pinned host slots,
    each reused only after the event of its last copy has completed, and
    one int32 table on the card per stream, grown on demand. The entry
    copies a slot into the stream's table and launches on that stream, so
    the next copy into the table waits for the kernel that reads it; the
    lock keeps two threads from sharing a slot or interleaving their copy
    and launch on one stream."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._host: list[torch.Tensor | None] = [None] * _RING_SLOTS
        self._copied: list[torch.cuda.Event | None] = [None] * _RING_SLOTS
        self._next = 0
        self._device: dict[tuple[int, int], torch.Tensor] = {}

    def launch(self, entry, a: torch.Tensor, b: torch.Tensor, table: np.ndarray, row_bytes: int, stream: int) -> int:
        """Stage ``table`` and call ``entry`` on it; its error code."""
        with self._lock:
            slot, self._next = self._next, (self._next + 1) % _RING_SLOTS
            if self._copied[slot] is None:
                self._copied[slot] = torch.cuda.Event()
            self._copied[slot].synchronize()  # returns at once before its first record
            host = self._host[slot]
            if host is None or host.numel() < table.size:
                host = self._host[slot] = torch.empty(2 * table.size, dtype=torch.int32, pin_memory=True)
            host.numpy()[: table.size] = table.reshape(-1)
            key = (a.get_device(), stream)
            dev = self._device.get(key)
            if dev is None or dev.numel() < table.size:
                dev = self._device[key] = torch.empty(2 * table.size, dtype=torch.int32, device=a.device)
            err = entry(a.data_ptr(), b.data_ptr(), host.data_ptr(), len(table), row_bytes, dev.data_ptr(), stream)
            self._copied[slot].record(torch.cuda.current_stream(a.device))
        return err


_DEVICE_TABLES = _DeviceTables()


def _launch_segments(name: str, a: torch.Tensor, b: torch.Tensor, segs: np.ndarray, rows: int) -> None:
    """One launch of scatter_rows or relayout_rows on the segments ``segs``
    over arrays of ``rows`` rows: by value up to :data:`PARAM_SEGS`
    segments, else through the stream's device table."""
    index = a.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch_segments(name, a, b, segs, rows)
    table = row_table(segs, rows)
    entry = getattr(_lib(), _ENTRY[name])
    stream = torch._C._cuda_getCurrentRawStream(index)
    row_bytes = a.shape[1] * a.element_size()
    form = table_form(len(table))
    if form == "param":
        err = entry(a.data_ptr(), b.data_ptr(), table.ctypes.data, len(table), row_bytes, None, stream)
    else:
        err = _DEVICE_TABLES.launch(entry, a, b, table, row_bytes, stream)
    if err != 0:
        msg = _lib().repro_rows_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
    launches[name] += 1
    table_launches[form] += 1


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
        _launch_segments("scatter_rows", dst, buf, coalesced_segments(st, block_rows), max(dst.shape[0], buf.shape[0]))
    return dst


def relayout_rows_cuda(dst: torch.Tensor, src: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    _check_2d("relayout_rows", dst, src)
    if src.shape != dst.shape:
        raise ValueError(f"relayout_rows: src {tuple(src.shape)} and dst {tuple(dst.shape)} differ")
    st = row_starts(starts, block_rows, dst.shape[0], "relayout_rows")
    if st.size and dst.shape[1]:
        _launch_segments("relayout_rows", dst, src, coalesced_segments(st, block_rows, relayout=True), dst.shape[0])
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
