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
CUDA grid does not. A pack writes each output row once whatever its starts.
The other wrappers resolve the last writer of every destination row on the
host (:func:`last_writer_segments`) wherever blocks may overlap, and launch
segments that write each row once, so repeated and overlapping starts give
the reference's sequential result. Starts that would leave the array raise
``ValueError`` (``ref.row_starts``), where the JAX reference clamps them.

Each wrapper launches on torch's current stream, does not synchronise,
raises if the launch fails, and adds one to its entry of :data:`launches`
where it launches; ``nb == 0`` launches nothing. The plain versions are
``repro_torch.kernels.ref.*_rows_ref``; ``ops`` picks between the two by the
tensors' device.

A moved row takes microseconds on the device, so the host work around a
launch decides what a call costs, and every table reaches its kernel by
value, in the kernel's parameters: no allocation, no copy to the card, no
event. :func:`pack_rows_cuda`, and :func:`unpack_rows_cuda` on disjoint
blocks, hand over their block starts as int32 (:func:`start_table`; form
"starts"), as the Pallas kernels take theirs as scalar prefetch; a list of
starts, the executor's form, :func:`pack_rows_cuda` hands to the library,
which reads it straight into the kernel's parameters.
:func:`scatter_rows_cuda` and :func:`relayout_rows_cuda` merge their
segments into one per contiguous run (:func:`coalesced_segments`) and hand
over int32 triples (:func:`row_table`; form "param"), as does
:func:`unpack_rows_cuda` on overlapping blocks. Past :data:`PARAM_STARTS`
starts or :data:`PARAM_SEGS` segments a table goes through a pinned host
ring into a device table kept per stream ("starts_device", "device"), still
in one launch. :data:`table_launches` counts the launches by form.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import disjoint_blocks, row_starts

# Kernel launches in this process, by kernel; each is bumped once per
# launch, nowhere else.
launches = {"pack_rows": 0, "unpack_rows": 0, "scatter_rows": 0, "relayout_rows": 0}
# The same launches by the form of their table: int32 block starts by value
# ("starts") or through the device table ("starts_device") for pack_rows
# and unpack_rows on disjoint blocks; int32 segment triples by value
# ("param") or through the device table ("device") for scatter_rows,
# relayout_rows and unpack_rows on overlapping blocks.
table_launches = {"starts": 0, "starts_device": 0, "param": 0, "device": 0}

# The most block starts and segments a by-value table holds: kParamStarts
# and kParamSegs in csrc/row_tables.cuh.
PARAM_STARTS = 8160
PARAM_SEGS = 2720
INT32_MAX = 2**31 - 1
# Pinned host slots that stage tables past the capacity for their copy.
_RING_SLOTS = 4


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernels' library, built and loaded at first use, its entries'
    argument types set once and its capacities checked."""
    global _LIB
    if _LIB is not None:
        return _LIB
    # PyDLL: a call keeps the GIL. An entry returns in microseconds, less
    # than releasing and taking back the GIL costs, and taking it back can
    # wait a switch interval while another thread runs.
    lib = ctypes.PyDLL(str(build.build_all(["reshard_pack"])["reshard_pack"]))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    argtypes = {
        "pack_rows": [p, p, p, i64, i64, i64, i64, p, p],
        "pack_rows_list": [p, p, ctypes.py_object, i64, i64, i64, i64, p, p],
        "unpack_rows": [p, p, p, i64, i64, i64, i64, p, p],
        "unpack_segments": [p, p, p, i64, i64, i64, p, p],
        "scatter_rows": [p, p, p, i64, i64, p, p],
        "relayout_rows": [p, p, p, i64, i64, p, p],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, f"repro_{name}")
        fn.argtypes = types
        fn.restype = ctypes.c_int
    lib.repro_rows_error_string.argtypes = [ctypes.c_int]
    lib.repro_rows_error_string.restype = ctypes.c_char_p
    for what, want in (("starts", PARAM_STARTS), ("segs", PARAM_SEGS)):
        fn = getattr(lib, f"repro_rows_param_{what}")
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(
                f"reshard_pack: the library holds {fn()} {what} by value, the wrapper expects {want}"
            )
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# Host-side tables: int32 block starts; (src_row, dst_row, rows) triples
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
    if disjoint_blocks(starts, block_rows):  # one segment each
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


def _int32_rows(rows: int) -> None:
    if rows > INT32_MAX:
        raise ValueError(f"row tables hold int32 rows: an array of {rows} rows has more than {INT32_MAX}")


def start_table(starts, block_rows: int, rows: int, what: str) -> np.ndarray:
    """``starts`` as the kernels' int32 block starts into an array of
    ``rows`` rows, range-checked by ``ref.row_starts``. Arrays of more rows
    than int32 holds are refused."""
    _int32_rows(rows)
    return row_starts(starts, block_rows, rows, what).astype(np.int32)


def row_table(segs: np.ndarray, rows: int) -> np.ndarray:
    """``segs`` as the kernels' int32 triples, for arrays of at most ``rows``
    rows (every row index and count in ``segs`` lies below it). Arrays of
    more rows than int32 holds are refused."""
    _int32_rows(rows)
    return np.ascontiguousarray(segs, dtype=np.int32)


def table_form(n: int, starts: bool = False) -> str:
    """How a table of ``n`` segments, or with ``starts`` of ``n`` block
    starts, reaches the kernel: by value, in its parameters, up to
    :data:`PARAM_SEGS` segments ("param") or :data:`PARAM_STARTS` starts
    ("starts"); through the stream's device table past it ("device",
    "starts_device")."""
    if starts:
        return "starts" if n <= PARAM_STARTS else "starts_device"
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


class _DeviceTables:
    """Where tables past the by-value capacity go: a ring of pinned host
    slots, each reused only after the event of its last copy has completed,
    and one int32 table on the card per stream, grown on demand. The entry
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

    def launch(self, call, table: np.ndarray, device: torch.device, stream: int) -> int:
        """Stage ``table`` and return ``call(host_ptr, device_ptr)``, the
        entry's error code."""
        with self._lock:
            slot, self._next = self._next, (self._next + 1) % _RING_SLOTS
            if self._copied[slot] is None:
                self._copied[slot] = torch.cuda.Event()
            self._copied[slot].synchronize()  # returns at once before its first record
            host = self._host[slot]
            if host is None or host.numel() < table.size:
                host = self._host[slot] = torch.empty(2 * table.size, dtype=torch.int32, pin_memory=True)
            host.numpy()[: table.size] = table.reshape(-1)
            key = (device.index, stream)
            dev = self._device.get(key)
            if dev is None or dev.numel() < table.size:
                dev = self._device[key] = torch.empty(2 * table.size, dtype=torch.int32, device=device)
            err = call(host.data_ptr(), dev.data_ptr())
            self._copied[slot].record(torch.cuda.current_stream(device))
        return err


_DEVICE_TABLES = _DeviceTables()


# What the list entries return for a block that leaves the array and for a
# start that is not an integer (kStartOutside, kNotInteger in
# csrc/row_tables.cuh); they launch nothing, and the wrapper raises the
# refusal through ref.row_starts, as the CPU path does.
_START_OUTSIDE = -1
_NOT_INTEGER = -2


def launch_entry(fn, tensors: tuple, table, form: str, *args) -> int:
    """One call of a library entry ``fn(*pointers, table, len(table), *args,
    device_table, stream)``, the pointers those of ``tensors``, on the
    current stream of the first tensor's device: the int32 array ``table``
    (or, for an entry that reads a list, a list) by value, or through the
    stream's device table for the forms past the capacity. Returns the
    entry's code."""
    index = tensors[0].get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch_entry(fn, tensors, table, form, *args)
    stream = torch._C._cuda_getCurrentRawStream(index)
    ptrs = [t.data_ptr() for t in tensors]
    n = len(table)
    if form in ("starts", "param"):
        return fn(*ptrs, table if type(table) is list else table.ctypes.data, n, *args, None, stream)
    return _DEVICE_TABLES.launch(lambda host, dev: fn(*ptrs, host, n, *args, dev, stream), table,
                                 tensors[0].device, stream)


def _launch_table(name: str, entry: str, a: torch.Tensor, b: torch.Tensor, table, form: str, *args) -> bool:
    """:func:`launch_entry` of ``repro_<entry>`` on ``(a, b)`` for the kernel
    ``name``, counted. False where the entry found a start outside the
    array or one that is not an integer, and launched nothing."""
    err = launch_entry(getattr(_lib(), f"repro_{entry}"), (a, b), table, form, *args)
    if err in (_START_OUTSIDE, _NOT_INTEGER):
        return False
    if err != 0:
        msg = _lib().repro_rows_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
    launches[name] += 1
    table_launches[form] += 1
    return True


def pack_rows_cuda(src: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    device = _check_2d("pack_rows", src)
    rows, row_bytes = src.shape[0], src.shape[1] * src.element_size()
    if type(starts) is list and 0 < len(starts) <= PARAM_STARTS and row_bytes and block_rows >= 1:
        # the executor's form: the library reads the list into the by-value
        # starts and checks each, so the host reads it once
        _int32_rows(rows)
        out = torch.empty((len(starts) * block_rows, src.shape[1]), dtype=src.dtype, device=device)
        if _launch_table("pack_rows", "pack_rows_list", out, src, starts, "starts", block_rows, row_bytes, rows):
            return out
        start_table(starts, block_rows, rows, "pack_rows")  # raises the refusal, naming the starts
        raise RuntimeError("pack_rows: the library refused starts that the wrapper accepts")
    table = start_table(starts, block_rows, rows, "pack_rows")
    out = torch.empty((table.size * block_rows, src.shape[1]), dtype=src.dtype, device=device)
    if out.numel():
        _launch_table("pack_rows", "pack_rows", out, src, table, table_form(table.size, starts=True),
                      block_rows, row_bytes, rows)
    return out


def scatter_rows_cuda(dst: torch.Tensor, buf: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    _check_2d("scatter_rows", dst, buf)
    st = row_starts(starts, block_rows, dst.shape[0], "scatter_rows")
    if buf.shape != (st.size * block_rows, dst.shape[1]):
        raise ValueError(
            f"scatter_rows: buffer {tuple(buf.shape)} is not {st.size} blocks of {block_rows} rows of {dst.shape[1]}"
        )
    if buf.numel():
        table = row_table(coalesced_segments(st, block_rows), max(dst.shape[0], buf.shape[0]))
        _launch_table("scatter_rows", "scatter_rows", dst, buf, table, table_form(len(table)),
                      dst.shape[1] * dst.element_size())
    return dst


def relayout_rows_cuda(dst: torch.Tensor, src: torch.Tensor, starts, block_rows: int) -> torch.Tensor:
    _check_2d("relayout_rows", dst, src)
    if src.shape != dst.shape:
        raise ValueError(f"relayout_rows: src {tuple(src.shape)} and dst {tuple(dst.shape)} differ")
    st = row_starts(starts, block_rows, dst.shape[0], "relayout_rows")
    if st.size and dst.shape[1]:
        table = row_table(coalesced_segments(st, block_rows, relayout=True), dst.shape[0])
        _launch_table("relayout_rows", "relayout_rows", dst, src, table, table_form(len(table)),
                      dst.shape[1] * dst.element_size())
    return dst


def unpack_tables(table: np.ndarray, block_rows: int, out_rows: int) -> tuple[str, np.ndarray]:
    """What :func:`unpack_rows_cuda` launches for the int32 block starts
    ``table``: ``("unpack_rows", table)`` where the blocks are disjoint (one
    sort tells), else ``("unpack_segments", int32 last-writer triples)``."""
    if disjoint_blocks(table, block_rows):
        return "unpack_rows", table
    segs = last_writer_segments(table.astype(np.int64), block_rows)
    return "unpack_segments", row_table(segs, max(out_rows, table.size * block_rows))


def unpack_rows_cuda(buf: torch.Tensor, starts, block_rows: int, out_rows: int) -> torch.Tensor:
    device = _check_2d("unpack_rows", buf)
    table = start_table(starts, block_rows, out_rows, "unpack_rows")
    if buf.shape[0] != table.size * block_rows:
        raise ValueError(f"unpack_rows: buffer {tuple(buf.shape)} is not {table.size} blocks of {block_rows} rows")
    if table.size == 0:  # nothing to scatter: the zero output, no launch
        return torch.zeros((out_rows, buf.shape[1]), dtype=buf.dtype, device=device)
    out = torch.empty((out_rows, buf.shape[1]), dtype=buf.dtype, device=device)
    if out.numel():
        row_bytes = buf.shape[1] * buf.element_size()
        entry, launched = unpack_tables(table, block_rows, out_rows)
        if entry == "unpack_rows":
            _launch_table("unpack_rows", entry, out, buf, launched, table_form(launched.size, starts=True),
                          block_rows, row_bytes, out_rows)
        else:
            _launch_table("unpack_rows", entry, out, buf, launched, table_form(len(launched)), row_bytes, out_rows)
    return out
