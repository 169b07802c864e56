"""The compressed wire of the reshard data plane on the GPU: the wrappers of
the two hand-written CUDA kernels in ``csrc/reshard_quant.cu``.

They replace the TPU kernels of ``repro/kernels/reshard_quant.py``
(``pack_quant_rows_pallas``, ``dequant_scatter_rows_pallas``) and compute
what the JAX references compute, bit for bit, on a row-major ``(rows, C)``
float32 or bfloat16 array, for any start:

- :func:`pack_quant_rows_cuda` gathers ``nb`` tiles of ``block_rows`` rows
  and quantizes each symmetrically, int8 or fp8-e4m3, with one float32
  scale per tile: ``((nb*block_rows, C) payload, (nb, 1) scales)``;
- :func:`dequant_scatter_rows_cuda` dequantizes each tile with its scale,
  casts to ``dst``'s dtype and overwrite-scatters it into ``dst`` **in
  place** (the torch counterpart of the JAX package's donation); rows no
  tile names keep their bytes.

Starts that would leave the array, or that are not integers, raise
``ValueError`` on every route and device. Each wrapper
launches on torch's current stream, does not synchronise, raises if the
launch fails, and adds one to its entry of :data:`launches` where it
launches; ``nb == 0`` launches nothing. The plain versions are
``repro_torch.kernels.ref.pack_quant_rows_ref`` and
``dequant_scatter_rows_ref``; ``ops`` picks between the two by the tensors'
device.

:func:`pack_quant_rows_cuda` costs about one launch on the host too: its
int32 tile starts go by value in the kernel's parameters (a list of starts,
the executor's form, the library reads and checks itself), and the kernel
reads each source byte once where the tile fits on chip, by one of three
routes that :func:`route` picks from the tile's size: a warp a tile in
registers (up to :data:`WARP_BYTES`), a block a tile in shared memory (up to
:data:`BLOCK_BYTES`), or, for larger tiles, one cooperative launch over the
card whose blocks keep their shares on chip across a grid-wide barrier
(:data:`route_launches` counts each).

:func:`dequant_scatter_rows_cuda` costs about one launch on the host, with
its table by value in the kernel's parameters (``csrc/row_tables.cuh``, as
the row kernels of ``reshard_pack``): disjoint tiles take their int32
starts (form "starts"; a list of starts, the executor's form, the library
reads and checks itself, and decides without a sort whether the tiles are
disjoint); repeated or overlapping tiles take the last writer of every
destination row (``reshard_pack.last_writer_segments``, form "param"), so
that they give the reference's sequential result. Past
``reshard_pack.PARAM_STARTS`` starts or ``PARAM_SEGS`` segments a table goes
through ``reshard_pack``'s pinned ring into the stream's device table
("starts_device", "device"), still in one launch. :data:`table_launches`
counts its launches by form.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import WIRE_QDTYPE, disjoint_blocks, row_starts
from repro_torch.kernels.reshard_pack import (
    INT32_MAX, PARAM_SEGS, PARAM_STARTS, last_writer_segments, launch_entry, row_table, start_table, table_form,
)

# Kernel launches in this process, by kernel; each is bumped once per
# launch, nowhere else.
launches = {"pack_quant_rows": 0, "dequant_scatter_rows": 0}
# pack_quant_rows' launches by route.
route_launches = {"warp": 0, "block": 0, "grid": 0}
# dequant_scatter_rows' launches by the form of its table: int32 tile
# starts by value ("starts") or through the device table ("starts_device");
# int32 last-writer segments by value ("param") or through the device table
# ("device").
table_launches = {"starts": 0, "starts_device": 0, "param": 0, "device": 0}

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FORMAT_CODES = {"int8": 0, "fp8_e4m3": 1}
_FORMAT_OF = {WIRE_QDTYPE[f]: f for f in _FORMAT_CODES}
_ROUTE_CODES = {"warp": 0, "block": 1, "grid": 2}

# pack_quant_rows' routes: the largest tile, in bytes, that a warp holds in
# registers and that a block stages in shared memory (kWarpBytes and
# kBlockBytes in csrc/reshard_quant.cu; the library's are checked at load);
# the most SMs whose grid-route blocks the scratch covers.
WARP_BYTES = 8192
BLOCK_BYTES = 192 * 1024
_MAX_SMS = 1024


def route(tile_elems: int, itemsize: int) -> str:
    """The route of :func:`pack_quant_rows_cuda` for tiles of ``tile_elems``
    elements of ``itemsize`` bytes: "warp" up to :data:`WARP_BYTES`, "block"
    up to :data:`BLOCK_BYTES`, else "grid"."""
    nbytes = tile_elems * itemsize
    return "warp" if nbytes <= WARP_BYTES else "block" if nbytes <= BLOCK_BYTES else "grid"


def scratch_floats(name: str) -> int:
    """The float32 scratch a launch of route ``name`` needs (the library
    checks it): the grid route's two slots of one maximum a block, for up to
    :data:`_MAX_SMS` blocks; none for the others."""
    return 2 * _MAX_SMS if name == "grid" else 0


# What the list entries return for a tile that leaves the array, a start
# that is not an integer (both: the wrapper raises the refusal through
# ref.row_starts), and for tiles repro_dequant_scatter_rows_list did not find
# disjoint; none of these launched.
_START_OUTSIDE = -1
_NOT_INTEGER = -2
_NOT_DISJOINT = -3

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernels' library, built and loaded at first use, its entries'
    argument types set once and its capacities checked."""
    global _LIB
    if _LIB is not None:
        return _LIB
    # PyDLL: a call keeps the GIL (the list entry reads a Python list), and
    # an entry returns in microseconds.
    lib = ctypes.PyDLL(str(build.build_all(["reshard_quant"])["reshard_quant"]))
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    argtypes = {
        "pack_quant_rows": [p, p, p, p, i64, i64, i64, i64, i, i, i, p, i64, p, p],
        "pack_quant_rows_list": [p, p, p, ctypes.py_object, i64, i64, i64, i64, i, i, i, p, i64, p, p],
        "dequant_scatter_rows": [p, p, p, p, i64, i64, i64, i64, i, i, p, p],
        "dequant_scatter_rows_list": [p, p, p, ctypes.py_object, i64, i64, i64, i64, i, i, p, p],
        "dequant_scatter_segments": [p, p, p, p, i64, i64, i64, i64, i64, i, i, p, p],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, f"repro_{name}")
        fn.argtypes = types
        fn.restype = ctypes.c_int
    lib.repro_quant_error_string.argtypes = [ctypes.c_int]
    lib.repro_quant_error_string.restype = ctypes.c_char_p
    for what, want in (("param_starts", PARAM_STARTS), ("param_segs", PARAM_SEGS), ("warp_bytes", WARP_BYTES),
                       ("block_bytes", BLOCK_BYTES)):
        fn = getattr(lib, f"repro_quant_{what}")
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(
                f"reshard_quant: the library holds {fn()} {what} by value, the wrapper expects {want}"
            )
    _LIB = lib
    return lib


def _check(what: str, x: torch.Tensor, dtypes) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: want a CUDA tensor, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous() or x.shape[1] == 0:
        raise ValueError(f"{what}: want a contiguous 2-D (rows, C>0) tensor, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {x.dtype} not in {sorted(map(str, dtypes))}")


def _raise_if(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.repro_quant_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def pack_quant_rows_cuda(src: torch.Tensor, starts, block_rows: int, fmt: str):
    _check("pack_quant_rows", src, _VALUE_CODES)
    if fmt not in _FORMAT_CODES:
        raise ValueError(f"pack_quant_rows: wire format {fmt!r} not in {sorted(_FORMAT_CODES)}")
    rows, C = src.shape
    if type(starts) is list and 0 < len(starts) <= PARAM_STARTS and block_rows >= 1 and rows <= INT32_MAX:
        # the executor's form: the library reads the list into the by-value
        # starts and checks each, so the host reads it once
        table, nb, entry, form = starts, len(starts), "pack_quant_rows_list", "starts"
    else:
        table = start_table(starts, block_rows, rows, "pack_quant_rows")
        nb, entry, form = table.size, "pack_quant_rows", table_form(table.size, starts=True)
    tile = block_rows * C
    name = route(tile, src.element_size())
    n_scratch = scratch_floats(name) if nb else 0
    q = torch.empty((nb * block_rows, C), dtype=WIRE_QDTYPE[fmt], device=src.device)
    floats = torch.empty((nb + n_scratch,), dtype=torch.float32, device=src.device)  # the scales, then the scratch
    scales = floats[:nb].view(nb, 1)
    if nb == 0:
        return q, scales
    lib = _LIB or _lib()
    err = launch_entry(getattr(lib, f"repro_{entry}"), (q, scales, src), table, form, block_rows, C, rows,
                       _VALUE_CODES[src.dtype], _FORMAT_CODES[fmt], _ROUTE_CODES[name],
                       floats.data_ptr() + 4 * nb if n_scratch else None, n_scratch)
    if err in (_START_OUTSIDE, _NOT_INTEGER):
        row_starts(starts, block_rows, rows, "pack_quant_rows")  # raises the refusal, naming the start
        raise RuntimeError("pack_quant_rows: the library refused starts that the wrapper accepts")
    _raise_if(lib, err, "pack_quant_rows")
    launches["pack_quant_rows"] += 1
    route_launches[name] += 1
    return q, scales


def dequant_tables(table: np.ndarray, block_rows: int, rows: int) -> tuple[str, np.ndarray]:
    """What :func:`dequant_scatter_rows_cuda` launches, off the list route,
    for the int32 tile starts ``table`` into an array of ``rows`` rows:
    ``("dequant_scatter_rows", table)`` where the tiles are disjoint (one
    sort tells), else ``("dequant_scatter_segments", int32 last-writer
    triples)``."""
    if disjoint_blocks(table, block_rows):
        return "dequant_scatter_rows", table
    segs = last_writer_segments(table.astype(np.int64), block_rows)
    return "dequant_scatter_segments", row_table(segs, max(rows, table.size * block_rows))


def _launch_dequant(entry: str, dst, buf, scales, table, form: str, *args) -> int:
    """``reshard_pack.launch_entry`` of ``repro_<entry>`` on ``(dst, buf,
    scales)``, counted. Returns 0, or the list entry's :data:`_START_OUTSIDE`,
    :data:`_NOT_INTEGER` or :data:`_NOT_DISJOINT` (nothing launched)."""
    lib = _LIB or _lib()
    err = launch_entry(getattr(lib, f"repro_{entry}"), (dst, buf, scales), table, form, *args)
    if err in (_START_OUTSIDE, _NOT_INTEGER, _NOT_DISJOINT):
        return err
    _raise_if(lib, err, "dequant_scatter_rows")
    launches["dequant_scatter_rows"] += 1
    table_launches[form] += 1
    return 0


def dequant_scatter_rows_cuda(dst: torch.Tensor, buf: torch.Tensor, scales: torch.Tensor, starts, block_rows: int):
    _check("dequant_scatter_rows", dst, _VALUE_CODES)
    _check("dequant_scatter_rows", buf, _FORMAT_OF)
    if not (scales.is_contiguous() and scales.dtype == torch.float32):
        raise ValueError("dequant_scatter_rows: scales must be contiguous float32")
    if not (buf.get_device() == dst.get_device() == scales.get_device()):
        raise ValueError(f"dequant_scatter_rows: tensors on {dst.device}, {buf.device}, {scales.device}")
    rows, C = dst.shape
    codes = (_VALUE_CODES[dst.dtype], _FORMAT_CODES[_FORMAT_OF[buf.dtype]])
    if type(starts) is list and 0 < len(starts) <= PARAM_STARTS and block_rows >= 1 and rows <= INT32_MAX:
        # the executor's form: the library reads the list into the by-value
        # starts, checks each and tells whether the tiles are disjoint
        _check_tiles(buf, scales, len(starts), block_rows, C)
        err = _launch_dequant("dequant_scatter_rows_list", dst, buf, scales, starts, "starts", block_rows, C, rows,
                              *codes)
        if err == 0:
            return dst
        if err in (_START_OUTSIDE, _NOT_INTEGER):
            row_starts(starts, block_rows, rows, "dequant_scatter_rows")  # raises the refusal, naming the start
            raise RuntimeError("dequant_scatter_rows: the library refused starts that the wrapper accepts")
    table = start_table(starts, block_rows, rows, "dequant_scatter_rows")
    nb = table.size
    _check_tiles(buf, scales, nb, block_rows, C)
    if nb == 0:
        return dst
    entry, launched = dequant_tables(table, block_rows, rows)
    if entry == "dequant_scatter_rows":
        _launch_dequant(entry, dst, buf, scales, launched, table_form(nb, starts=True), block_rows, C, rows, *codes)
    else:
        _launch_dequant(entry, dst, buf, scales, launched, table_form(len(launched)), block_rows, C, rows,
                        nb * block_rows, *codes)
    return dst


def _check_tiles(buf: torch.Tensor, scales: torch.Tensor, nb: int, block_rows: int, C: int) -> None:
    if tuple(buf.shape) != (nb * block_rows, C) or tuple(scales.shape) != (nb, 1):
        raise ValueError(
            f"dequant_scatter_rows: buffer {tuple(buf.shape)} / scales {tuple(scales.shape)} are not "
            f"{nb} tiles of {block_rows} rows of {C}"
        )
