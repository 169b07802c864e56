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

As for ``scatter_rows``, the dequantizing scatter resolves the last writer
of every destination row on the host (``reshard_pack.last_writer_segments``)
so that repeated and overlapping starts give the reference's sequential
result. Starts that would leave the array raise ``ValueError``.

Each wrapper launches on torch's current stream, does not synchronise,
raises if the launch fails, and adds one to its entry of :data:`launches`
where it launches; ``nb == 0`` launches nothing. The plain versions are
``repro_torch.kernels.ref.pack_quant_rows_ref`` and
``dequant_scatter_rows_ref``; ``ops`` picks between the two by the tensors'
device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import WIRE_QDTYPE, row_starts
from repro_torch.kernels.reshard_pack import last_writer_segments

# Kernel launches in this process, by kernel; each is bumped once per
# launch, nowhere else.
launches = {"pack_quant_rows": 0, "dequant_scatter_rows": 0}

_VALUE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FORMAT_CODES = {"int8": 0, "fp8_e4m3": 1}
_FORMAT_OF = {WIRE_QDTYPE[f]: f for f in _FORMAT_CODES}
# elements of a tile that one block of the absmax pass reduces
_SHARE = 4096


def _lib() -> ctypes.CDLL:
    lib = build.load("reshard_quant")
    if lib.repro_pack_quant_rows.argtypes is None:
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.repro_pack_quant_rows.argtypes = [p, p, p, p, p, i64, i64, i64, i, i, i, p]
        lib.repro_pack_quant_rows.restype = ctypes.c_int
        lib.repro_dequant_scatter_rows.argtypes = [p, p, p, p, i64, i64, i64, i64, i, i, p]
        lib.repro_dequant_scatter_rows.restype = ctypes.c_int
        lib.repro_quant_error_string.argtypes = [ctypes.c_int]
        lib.repro_quant_error_string.restype = ctypes.c_char_p
    return lib


def _table(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int64 host table on the card, copied on the current stream (the
    pinned host buffer stays reserved until that copy has run)."""
    host = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).pin_memory()
    return host.to(device, non_blocking=True)


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
    st = row_starts(starts, block_rows, src.shape[0], "pack_quant_rows")
    nb, C = st.size, src.shape[1]
    q = torch.empty((nb * block_rows, C), dtype=WIRE_QDTYPE[fmt], device=src.device)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=src.device)
    if nb == 0:
        return q, scales
    chunks = -(-block_rows * C // _SHARE)
    partial = torch.empty((nb * chunks,), dtype=torch.float32, device=src.device)
    lib = _lib()
    with torch.cuda.device(src.device):
        table = _table(st, src.device)
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.repro_pack_quant_rows(
            src.data_ptr(), q.data_ptr(), scales.data_ptr(), partial.data_ptr(), table.data_ptr(),
            nb, block_rows, C, chunks, _VALUE_CODES[src.dtype], _FORMAT_CODES[fmt], stream,
        )
    _raise_if(lib, err, "pack_quant_rows")
    launches["pack_quant_rows"] += 1
    return q, scales


def dequant_scatter_rows_cuda(dst: torch.Tensor, buf: torch.Tensor, scales: torch.Tensor, starts, block_rows: int):
    _check("dequant_scatter_rows", dst, _VALUE_CODES)
    _check("dequant_scatter_rows", buf, _FORMAT_OF)
    st = row_starts(starts, block_rows, dst.shape[0], "dequant_scatter_rows")
    nb, C = st.size, dst.shape[1]
    if tuple(buf.shape) != (nb * block_rows, C) or tuple(scales.shape) != (nb, 1):
        raise ValueError(
            f"dequant_scatter_rows: buffer {tuple(buf.shape)} / scales {tuple(scales.shape)} are not "
            f"{nb} tiles of {block_rows} rows of {C}"
        )
    if not (scales.is_contiguous() and scales.dtype == torch.float32):
        raise ValueError("dequant_scatter_rows: scales must be contiguous float32")
    if not (buf.device == dst.device == scales.device):
        raise ValueError(f"dequant_scatter_rows: tensors on {dst.device}, {buf.device}, {scales.device}")
    if nb == 0:
        return dst
    segs = last_writer_segments(st, block_rows)
    lib = _lib()
    with torch.cuda.device(dst.device):
        table = _table(segs, dst.device)
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        err = lib.repro_dequant_scatter_rows(
            dst.data_ptr(), buf.data_ptr(), scales.data_ptr(), table.data_ptr(), len(segs),
            int(segs[:, 2].max()), block_rows, C, _VALUE_CODES[dst.dtype],
            _FORMAT_CODES[_FORMAT_OF[buf.dtype]], stream,
        )
    _raise_if(lib, err, "dequant_scatter_rows")
    launches["dequant_scatter_rows"] += 1
    return dst
