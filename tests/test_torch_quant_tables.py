"""The tables that the port's dequant_scatter_rows CUDA wrapper launches
(``repro_torch/kernels/reshard_quant.py``), on the CPU: the int32 tile
starts (disjoint tiles) or last-writer segments (repeated or overlapping
tiles) that :func:`dequant_tables` picks, replayed on the host as the kernel
applies them (each destination row written once, each tile piece with its
own tile's scale), held byte for byte against the port's plain version, the
JAX package's reference and, where the starts are block-aligned, its Pallas
kernel in interpret mode; int8 and fp8 payloads, float32 and bfloat16
destinations. The table's form at the capacities' edges, the capacities of
the shared CUDA header against the wrappers', and the int32 refusal."""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.reshard_quant import dequant_scatter_rows_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import reshard_pack as rp
from repro_torch.kernels import reshard_quant as rq

torch.set_num_threads(2)

CSRC = Path(rq.__file__).resolve().parent / "csrc"
FORMATS = ["int8", "fp8_e4m3"]
DTYPES = ["float32", "bfloat16"]
KINDS = ["repeated", "overlapping", "unsorted_disjoint", "sorted_disjoint"]


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _replay(dst: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, starts, block: int):
    """dequant_scatter_rows_cuda's launch replayed: the entry
    :func:`rq.dequant_tables` picks, applied as ``dequant_entries`` in
    ``csrc/reshard_quant.cu`` does (starts: tile i to its start with
    scales[i]; segments: piece by piece within one tile, with that tile's
    scale), no destination row written twice."""
    rows = dst.shape[0]
    table = rp.start_table(starts, block, rows, "dequant_scatter_rows")
    entry, launched = rq.dequant_tables(table, block, rows)
    assert launched.dtype == np.int32 and launched.flags["C_CONTIGUOUS"]
    out = dst.clone()
    written = np.zeros(rows, bool)

    def span(b, d, n, tile):
        assert n > 0 and b // block == tile and (b + n - 1) // block == tile, (b, n, tile)  # one tile
        assert not written[d : d + n].any(), (entry, d, n)
        written[d : d + n] = True
        out[d : d + n] = (q[b : b + n].float() * scales[tile, 0]).to(dst.dtype)

    if entry == "dequant_scatter_rows":
        for i, s in enumerate(launched.tolist()):
            span(i * block, s, block, i)
    else:
        for b, d, left in launched.tolist():
            tile, n = b // block, (b // block + 1) * block - b
            while left > 0:
                n = min(n, left)
                span(b, d, n, tile)
                b, d, left, tile, n = b + n, d + n, left - n, tile + 1, block
    return out, entry, launched


def _draw_starts(rng, kind: str, R: int, block: int) -> np.ndarray:
    """Repeated starts are block-aligned (the Pallas kernel takes them),
    overlapping ones are not; the disjoint kinds are aligned."""
    slots = np.arange(0, R - block + 1, block)
    nb = int(rng.integers(1, 10))
    if kind == "repeated":
        base = rng.choice(slots, max(1, nb // 2))
        return np.concatenate([base, rng.choice(base, nb - base.size + 1)])
    if kind == "overlapping":
        return rng.integers(0, R - block + 1, nb)
    picked = rng.choice(slots, size=min(nb, slots.size), replace=False)
    return np.sort(picked) if kind == "sorted_disjoint" else picked


def _jax_payload(q: torch.Tensor) -> jnp.ndarray:
    raw = q.contiguous().view(torch.uint8).numpy()
    return jnp.asarray(raw.view(np.int8 if q.dtype == torch.int8 else ml_dtypes.float8_e4m3fn))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.asarray(j, np.float32).copy()).to(getattr(torch, dtype))


@pytest.mark.parametrize("block", [1, 2, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", KINDS)
def test_tables_replay_the_references(kind, fmt, dtype, block):
    """Many draws against the port's plain version; the first against the
    JAX reference and, on aligned starts, the Pallas kernel. Rows no tile
    names keep their bytes."""
    rng = np.random.default_rng(len(kind) * 100 + block * 10 + len(fmt) + len(dtype))
    entries = set()
    for draw in range(12):
        R, C = int(block * rng.integers(2, 9)), int(rng.choice([1, 16, 48]))
        starts = _draw_starts(rng, kind, R, block)
        src = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32) * 10.0 ** rng.integers(-8, 8))
        jd, td = _pair(rng.normal(size=(R, C)), dtype)
        q, s = ref.pack_quant_rows_ref(src.to(td.dtype), starts, block, fmt)
        got, entry, _ = _replay(td, q, s, starts, block)
        entries.add(entry)
        want = ref.dequant_scatter_rows_ref(td.clone(), q, s, starts, block)
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
        named = np.zeros(R, bool)
        for st in starts.tolist():
            named[st : st + block] = True
        np.testing.assert_array_equal(_bytes(got[~named]), _bytes(td[~named]))
        if draw == 0:
            jq = _jax_payload(q)
            js, jst = jnp.asarray(s.numpy()), jnp.asarray(starts, jnp.int32)
            np.testing.assert_array_equal(_bytes(got), _bytes(jref.dequant_scatter_rows_ref(jd, jq, js, jst, block)))
            if kind != "overlapping":
                pallas = dequant_scatter_rows_pallas(jd, jq, js, jst, block, interpret=True)
                np.testing.assert_array_equal(_bytes(got), _bytes(pallas))
    disjoint = kind.endswith("disjoint")
    if kind != "overlapping":  # random overlapping starts may by chance be disjoint
        assert entries == {"dequant_scatter_rows" if disjoint else "dequant_scatter_segments"}, entries


def test_segments_span_tiles_and_take_each_tiles_scale():
    """Where tiles repeat, the last writers of rows that follow on in both
    arrays merge into segments that span tiles (tiles 0 and 1 here); the
    replay's pieces keep each row's scale from its own tile."""
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.normal(size=(48, 16)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(48, 16)).astype(np.float32))
    starts, block = [0, 8, 20, 20], 8
    q, s = ref.pack_quant_rows_ref(src, starts, block, "int8")
    got, entry, segs = _replay(dst, q, s, starts, block)
    assert entry == "dequant_scatter_segments" and (segs[:, 2] > block).any()  # a segment spans tiles
    np.testing.assert_array_equal(_bytes(got), _bytes(ref.dequant_scatter_rows_ref(dst.clone(), q, s, starts, block)))


def test_the_executors_rows_take_the_starts():
    """The executor's call: distinct rows of a moment, one tile a row, sorted
    or not: one start each, as given."""
    rng = np.random.default_rng(4)
    for rows in ([3, 17, 27], [int(x) for x in rng.permutation(151)[:40]]):
        table = rp.start_table(rows, 1, 151, "dequant_scatter_rows")
        entry, launched = rq.dequant_tables(table, 1, 151)
        assert entry == "dequant_scatter_rows" and launched.tolist() == rows


@pytest.mark.parametrize("n", [rp.PARAM_STARTS, rp.PARAM_STARTS + 1])
def test_start_forms_at_the_capacity(n):
    """n disjoint one-row tiles, unsorted: by value up to the capacity,
    through the device table past it; the replay equals the plain version
    and the JAX reference."""
    rng = np.random.default_rng(n)
    R, C = n + 3, 4
    starts = rng.permutation(R)[:n]
    src = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32))
    q, s = ref.pack_quant_rows_ref(src, starts, 1, "int8")
    got, entry, table = _replay(dst, q, s, starts, 1)
    assert entry == "dequant_scatter_rows" and table.size == n
    assert rp.table_form(n, starts=True) == ("starts" if n <= rp.PARAM_STARTS else "starts_device")
    np.testing.assert_array_equal(_bytes(got), _bytes(ref.dequant_scatter_rows_ref(dst.clone(), q, s, starts, 1)))
    want = jref.dequant_scatter_rows_ref(jnp.asarray(dst.numpy()), _jax_payload(q), jnp.asarray(s.numpy()),
                                         jnp.asarray(starts, jnp.int32), 1)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("n", [rp.PARAM_SEGS, rp.PARAM_SEGS + 1])
def test_segment_forms_at_the_capacity(n):
    """Each of n rows, two apart, named twice: n last-writer segments (the
    second tile of each), by value up to the capacity, through the device
    table past it."""
    rng = np.random.default_rng(n)
    R, C = 2 * n + 1, 4
    starts = np.repeat(np.arange(n) * 2, 2)
    src = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32))
    q, s = ref.pack_quant_rows_ref(src, starts, 1, "fp8_e4m3")
    got, entry, segs = _replay(dst, q, s, starts, 1)
    assert entry == "dequant_scatter_segments" and len(segs) == n and (segs[:, 0] % 2 == 1).all()
    assert rp.table_form(len(segs)) == ("param" if n <= rp.PARAM_SEGS else "device")
    np.testing.assert_array_equal(_bytes(got), _bytes(ref.dequant_scatter_rows_ref(dst.clone(), q, s, starts, 1)))


def test_the_capacities_match_the_shared_header():
    """Both reshard sources take their tables from csrc/row_tables.cuh, whose
    capacities (the last size class of each) equal the wrappers'; the
    dequant kernel's parameters (three pointers, C, block_rows and the
    table) fit the 32,764 bytes."""
    text = (CSRC / "row_tables.cuh").read_text()
    for name, cap in (("kStartClasses", rp.PARAM_STARTS), ("kParamClasses", rp.PARAM_SEGS)):
        classes = re.search(rf"constexpr int {name}\[\] = \{{([\d,\s]+)\}};", text)
        assert classes, name
        sizes = [int(x) for x in classes.group(1).split(",")]
        assert sizes == sorted(sizes) and sizes[-1] == cap and len(sizes) == 3
    for source in ("reshard_pack.cu", "reshard_quant.cu"):
        body = (CSRC / source).read_text()
        assert '#include "row_tables.cuh"' in body and "struct RowStarts" not in body, source
    quant = (CSRC / "reshard_quant.cu").read_text()
    assert "repro_quant_param_starts() { return kParamStarts; }" in quant
    assert "repro_quant_param_segs() { return kParamSegs; }" in quant
    assert rq.PARAM_STARTS == rp.PARAM_STARTS and rq.PARAM_SEGS == rp.PARAM_SEGS
    assert 3 * 8 + 2 * 8 + 4 + 4 * rp.PARAM_STARTS <= 32764 and 3 * 8 + 2 * 8 + 4 + 12 * rp.PARAM_SEGS <= 32764


def test_tables_refuse_arrays_past_int32_rows():
    with pytest.raises(ValueError, match="int32"):
        rp.start_table([0], 1, 2**31, "dequant_scatter_rows")
    with pytest.raises(ValueError, match="int32"):
        rq.dequant_tables(np.array([0, 0], np.int32), 1, 2**31)  # segments: their rows as int32
    entry, table = rq.dequant_tables(np.array([0, 0], np.int32), 1, 2**31 - 1)
    assert entry == "dequant_scatter_segments" and table.tolist() == [[1, 0, 1]]


def test_the_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(8, 4)
    q, s = torch.zeros(1, 4, dtype=torch.int8), torch.ones(1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        rq.dequant_scatter_rows_cuda(x, q, s, [0], 1)
    with pytest.raises(ValueError, match="CUDA"):
        rq.dequant_scatter_rows_cuda(x, q.to(torch.float32), s, [0], 1)
