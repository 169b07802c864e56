"""The block-start tables that the port's pack_rows and unpack_rows CUDA
wrappers launch (``repro_torch/kernels/reshard_pack.py``), on the CPU:
:func:`start_table`'s int32 starts, and :func:`unpack_tables`' choice
between those starts (disjoint blocks) and last-writer segments
(overlapping blocks), replayed on the host as the kernels apply them, held
against the port's plain versions, the JAX package's references and, where
the starts are block-aligned, its Pallas kernels in interpret mode. The
table's form (by value in the kernel's parameters, or through the device
table) at the capacity's edge; the int32 refusal; the capacity constant of
the CUDA source against the wrapper's. Every comparison is byte-exact:
these are byte copies."""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.reshard_pack import pack_rows_pallas, unpack_rows_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import reshard_pack as rp

CU = Path(rp.__file__).resolve().parent / "csrc" / "row_tables.cuh"
CAP = rp.PARAM_STARTS
KINDS = ["repeated", "overlapping", "unsorted_disjoint", "sorted_disjoint"]


def _gather(table: np.ndarray, block: int, src: np.ndarray) -> np.ndarray:
    """pack_rows_kernel on int32 starts: block i of the output is the
    ``block`` rows of ``src`` from row table[i]."""
    assert table.dtype == np.int32 and table.flags["C_CONTIGUOUS"]
    out = np.full((table.size * block, src.shape[1]), np.nan, src.dtype)
    for i, s in enumerate(table.tolist()):
        out[i * block : (i + 1) * block] = src[s : s + block]
    return out


def _unpack(buf: np.ndarray, starts, block: int, rows: int) -> tuple[np.ndarray, str]:
    """unpack_rows_cuda's launch replayed: the zero-filled output, then the
    entry :func:`unpack_tables` picks (unpack_rows_kernel on the starts, or
    scatter_rows_kernel on the segments), no output row written twice."""
    entry, table = rp.unpack_tables(rp.start_table(starts, block, rows, "unpack_rows"), block, rows)
    assert table.dtype == np.int32 and table.flags["C_CONTIGUOUS"]
    out = np.zeros((rows, buf.shape[1]), buf.dtype)
    written = np.zeros(rows, bool)
    spans = (
        [(i * block, s, block) for i, s in enumerate(table.tolist())] if entry == "unpack_rows" else table.tolist()
    )
    for b, d, n in spans:
        assert n > 0 and not written[d : d + n].any(), (entry, b, d, n)
        written[d : d + n] = True
        out[d : d + n] = buf[b : b + n]
    return out, entry


def _draw_starts(rng, kind: str, R: int, block: int) -> np.ndarray:
    """Repeated starts are block-aligned (the Pallas kernels take them),
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


def _draws(kind: str, block: int, n: int = 40):
    rng = np.random.default_rng(block * 10 + len(kind))
    for draw in range(n):
        R = int(block * rng.integers(2, 9))  # a whole number of blocks, as the Pallas grids want
        starts = _draw_starts(rng, kind, R, block)
        yield draw, rng, R, starts


@pytest.mark.parametrize("block", range(1, 9))
@pytest.mark.parametrize("kind", KINDS)
def test_pack_starts_replay_the_references(kind, block):
    """Many draws against the port's plain version; the first against the
    JAX reference and, on aligned starts, the Pallas kernel."""
    for draw, rng, R, starts in _draws(kind, block):
        src = rng.normal(size=(R, 3)).astype(np.float32)
        table = rp.start_table(starts, block, R, "pack_rows")
        assert table.tolist() == starts.tolist()
        got = _gather(table, block, src)
        np.testing.assert_array_equal(got, ref.pack_rows_ref(torch.from_numpy(src), starts, block).numpy())
        if draw == 0:
            js = jnp.asarray(starts, jnp.int32)
            np.testing.assert_array_equal(got, np.asarray(jref.pack_rows_ref(jnp.asarray(src), js, block)))
            if kind != "overlapping":
                np.testing.assert_array_equal(got, np.asarray(pack_rows_pallas(jnp.asarray(src), js, block, interpret=True)))


@pytest.mark.parametrize("block", range(1, 9))
@pytest.mark.parametrize("kind", KINDS)
def test_unpack_routes_replay_the_references(kind, block):
    """Disjoint blocks take the starts, overlapping ones the last-writer
    segments; either way the result is the port's plain version (every
    uncovered row zero), the JAX reference on the first draw, and on the
    rows the Pallas kernel defines (aligned starts) its output."""
    routes = set()
    for draw, rng, R, starts in _draws(kind, block):
        buf = rng.normal(size=(starts.size * block, 3)).astype(np.float32)
        got, entry = _unpack(buf, starts, block, R)
        routes.add(entry)
        assert entry == ("unpack_rows" if ref.disjoint_blocks(starts, block) else "unpack_segments")
        want = ref.unpack_rows_ref(torch.from_numpy(buf), starts, block, R).numpy()
        np.testing.assert_array_equal(got, want)
        covered = np.zeros(R, bool)
        for s in starts.tolist():
            covered[s : s + block] = True
        assert not got[~covered].any()
        if draw == 0:
            js = jnp.asarray(starts, jnp.int32)
            np.testing.assert_array_equal(got, np.asarray(jref.unpack_rows_ref(jnp.asarray(buf), js, block, R)))
            if kind != "overlapping":
                pallas = np.asarray(unpack_rows_pallas(jnp.asarray(buf), js, block, R, interpret=True))
                np.testing.assert_array_equal(got[covered], pallas[covered])
    if kind != "overlapping":  # random overlapping starts may by chance be disjoint
        assert routes == ({"unpack_rows"} if kind.endswith("disjoint") else {"unpack_segments"})


@pytest.mark.parametrize("n", [1, CAP, CAP + 1])
@pytest.mark.parametrize("block", [1, 3])
def test_start_forms_at_the_capacity(n, block):
    """n disjoint blocks: by value up to the capacity, through the device
    table past it; pack and unpack replay to the plain versions and the
    JAX references."""
    rng = np.random.default_rng(n + block)
    R = 2 * block * n + 1
    starts = rng.permutation(np.arange(n) * 2 * block)  # unsorted: the buffer keeps block order
    src = rng.normal(size=(R, 2)).astype(np.float32)
    table = rp.start_table(starts, block, R, "pack_rows")
    assert table.size == n and rp.table_form(n, starts=True) == ("starts" if n <= CAP else "starts_device")
    packed = _gather(table, block, src)
    np.testing.assert_array_equal(packed, ref.pack_rows_ref(torch.from_numpy(src), starts, block).numpy())
    unpacked, entry = _unpack(packed, starts, block, R)
    assert entry == "unpack_rows"
    np.testing.assert_array_equal(unpacked, ref.unpack_rows_ref(torch.from_numpy(packed), starts, block, R).numpy())
    js = jnp.asarray(starts, jnp.int32)
    np.testing.assert_array_equal(packed, np.asarray(jref.pack_rows_ref(jnp.asarray(src), js, block)))
    np.testing.assert_array_equal(unpacked, np.asarray(jref.unpack_rows_ref(jnp.asarray(packed), js, block, R)))


def test_unpack_segments_take_the_segment_forms():
    """Overlapping blocks give segments: by value up to the segment
    capacity, through the device table past it."""
    cap = rp.PARAM_SEGS
    for n, form in ((cap, "param"), (cap + 1, "device")):
        starts = np.concatenate([np.arange(n - 1, -1, -1) * 2, [0]])  # row 0 named twice
        entry, segs = rp.unpack_tables(rp.start_table(starts, 1, 2 * n, "unpack_rows"), 1, 2 * n)
        assert entry == "unpack_segments" and len(segs) == n and rp.table_form(len(segs)) == form
        buf = np.arange(starts.size, dtype=np.float32)[:, None]
        got, _ = _unpack(buf, starts, 1, 2 * n)
        np.testing.assert_array_equal(got, ref.unpack_rows_ref(torch.from_numpy(buf), starts, 1, 2 * n).numpy())
        assert got[0, 0] == starts.size - 1  # the last block naming row 0 wins


def test_start_tables_are_int32_and_refuse_what_the_kernels_cannot_take():
    top = rp.INT32_MAX
    table = rp.start_table([top - 1], 1, top, "pack_rows")
    assert table.dtype == np.int32 and table.tolist() == [top - 1]
    assert rp.start_table(np.array([3, 0, 3]), 2, 5, "x").tolist() == [3, 0, 3]
    assert rp.start_table(torch.tensor([1, 4]), 1, 5, "x").dtype == np.int32
    with pytest.raises(ValueError, match="int32"):
        rp.start_table([0], 1, top + 1, "pack_rows")
    with pytest.raises(ValueError, match="leave the 5 rows"):
        rp.start_table([0, 4], 2, 5, "pack_rows")
    with pytest.raises(ValueError, match="leave the 5 rows"):
        rp.start_table([-1], 1, 5, "unpack_rows")
    with pytest.raises(ValueError, match="block_rows 0"):
        rp.start_table([0], 0, 5, "pack_rows")


def test_the_start_capacity_matches_the_cuda_source():
    """The by-value capacity of starts is named once in the CUDA source
    (the last size class) and once in the wrapper; the starts and the two
    pointers, the row pitch and block_rows beside them fit the 32,764 bytes
    of kernel parameters."""
    text = CU.read_text()
    classes = re.search(r"constexpr int kStartClasses\[\] = \{([\d,\s]+)\};", text)
    assert classes, "kStartClasses not found"
    sizes = [int(x) for x in classes.group(1).split(",")]
    assert sizes == sorted(sizes) and sizes[-1] == CAP
    assert "constexpr int kParamStarts = kStartClasses[2];" in text and len(sizes) == 3
    assert 4 * 8 + 4 + 4 * CAP <= 32764
