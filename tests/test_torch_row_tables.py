"""The segment tables that the port's scatter_rows and relayout_rows CUDA
wrappers launch (``repro_torch/kernels/reshard_pack.py``), on the CPU:
:func:`coalesced_segments` encoded by :func:`row_table` as the kernels'
int32 triples and replayed on the host as the kernels apply them, held
against the port's plain versions and the JAX package's references. The
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
from repro_torch.kernels import ref
from repro_torch.kernels import reshard_pack as rp
from repro_torch.reshard.executors import _runs

CU = Path(rp.__file__).resolve().parent / "csrc" / "row_tables.cuh"
CAP = rp.PARAM_SEGS


def _replay(table: np.ndarray, dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Apply int32 segments (src_row, dst_row, rows) as the kernels do; no
    destination row may be written twice."""
    assert table.dtype == np.int32 and table.flags["C_CONTIGUOUS"]
    out = dst.copy()
    written = np.zeros(len(dst), bool)
    for s, d, n in table.tolist():
        assert n > 0 and not written[d : d + n].any(), (s, d, n)
        written[d : d + n] = True
        out[d : d + n] = src[s : s + n]
    return out


def _tables(starts: np.ndarray, block: int, rows: int):
    """The int32 scatter and relayout tables the wrappers would launch."""
    scatter = rp.row_table(rp.coalesced_segments(starts, block), rows)
    relayout = rp.row_table(rp.coalesced_segments(starts, block, relayout=True), rows)
    assert (relayout[:, 0] == relayout[:, 1]).all()
    return scatter, relayout


def _plain(dst, src, starts, block, relayout=False) -> np.ndarray:
    """The port's plain version: ``src`` is the buffer of a scatter, the
    source array of a relayout."""
    fn = ref.relayout_rows_ref if relayout else ref.scatter_rows_ref
    return fn(torch.from_numpy(dst.copy()), torch.from_numpy(src), starts, block).numpy()


def _jax(dst, src, starts, block, relayout=False) -> np.ndarray:
    """The JAX package's reference on the same inputs."""
    fn = jref.relayout_rows_ref if relayout else jref.scatter_rows_ref
    return np.asarray(fn(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(starts, jnp.int32), block))


def _draw_starts(rng, kind: str, R: int, block: int) -> np.ndarray:
    slots = np.arange(0, R - block + 1, block)
    nb = int(rng.integers(1, 10))
    if kind == "repeated":
        base = rng.integers(0, R - block + 1, max(1, nb // 2))
        return np.concatenate([base, rng.choice(base, nb - base.size + 1)])
    if kind == "overlapping":
        return rng.integers(0, R - block + 1, nb)
    picked = rng.choice(slots, size=min(nb, slots.size), replace=False)
    if kind == "sorted_disjoint":
        return np.sort(picked)
    return picked  # unsorted_disjoint


@pytest.mark.parametrize("block", range(1, 9))
@pytest.mark.parametrize("kind", ["repeated", "overlapping", "unsorted_disjoint", "sorted_disjoint"])
def test_tables_replay_the_plain_versions(kind, block):
    """Many draws against the port's plain versions; the first few against
    the JAX package's references as well."""
    rng = np.random.default_rng(block * 10 + len(kind))
    for draw in range(60):
        R = int(block * rng.integers(2, 9) + rng.integers(0, block))
        starts = _draw_starts(rng, kind, R, block)
        dst, src = rng.normal(size=(R, 3)).astype(np.float32), rng.normal(size=(R, 3)).astype(np.float32)
        buf = rng.normal(size=(starts.size * block, 3)).astype(np.float32)
        scatter, relayout = _tables(starts, block, max(R, buf.shape[0]))
        got_s, got_r = _replay(scatter, dst, buf), _replay(relayout, dst, src)
        np.testing.assert_array_equal(got_s, _plain(dst, buf, starts, block))
        np.testing.assert_array_equal(got_r, _plain(dst, src, starts, block, relayout=True))
        if draw < 2:
            np.testing.assert_array_equal(got_s, _jax(dst, buf, starts, block))
            np.testing.assert_array_equal(got_r, _jax(dst, src, starts, block, relayout=True))


@pytest.mark.parametrize("n", [CAP - 1, CAP, CAP + 1])
@pytest.mark.parametrize("block", [1, 3])
def test_table_forms_at_the_capacity(n, block):
    """n disjoint blocks with gaps between them are n segments: by value up
    to the capacity, through the device table past it; both replay to the
    plain versions and the JAX references."""
    rng = np.random.default_rng(n + block)
    R = 2 * block * n + 1
    starts = rng.permutation(np.arange(n) * 2 * block)  # unsorted: a scatter keeps block order
    dst, src = rng.normal(size=(R, 2)).astype(np.float32), rng.normal(size=(R, 2)).astype(np.float32)
    buf = rng.normal(size=(n * block, 2)).astype(np.float32)
    scatter, relayout = _tables(starts, block, R)
    assert len(scatter) == len(relayout) == n
    assert rp.table_form(n) == ("param" if n <= CAP else "device")
    got_s, got_r = _replay(scatter, dst, buf), _replay(relayout, dst, src)
    np.testing.assert_array_equal(got_s, _plain(dst, buf, starts, block))
    np.testing.assert_array_equal(got_r, _plain(dst, src, starts, block, relayout=True))
    np.testing.assert_array_equal(got_s, _jax(dst, buf, starts, block))
    np.testing.assert_array_equal(got_r, _jax(dst, src, starts, block, relayout=True))


def test_one_segment_and_the_overlapping_starts():
    """The elastic path's per-layer move is one segment; the overlapping,
    repeated starts of the card's cases resolve to their last writers."""
    assert rp.coalesced_segments(np.array([5]), 1).tolist() == [[0, 5, 1]]
    assert rp.coalesced_segments(np.array([5]), 1, relayout=True).tolist() == [[5, 5, 1]]
    rng = np.random.default_rng(3)
    for starts in ([3, 17, 5, 5, 29], [30, 1, 12, 9, 2]):
        st = np.asarray(starts)
        dst, buf = rng.normal(size=(40, 2)), rng.normal(size=(40, 2))
        scatter, relayout = _tables(st, 8, 40)
        np.testing.assert_array_equal(_replay(scatter, dst, buf), _plain(dst, buf, st, 8))
        np.testing.assert_array_equal(_replay(relayout, dst, buf), _plain(dst, buf, st, 8, relayout=True))


def test_a_row_index_past_int32_is_refused():
    top = rp.INT32_MAX
    segs = rp.coalesced_segments(np.array([top - 1]), 1)
    assert rp.row_table(segs, top).tolist() == [[0, top - 1, 1]]
    with pytest.raises(ValueError, match="int32"):
        rp.row_table(rp.coalesced_segments(np.array([top]), 1), top + 1)
    with pytest.raises(ValueError, match="int32"):
        rp.row_table(np.zeros((0, 3), np.int64), 2**40)


def test_the_capacity_constant_matches_the_cuda_source():
    """The by-value capacity is named once in the CUDA source (the last size
    class) and once in the wrapper; the table and the two pointers and the
    row pitch beside it fit the 32,764 bytes of kernel parameters."""
    text = CU.read_text()
    classes = re.search(r"constexpr int kParamClasses\[\] = \{([\d,\s]+)\};", text)
    assert classes, "kParamClasses not found"
    sizes = [int(x) for x in classes.group(1).split(",")]
    assert sizes == sorted(sizes) and sizes[-1] == CAP
    assert "constexpr int kParamSegs = kParamClasses[2];" in text and len(sizes) == 3
    assert 3 * 8 + 4 + 3 * 4 * CAP <= 32764


@pytest.mark.parametrize("seed", range(3))
def test_coalesced_segments_never_write_a_row_twice(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        R = int(rng.integers(2, 80))
        block = int(rng.integers(1, min(R, 8) + 1))
        starts = rng.integers(0, R - block + 1, int(rng.integers(1, 20)))
        covered = np.zeros(R, bool)
        for s in starts:
            covered[s : s + block] = True
        for relayout in (False, True):
            counts = np.zeros(R, int)
            for _, d, n in rp.coalesced_segments(starts, block, relayout).tolist():
                counts[d : d + n] += 1
            assert counts.max() == 1 and np.array_equal(counts == 1, covered)


@pytest.mark.parametrize("seed", range(3))
def test_executor_one_row_blocks_give_one_segment_per_run(seed):
    """``_move_rows`` passes scattered rows as sorted blocks of one row: the
    table has one segment per contiguous run, in the buffer's order."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        rows = sorted(int(r) for r in rng.choice(200, int(rng.integers(2, 60)), replace=False))
        runs = _runs(rows)
        segs = rp.coalesced_segments(np.asarray(rows), 1)
        buf_rows = np.cumsum([0] + [hi - lo for lo, hi in runs])[:-1]
        assert segs.tolist() == [[int(b), lo, hi - lo] for b, (lo, hi) in zip(buf_rows, runs)]
        assert rp.coalesced_segments(np.asarray(rows), 1, relayout=True).tolist() == [
            [lo, lo, hi - lo] for lo, hi in runs]
