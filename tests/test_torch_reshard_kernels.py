"""The port's reshard row copies (pack_rows, unpack_rows, scatter_rows,
relayout_rows) on the CPU: their plain versions against the JAX package's
Pallas kernels in interpret mode and its references, over the sweeps of
``tests/test_kernels.py``, plus what the Pallas kernels do not take
(unaligned and overlapping starts, narrow rows, int8 and bfloat16), the
zero-filled unpack, the refusal of starts that leave the array, and the
host-side segment tables that the CUDA wrappers launch. Every comparison
is exact: these are byte copies."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.reshard_pack import (
    pack_rows_pallas,
    relayout_rows_pallas,
    scatter_rows_pallas,
    unpack_rows_pallas,
)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import reshard_pack as rp

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16), "int8": (torch.int8, jnp.int8)}


def _arrays(rng, shape, dtype="float32"):
    """The same values as a torch tensor and a jax array."""
    tdt, jdt = DTYPES[dtype]
    if dtype == "int8":
        a = rng.integers(-128, 128, size=shape).astype(np.int8)
        return torch.from_numpy(a.copy()), jnp.asarray(a)
    a = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _np(x) -> np.ndarray:
    """Host bytes of a torch tensor or jax array, bfloat16 widened exactly."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _draw(seed, block_choices):
    """The draws of test_kernels.py's hypothesis strategies, from a seed."""
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(1, 7))
    block = int(rng.choice(block_choices))
    R = block * int(rng.integers(max(nb, 2), 13))
    starts = sorted(rng.choice(R // block, size=nb, replace=False) * block)
    return rng, nb, block, R, [int(s) for s in starts]


# ---------------------------------------------------------------------------
# The JAX sweeps (block-aligned starts): plain version == Pallas == JAX ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_pack_unpack_roundtrip(seed):
    rng, nb, block, R, starts = _draw(seed, [8, 16])
    src_t, src_j = _arrays(rng, (R, 128))
    js = jnp.asarray(starts, jnp.int32)
    packed = ops.pack_rows(src_t, starts, block)
    np.testing.assert_array_equal(_np(packed), _np(pack_rows_pallas(src_j, js, block, interpret=True)))
    np.testing.assert_array_equal(_np(packed), _np(jref.pack_rows_ref(src_j, js, block)))
    un = ops.unpack_rows(packed, starts, block, R)
    # the port zero-fills like the JAX ref; the Pallas kernel defines only
    # the covered rows
    np.testing.assert_array_equal(_np(un), _np(jref.unpack_rows_ref(jnp.asarray(_np(packed)), js, block, R)))
    un_p = np.asarray(unpack_rows_pallas(jnp.asarray(_np(packed)), js, block, R, interpret=True))
    for s in starts:
        np.testing.assert_array_equal(_np(un)[s : s + block], un_p[s : s + block])
        np.testing.assert_array_equal(_np(un)[s : s + block], _np(src_t)[s : s + block])


@pytest.mark.parametrize("seed", range(5))
def test_scatter_rows_property(seed):
    """Untouched destination rows keep their bytes; the scatter writes in
    place and returns its destination."""
    rng, nb, block, R, starts = _draw(seed, [1, 8])
    rng.shuffle(starts)
    dst_t, dst_j = _arrays(rng, (R, 128))
    buf_t, buf_j = _arrays(rng, (nb * block, 128))
    js = jnp.asarray(starts, jnp.int32)
    exp = _np(dst_t).copy()
    for i, s in enumerate(starts):
        exp[s : s + block] = _np(buf_t)[i * block : (i + 1) * block]
    out = ops.scatter_rows(dst_t, buf_t, starts, block)
    assert out is dst_t
    np.testing.assert_array_equal(_np(out), exp)
    np.testing.assert_array_equal(_np(jref.scatter_rows_ref(dst_j, buf_j, js, block)), exp)
    np.testing.assert_array_equal(_np(scatter_rows_pallas(dst_j, buf_j, js, block, interpret=True)), exp)


def test_scatter_rows_duplicate_starts_last_wins():
    rng = np.random.default_rng(1)
    dst_t, dst_j = _arrays(rng, (16, 128))
    buf_t, buf_j = _arrays(rng, (3, 128))
    starts = [4, 4, 9]
    exp = _np(dst_t).copy()
    exp[4] = _np(buf_t)[1]
    exp[9] = _np(buf_t)[2]
    js = jnp.asarray(starts, jnp.int32)
    np.testing.assert_array_equal(_np(ops.scatter_rows(dst_t, buf_t, starts, 1)), exp)
    np.testing.assert_array_equal(_np(jref.scatter_rows_ref(dst_j, buf_j, js, 1)), exp)
    np.testing.assert_array_equal(_np(scatter_rows_pallas(dst_j, buf_j, js, 1, interpret=True)), exp)


def test_scatter_rows_idempotent():
    rng = np.random.default_rng(2)
    dst_t, dst_j = _arrays(rng, (24, 128))
    buf_t, buf_j = _arrays(rng, (4, 128))
    starts = [2, 7, 11, 21]
    once = ops.scatter_rows(dst_t.clone(), buf_t, starts, 1)
    twice = ops.scatter_rows(once.clone(), buf_t, starts, 1)
    np.testing.assert_array_equal(_np(once), _np(twice))
    js = jnp.asarray(starts, jnp.int32)
    np.testing.assert_array_equal(_np(once), _np(scatter_rows_pallas(dst_j, buf_j, js, 1, interpret=True)))


@pytest.mark.parametrize("seed", range(5))
def test_relayout_rows_property(seed):
    rng, nb, block, R, starts = _draw(seed, [1, 8])
    dst_t, dst_j = _arrays(rng, (R, 128))
    src_t, src_j = _arrays(rng, (R, 128))
    js = jnp.asarray(starts, jnp.int32)
    exp = _np(dst_t).copy()
    for s in starts:
        exp[s : s + block] = _np(src_t)[s : s + block]
    out = ops.relayout_rows(dst_t, src_t, starts, block)
    assert out is dst_t
    np.testing.assert_array_equal(_np(out), exp)
    np.testing.assert_array_equal(_np(jref.relayout_rows_ref(dst_j, src_j, js, block)), exp)
    np.testing.assert_array_equal(_np(relayout_rows_pallas(dst_j, src_j, js, block, interpret=True)), exp)


def test_relayout_rows_idempotent_and_matches_pack_scatter():
    rng = np.random.default_rng(3)
    src_t, src_j = _arrays(rng, (32, 128))
    dst_t, dst_j = _arrays(rng, (32, 128))
    rows = [0, 3, 4, 11, 30]
    via_pack = ops.scatter_rows(dst_t.clone(), ops.pack_rows(src_t, rows, 1), rows, 1)
    once = ops.relayout_rows(dst_t.clone(), src_t, rows, 1)
    np.testing.assert_array_equal(_np(once), _np(via_pack))
    np.testing.assert_array_equal(_np(ops.relayout_rows(once.clone(), src_t, rows, 1)), _np(once))
    js = jnp.asarray(rows, jnp.int32)
    np.testing.assert_array_equal(_np(relayout_rows_pallas(dst_j, src_j, js, 1, interpret=True)), _np(once))


# ---------------------------------------------------------------------------
# What the Pallas kernels do not take: the JAX ref settles it
# ---------------------------------------------------------------------------

# unaligned, overlapping (starts closer than block_rows) and repeated starts
OVERLAP_STARTS = [[3, 17, 5, 5, 29], [30, 1, 12, 9, 2]]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("C", [1, 3, 130])
def test_unaligned_overlapping_starts_match_jax_ref(dtype, C):
    rng = np.random.default_rng(C)
    R, block = 40, 8
    for starts in OVERLAP_STARTS:
        js = jnp.asarray(starts, jnp.int32)
        src_t, src_j = _arrays(rng, (R, C), dtype)
        dst_t, dst_j = _arrays(rng, (R, C), dtype)
        buf_t, buf_j = _arrays(rng, (len(starts) * block, C), dtype)
        pairs = [
            (ops.pack_rows(src_t, starts, block), jref.pack_rows_ref(src_j, js, block)),
            (ops.unpack_rows(buf_t, starts, block, R), jref.unpack_rows_ref(buf_j, js, block, R)),
            (ops.scatter_rows(dst_t.clone(), buf_t, starts, block), jref.scatter_rows_ref(dst_j, buf_j, js, block)),
            (ops.relayout_rows(dst_t.clone(), src_t, starts, block), jref.relayout_rows_ref(dst_j, src_j, js, block)),
        ]
        for got, want in pairs:
            assert got.dtype == DTYPES[dtype][0]
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=f"{starts}")


def test_unpack_zero_fills_uncovered_rows():
    rng = np.random.default_rng(4)
    buf, _ = _arrays(rng, (2 * 4, 5))
    out = ops.unpack_rows(buf, [2, 11], 4, 20)
    covered = np.zeros(20, bool)
    covered[2:6] = covered[11:15] = True
    assert not _np(out)[~covered].any()
    np.testing.assert_array_equal(_np(out)[2:6], _np(buf)[:4])
    np.testing.assert_array_equal(_np(out)[11:15], _np(buf)[4:])


def test_empty_offset_table_moves_nothing():
    rng = np.random.default_rng(5)
    src, _ = _arrays(rng, (6, 4))
    dst, _ = _arrays(rng, (6, 4))
    before = dst.clone()
    assert ops.pack_rows(src, [], 3).shape == (0, 4)
    assert torch.equal(ops.scatter_rows(dst, src[:0], [], 3), before)
    assert torch.equal(ops.relayout_rows(dst, src, [], 3), before)
    assert not ops.unpack_rows(src[:0], [], 3, 6).any()


# ---------------------------------------------------------------------------
# Starts that leave the array: JAX clamps them, the port refuses them
# ---------------------------------------------------------------------------


def test_jax_ref_clamps_a_start_past_the_end():
    """What the port refuses: the JAX ref's dynamic_slice moves the start
    back into range and packs other rows than were named."""
    src = jnp.arange(12, dtype=jnp.float32).reshape(6, 2)
    got = np.asarray(jref.pack_rows_ref(src, jnp.asarray([5], jnp.int32), 3))
    np.testing.assert_array_equal(got, np.asarray(src)[3:6])


@pytest.mark.parametrize("fn", ["pack_rows", "unpack_rows", "scatter_rows", "relayout_rows"])
@pytest.mark.parametrize("starts", [[5], [-1], [0, 4]])
def test_port_refuses_starts_that_leave_the_array(fn, starts):
    rows = torch.zeros(6, 2)
    buf = torch.zeros(3 * len(starts), 2)
    call = {
        "pack_rows": lambda: ops.pack_rows(rows, starts, 3),
        "unpack_rows": lambda: ops.unpack_rows(buf, starts, 3, 6),
        "scatter_rows": lambda: ops.scatter_rows(rows, buf, starts, 3),
        "relayout_rows": lambda: ops.relayout_rows(rows, rows.clone(), starts, 3),
    }[fn]
    with pytest.raises(ValueError, match="leave the 6 rows"):
        call()


# ---------------------------------------------------------------------------
# The segment tables the CUDA wrappers launch, replayed on the host
# ---------------------------------------------------------------------------


def _replay(segs, dst, src):
    """Apply segments (src_row, dst_row, rows) as the kernels do; check that
    no destination row is written twice."""
    out = dst.copy()
    written = np.zeros(len(dst), bool)
    for s, d, n in segs.tolist():
        assert n > 0 and not written[d : d + n].any()
        written[d : d + n] = True
        out[d : d + n] = src[s : s + n]
    return out, written


@pytest.mark.parametrize("seed", range(4))
def test_segment_tables_give_the_sequential_result(seed):
    """The last writer of every row is resolved on the host, so a grid with
    no order writes what the reference's block-ordered loop writes."""
    rng = np.random.default_rng(seed)
    for _ in range(150):
        R = int(rng.integers(1, 40))
        block = int(rng.integers(1, min(R, 8) + 1))
        nb = int(rng.integers(0, 8))
        starts = rng.integers(0, R - block + 1, nb)
        dst = rng.normal(size=(R, 2))
        src = rng.normal(size=(R, 2))
        buf = rng.normal(size=(nb * block, 2))
        want = ref.scatter_rows_ref(torch.from_numpy(dst.copy()), torch.from_numpy(buf), starts, block).numpy()
        got, _ = _replay(rp.last_writer_segments(starts, block), dst, buf)
        np.testing.assert_array_equal(got, want)
        want = ref.relayout_rows_ref(torch.from_numpy(dst.copy()), torch.from_numpy(src), starts, block).numpy()
        segs = rp.covered_segments(starts, block)
        assert (segs[:, 0] == segs[:, 1]).all()
        got, _ = _replay(segs, dst, src)
        np.testing.assert_array_equal(got, want)
        # unpack: the zero-filled output, then the starts of disjoint blocks
        # (as segments of one block each) or the last writers' segments
        want = ref.unpack_rows_ref(torch.from_numpy(buf), starts, block, R).numpy()
        entry, table = rp.unpack_tables(rp.start_table(starts, block, R, "unpack_rows"), block, R)
        if entry == "unpack_rows":
            table = np.stack([np.arange(nb) * block, table, np.full(nb, block)], axis=1)
        got, written = _replay(table, np.zeros((R, 2)), buf)
        assert not got[~written].any()
        np.testing.assert_array_equal(got, want)


def test_disjoint_blocks_launch_one_segment_each():
    segs = rp.last_writer_segments(np.array([12, 0, 4]), 4)
    assert segs.tolist() == [[0, 12, 4], [4, 0, 4], [8, 4, 4]]
    assert rp.covered_segments(np.array([12, 0, 4]), 4).tolist() == [[0, 0, 8], [12, 12, 4]]


def test_dispatch_refuses_mixed_devices():
    cpu = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="different devices"):
        ops.scatter_rows(cpu, torch.zeros(2, 2, device="meta"), [0, 1], 1)
    with pytest.raises(ValueError, match="no path for device meta"):
        ops.pack_rows(torch.zeros(4, 2, device="meta"), [0], 1)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never takes the plain path: only ``ops`` chooses it, by
    device, and the wrapper refuses a CPU tensor."""
    with pytest.raises(ValueError, match="want CUDA tensors"):
        rp.pack_rows_cuda(torch.zeros(4, 2), [0], 1)
    with pytest.raises(ValueError, match="want CUDA tensors"):
        rp.scatter_rows_cuda(torch.zeros(4, 2), torch.zeros(1, 2), [0], 1)
