"""The compressed wire's plain versions (``pack_quant_rows_ref``,
``dequant_scatter_rows_ref``) against the JAX package's, **bit for bit**,
in int8 and fp8-e4m3 from float32 and bfloat16: the sweeps of
``tests/test_wire_quant.py`` (drawn here from numpy seeds), its edge tiles
(zero, denormal, 3.38e38), all-zero tiles, repeated starts with the last
one winning, and idempotence; the Pallas kernels in interpret mode on a
few cases too. The CUDA kernels run only on the card, where
``chip_smoke.py`` holds them against these plain versions; here the tests
cover what their wrappers do on the host: the argument checks and the
last-writer segment table that the dequantizing scatter launches, replayed
on the CPU with the kernel's per-row scale lookup.

The JAX test's error bound on bf16 draws (``err <= scale/2``) is not
copied: it does not hold on some draws (ROADMAP queue 3)."""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.reshard_quant import dequant_scatter_rows_pallas, pack_quant_rows_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import reshard_quant as rq
from repro_torch.kernels.reshard_pack import last_writer_segments

torch.set_num_threads(2)

FORMATS = ["int8", "fp8_e4m3"]
DTYPES = ["float32", "bfloat16"]


def _np(x) -> np.ndarray:
    """Raw bytes of a torch or JAX array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    a = np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint8)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(j, np.float32).copy()).to(getattr(torch, dtype))
    return j, t


def _case(seed: int):
    """One draw of test_wire_quant.py's sweep: 1-6 tiles of 1 or 8 rows at
    distinct block starts in (R, 128)."""
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(1, 7))
    block = int(rng.choice([1, 8]))
    R = block * int(rng.integers(max(nb, 2), 13))
    starts = (rng.choice(R // block, size=nb, replace=False) * block).astype(np.int32)
    return rng, R, block, starts


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("seed", range(6))
def test_pack_quant_rows_plain_equals_jax_bitwise(seed, fmt, dtype):
    rng, R, block, starts = _case(seed)
    scale = 10.0 ** rng.integers(-20, 20)
    js, ts = _pair(rng.normal(size=(R, 128)) * scale, dtype)
    q_j, s_j = jax_ref.pack_quant_rows_ref(js, jnp.asarray(starts), block, fmt)
    q_t, s_t = ops.pack_quant_rows(ts, starts, block, fmt)
    assert q_t.dtype == ref.WIRE_QDTYPE[fmt] and s_t.dtype == torch.float32
    assert q_t.shape == q_j.shape and s_t.shape == s_j.shape == (len(starts), 1)
    np.testing.assert_array_equal(_np(q_t), _np(q_j))
    np.testing.assert_array_equal(_np(s_t), _np(s_j))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("seed", range(4))
def test_dequant_scatter_rows_plain_equals_jax_bitwise(seed, fmt, dtype):
    rng, R, block, starts = _case(100 + seed)
    js, ts = _pair(rng.normal(size=(R, 128)), dtype)
    jd, td = _pair(rng.normal(size=(R, 128)), dtype)
    q_j, s_j = jax_ref.pack_quant_rows_ref(js, jnp.asarray(starts), block, fmt)
    q_t, s_t = ops.pack_quant_rows(ts, starts, block, fmt)
    out_j = jax_ref.dequant_scatter_rows_ref(jd, q_j, s_j, jnp.asarray(starts), block)
    out_t = ops.dequant_scatter_rows(td.clone(), q_t, s_t, starts, block)
    np.testing.assert_array_equal(_np(out_t), _np(out_j))
    named = np.zeros(R, bool)
    for s in starts:
        named[s : s + block] = True
    np.testing.assert_array_equal(_np(out_t[~named]), _np(td[~named]))  # untouched rows keep their bytes


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_versions_equal_the_pallas_kernels_in_interpret_mode(fmt):
    rng, R, block, starts = _case(7)
    js, ts = _pair(rng.normal(size=(R, 128)), "bfloat16")
    jd, td = _pair(rng.normal(size=(R, 128)), "bfloat16")
    q_p, s_p = pack_quant_rows_pallas(js, jnp.asarray(starts), block, fmt, interpret=True)
    q_t, s_t = ops.pack_quant_rows(ts, starts, block, fmt)
    np.testing.assert_array_equal(_np(q_t), _np(q_p))
    np.testing.assert_array_equal(_np(s_t), _np(s_p))
    out_p = dequant_scatter_rows_pallas(jd, q_p, s_p, jnp.asarray(starts), block, interpret=True)
    np.testing.assert_array_equal(_np(ops.dequant_scatter_rows(td, q_t, s_t, starts, block)), _np(out_p))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_edge_tiles_equal_jax_bitwise(fmt, dtype):
    """test_wire_quant.py::test_quant_edge_tiles: an all-zero tile (the
    scale floors at 1e-12), a denormal tile (1e-40) and a tile of 3.38e38,
    where x / scale lands a hair off qmax."""
    src = np.concatenate([np.zeros((1, 128)), np.full((1, 128), 1e-40), np.full((1, 128), 3.38e38)])
    js, ts = _pair(src, dtype)
    starts = np.asarray([0, 1, 2], np.int32)
    q_j, s_j = jax_ref.pack_quant_rows_ref(js, jnp.asarray(starts), 1, fmt)
    q_t, s_t = ops.pack_quant_rows(ts, starts, 1, fmt)
    np.testing.assert_array_equal(_np(q_t), _np(q_j))
    np.testing.assert_array_equal(_np(s_t), _np(s_j))
    assert np.isfinite(s_t.numpy()).all()
    jd, td = _pair(np.ones((3, 128)), dtype)
    out_j = jax_ref.dequant_scatter_rows_ref(jd, q_j, s_j, jnp.asarray(starts), 1)
    out_t = ops.dequant_scatter_rows(td, q_t, s_t, starts, 1)
    np.testing.assert_array_equal(_np(out_t), _np(out_j))
    out = out_t.float().numpy()
    np.testing.assert_array_equal(out[0], np.zeros(128))  # exact zeros
    assert np.isfinite(out).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_all_zero_tiles_quantize_to_zero(fmt):
    src = torch.zeros(16, 64)
    q, s = ops.pack_quant_rows(src, [0, 4, 8], 4, fmt)
    q_j, s_j = jax_ref.pack_quant_rows_ref(jnp.zeros((16, 64)), jnp.asarray([0, 4, 8], jnp.int32), 4, fmt)
    np.testing.assert_array_equal(_np(q), _np(q_j))
    np.testing.assert_array_equal(_np(s), _np(s_j))
    assert not q.float().any() and np.all(s.numpy() == np.float32(1e-12) * np.float32(1.0 / ref.WIRE_QMAX[fmt]))
    out = ops.dequant_scatter_rows(torch.ones(16, 64), q, s, [0, 4, 8], 4)
    assert not out[:12].any() and out[12:].eq(1).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_repeated_starts_last_wins_and_scatter_is_idempotent(fmt):
    """Repeated and overlapping starts resolve to the last tile, as the
    JAX reference's sequential loop does; applying the scatter twice
    changes nothing."""
    rng = np.random.default_rng(11)
    src = rng.normal(size=(40, 96)).astype(np.float32)
    dst = rng.normal(size=(40, 96)).astype(np.float32)
    for starts, block in (([5, 9, 5, 30, 9], 1), ([3, 17, 5, 5, 29], 8), ([0, 8, 16], 8)):
        st = np.asarray(starts, np.int32)
        q_j, s_j = jax_ref.pack_quant_rows_ref(jnp.asarray(src), jnp.asarray(st), block, fmt)
        want = jax_ref.dequant_scatter_rows_ref(jnp.asarray(dst), q_j, s_j, jnp.asarray(st), block)
        q, s = ops.pack_quant_rows(torch.from_numpy(src), st, block, fmt)
        once = ops.dequant_scatter_rows(torch.from_numpy(dst.copy()), q, s, st, block)
        np.testing.assert_array_equal(_np(once), _np(want))
        twice = ops.dequant_scatter_rows(once.clone(), q, s, st, block)
        np.testing.assert_array_equal(_np(twice), _np(once))


def test_round_trip_of_every_row_equals_the_jax_refs():
    """``quant_round_trip_ref``: what the wire delivers for a whole tensor
    (one tile a row of its 2-D collapse, as the executor sends it)."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(6, 4, 5)) * np.logspace(-8, 2, 6)[:, None, None]).astype(np.float32)
    rows = jnp.arange(6, dtype=jnp.int32)
    for fmt in FORMATS:
        q, s = jax_ref.pack_quant_rows_ref(jnp.asarray(x.reshape(6, 20)), rows, 1, fmt)
        want = jax_ref.dequant_scatter_rows_ref(jnp.zeros((6, 20)), q, s, rows, 1).reshape(6, 4, 5)
        np.testing.assert_array_equal(_np(ref.quant_round_trip_ref(torch.from_numpy(x), fmt)), _np(want))


def test_fp8_cast_matches_ml_dtypes_near_qmax():
    """The fp8 payload is torch's float8_e4m3fn cast; near qmax (448, the
    3.38e38 tile's x / scale) and at the rounding midpoints it must give
    ml_dtypes' result, which the JAX reference uses."""
    vals = np.asarray([448.0, 448.00003, 447.99997, 440.0, 432.0, 464.0 - 1e-3, -448.0, 1.0625, 1.1875,
                       2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, 0.0, -0.0], np.float32)
    got = torch.from_numpy(vals).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    want = vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the CUDA wrappers' host side
# ---------------------------------------------------------------------------


def _replay_dequant(dst, q, scales, starts, block_rows):
    """What the CUDA kernel does with the wrapper's segment table: each
    segment copies ``rows`` rows from buffer row ``b`` to destination row
    ``d``, each row scaled by its own tile's scale (buffer row // block)."""
    segs = last_writer_segments(np.asarray(starts, np.int64), block_rows)
    out = dst.clone()
    for b, d, rows in segs.tolist():
        for r in range(rows):
            out[d + r] = (q[b + r].float() * scales[(b + r) // block_rows, 0]).to(dst.dtype)
    return out, segs


@pytest.mark.parametrize("fmt", FORMATS)
def test_segment_table_replay_equals_the_plain_version(fmt):
    """Overlapping blocks merge into segments that span tiles; the kernel's
    per-row scale lookup must still pick each row's own tile."""
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.normal(size=(48, 16)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(48, 16)).astype(np.float32))
    for starts, block in (([0, 8, 16, 24], 8), ([3, 11, 7, 7, 30], 8), ([4, 4, 9, 10], 1)):
        q, s = ops.pack_quant_rows(src, starts, block, fmt)
        got, segs = _replay_dequant(dst, q, s, starts, block)
        want = ops.dequant_scatter_rows(dst.clone(), q, s, starts, block)
        assert torch.equal(got, want), (starts, block)
    assert len(last_writer_segments(np.asarray([0, 8, 16, 24]), 8)) == 4


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rq.pack_quant_rows_cuda(x, [0], 1, "int8")
    with pytest.raises(ValueError, match="CUDA"):
        rq.dequant_scatter_rows_cuda(x, x.to(torch.int8), torch.ones(1, 1), [0], 1)
    for bad in (lambda: ops.pack_quant_rows(x, [8], 1, "int8"), lambda: ops.pack_quant_rows(x, [-1], 1, "int8"),
                lambda: ops.dequant_scatter_rows(x, x[:1].to(torch.int8), torch.ones(1, 1), [7], 2)):
        with pytest.raises(ValueError, match="leave"):
            bad()
    with pytest.raises(ValueError, match="tiles"):
        ops.dequant_scatter_rows(x, x[:2].to(torch.int8), torch.ones(1, 1), [0], 1)
