"""The port's flash-attention plain version and dispatch, held against the
JAX package: ``flash_attention_pallas`` in interpret mode and
``repro.kernels.ref``. The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against this plain version; here the tests cover
its argument checks, which run before any launch.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

torch.set_num_threads(2)

# f32: both sides compute in f32 with other summation orders
F32_TOL = 1e-5
# bf16 inputs, outputs rounded to bf16 and compared in f32 (the JAX test's own)
BF16_TOL = 2e-2

SWEEP = [  # (b, s, h, kh, d, causal, window): tests/test_kernels.py's sweep
    (1, 128, 2, 2, 64, True, 0),
    (2, 256, 4, 2, 64, True, 0),
    (2, 256, 4, 1, 32, True, 128),  # MQA + sliding window
    (1, 128, 2, 2, 128, False, 0),
    (1, 384, 6, 3, 64, True, 0),  # GQA rep=2, 3 blocks
]


def _inputs(b, s, t, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in [(b, s, h, d), (b, t, kh, d), (b, t, kh, d)])


def _both(arrays, dtype: str):
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    tx = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return jx, tx


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", SWEEP)
def test_flash_ref_matches_pallas_and_jax_ref(b, s, h, kh, d, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, s, s, h, kh, d), dtype)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, interpret=True)
    jref = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(jref), atol=tol, rtol=tol)


def test_flash_ref_right_aligned_queries():
    """t > s: queries right-aligned at t - s (a continuation chunk)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 128, 256, 2, 2, 64, seed=1), "float32")
    got = ref.flash_attention_ref(tq, tk, tv, causal=True)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize(
    "s,t,causal,window",
    [(200, 200, True, 64), (37, 91, True, 0), (91, 91, True, 5), (70, 150, False, 0), (150, 70, False, 32)],
)
def test_flash_ref_ragged_shapes_match_jax_ref(s, t, causal, window):
    """Shapes the TPU kernel's tiling refuses, which the CUDA kernel takes
    (chip_smoke.py runs the same ones on the card): the plain versions
    agree there too."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, s, t, 4, 2, 32, seed=2), "float32")
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_flash_ref_gqa_maps_head_to_group():
    """q head hi reads kv head hi // (h/kh), not hi % kh (rep = 2)."""
    q, k, v = _inputs(1, 16, 16, 4, 2, 16, seed=3)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=False).numpy()
    for hi in range(4):
        kv = hi // 2
        one = ref.flash_attention_ref(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q[:, :, hi : hi + 1], k[:, :, kv : kv + 1], v[:, :, kv : kv + 1])),
            causal=False,
        ).numpy()
        np.testing.assert_allclose(got[:, :, hi : hi + 1], one, atol=1e-6)


def test_flash_ref_row_without_keys_is_mean_of_v():
    """Causal t < s: the first rows see no key. Like the JAX ref they get the
    mean of v (uniform softmax over -1e30); the CUDA wrapper refuses it."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 8, 4, 2, 2, 16, seed=4), "float32")
    got = ref.flash_attention_ref(tq, tk, tv, causal=True).numpy()
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL)
    np.testing.assert_allclose(got[:, 0], tv.numpy().mean(axis=1), atol=1e-6)
    assert np.isfinite(got).all()
    with pytest.raises(ValueError, match="t=4 < s=8"):
        fa.check_args(tq, tk, tv, causal=True, window=0)


def test_decode_attention_ref_matches_jax_with_ring_mask():
    b, T, h, kh, d = 2, 16, 4, 2, 32
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, T, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, T, kh, d)).astype(np.float32)
    pos, window = 37, 12  # ring of 16 slots, window 12
    idx = np.arange(T)
    abs_pos = pos - ((pos - idx) % T)
    valid = (abs_pos <= pos) & (abs_pos >= 0) & (abs_pos > pos - window)
    mask = valid[None, None, None, :]
    assert 0 < valid.sum() < T
    got = ref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, mask)), d**-0.5)
    want = jax_ref.decode_attention_ref(*map(jnp.asarray, (q, k, v, mask)), d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_ops_flash_attention_on_cpu_uses_plain_version():
    _, (q, k, v) = _both(_inputs(2, 64, 64, 4, 2, 32, seed=6), "float32")
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=True, window=16, scale=0.3)
    assert fa.launches == before == 0
    want = ref.flash_attention_ref(q, k, v, causal=True, window=16, scale=0.3)
    assert torch.equal(got, want)


def test_ops_flash_attention_refuses_mixed_devices():
    _, (q, k, v) = _both(_inputs(1, 8, 8, 2, 2, 16), "float32")
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention(q.to("meta"), k, v)
    with pytest.raises(ValueError, match="no path"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize(
    "change,match",
    [
        (dict(d=48), "head dim 48"),
        (dict(dtype=torch.float16), "dtypes"),
        (dict(kh=4), "not a multiple"),
        (dict(t=8, s=16), "first query rows see no key"),
        (dict(window=-1), "window"),
    ],
)
def test_cuda_wrapper_refuses_what_the_kernel_does_not_compute(change, match):
    p = dict(b=1, s=16, t=16, h=6, kh=2, d=32, dtype=torch.float32, window=0) | change
    q = torch.zeros(p["b"], p["s"], p["h"], p["d"], dtype=p["dtype"])
    k = torch.zeros(p["b"], p["t"], p["kh"], p["d"], dtype=p["dtype"])
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_cuda(q, k, k.clone(), causal=True, window=p["window"])
    assert fa.launches == 0


def test_cuda_wrapper_refuses_cpu_strided_and_misaligned_tensors():
    _, (q, k, v) = _both(_inputs(1, 16, 16, 2, 2, 32), "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    shifted = torch.zeros(q.numel() + 2)[2:].view(q.shape)  # contiguous, 8 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_cuda(shifted, k, v)
    assert fa.launches == 0


def test_build_names_nvcc_when_missing(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_build_key_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// a")
    monkeypatch.setattr(build, "CSRC", src)
    first = build.library_path("k")
    assert first.parent == build.BUILD_DIR and first.suffix == ".so"
    (src / "k.cu").write_text("// b")
    assert build.library_path("k") != first
    (src / "other.cu").write_text("// c")  # another kernel's source does not rebuild k
    second = build.library_path("k")
    (src / "other.cu").write_text("// d")
    assert build.library_path("k") == second
    assert build.source_hash("other") != build.source_hash("k")
