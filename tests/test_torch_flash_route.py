"""The flash-attention routes of the port: which kernel a (dtype, head dim)
goes to, and the tensor-core route's numerics emulated in plain torch.

The tensor-core kernels (``csrc/flash_attention_tc.cu``,
``csrc/flash_attention_bwd_tc.cu``) run only on the card, where
``chip_smoke.py`` holds them against the plain version. What they do
differently from the fp32 CUDA-core kernels is round two operands to bf16:
P before P.V in the forward, and P before P^T.dO and dS before dS^T.Q and
dS.K in the backward. The emulation below does the same in plain torch
(an online softmax over 64-key tiles for the forward; autograd with those
roundings for the backward) and is held against the JAX package over its
kernel test sweep, within the tolerance ``chip_smoke.py`` holds the kernels
to: so the tolerance is shown to hold before any card run.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

# bf16 inputs, outputs rounded to bf16 and compared in f32 (the JAX test's
# own; chip_smoke.py's TOL and BWD_TOL for bf16)
BF16_TOL = 2e-2
KEY_TILE = 64  # the kernels' key tile

SWEEP = [  # (b, s, h, kh, d, causal, window): tests/test_kernels.py's sweep
    (1, 128, 2, 2, 64, True, 0),
    (2, 256, 4, 2, 64, True, 0),
    (2, 256, 4, 1, 32, True, 128),  # MQA + sliding window
    (1, 128, 2, 2, 128, False, 0),
    (1, 384, 6, 3, 64, True, 0),  # GQA rep=2, 3 blocks
]


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_is_a_function_of_dtype_and_head_dim(dtype, d):
    want = "tensor_cores" if dtype == torch.bfloat16 and d in (64, 128, 256) else "cuda_cores"
    assert fa.route(dtype, d) == want
    assert want in fa.ROUTES


@pytest.mark.parametrize(
    "dtype,d,route,match",
    [
        (torch.float32, 64, "tensor_cores", "tensor-core route takes bf16"),
        (torch.bfloat16, 32, "tensor_cores", "tensor-core route takes bf16"),
        (torch.bfloat16, 64, "wgmma", "not in"),
    ],
)
def test_wrappers_refuse_a_route_that_does_not_take_the_case(dtype, d, route, match):
    q = torch.zeros(1, 64, 2, d, dtype=dtype)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_cuda(q, q, q, route=route)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse, q, route=route)
    assert fa.launches == fa.tc_launches == fa.bwd_launches == fa.tc_bwd_launches == 0


def test_build_key_follows_the_shared_header(monkeypatch, tmp_path):
    """The tensor-core sources include ``csrc/wgmma.cuh``: an edit of it
    rebuilds them."""
    assert {"flash_attention_tc", "flash_attention_bwd_tc"} <= {p.stem for p in build.CSRC.glob("*.cu")}
    assert (build.CSRC / "wgmma.cuh").is_file()
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "wgmma.cuh"')
    (src / "wgmma.cuh").write_text("// a")
    monkeypatch.setattr(build, "CSRC", src)
    first = build.library_path("k")
    (src / "wgmma.cuh").write_text("// b")
    assert build.library_path("k") != first


def _inputs(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)]
    q, k, v, g = (torch.from_numpy(rng.normal(size=x).astype(np.float32)).bfloat16() for x in shapes)
    return q, k, v, g


def _mask(s, t, causal, window):
    qpos = torch.arange(s)[:, None] + (t - s)
    kpos = torch.arange(t)[None, :]
    mask = kpos <= qpos if causal else torch.ones(s, t, dtype=torch.bool)
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, scale, causal, window):
    """(b, h, s, t) fp32 scores of bf16 q and k (products of bf16 values are
    exact in fp32, as in the tensor cores), scaled after the product,
    masked by -inf."""
    rep = q.shape[2] // k.shape[2]
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    return s.masked_fill(~_mask(q.shape[1], k.shape[1], causal, window), float("-inf"))


def emulate_tc_forward(q, k, v, causal, window):
    """The forward kernel's numerics: an online softmax over 64-key tiles in
    fp32, P rounded to bf16 before P.V, fp32 sums, O / l rounded to bf16."""
    scale = q.shape[-1] ** -0.5
    rep = q.shape[2] // k.shape[2]
    vf = torch.repeat_interleave(v.float(), rep, dim=2).transpose(1, 2)  # (b, h, t, d)
    s_all = _scores(q, k, scale, causal, window)
    b, h, s, t = s_all.shape
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, q.shape[-1]))
    for k0 in range(0, t, KEY_TILE):
        sc = s_all[..., k0 : k0 + KEY_TILE]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0 : k0 + KEY_TILE]
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.transpose(1, 2).bfloat16()


class _RoundedForward(torch.autograd.Function):
    """x rounded to bf16 on the way forward, the gradient passed as it is."""

    @staticmethod
    def forward(ctx, x):
        return x.bfloat16().float()

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundedGradient(torch.autograd.Function):
    """x on the way forward, the gradient rounded to bf16 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g.bfloat16().float()


def emulate_tc_backward(q, k, v, g, causal, window):
    """(dq, dk, dv) of the backward kernel's numerics, through autograd:
    fp32 scores and softmax, P rounded to bf16 in dV = P^T dO, dS rounded to
    bf16 in dK = scale dS^T Q and dQ = scale dS K, each rounded to bf16."""
    qf, kf, vf = (x.float().requires_grad_(True) for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    rep = q.shape[2] // k.shape[2]
    s = _RoundedGradient.apply(_scores(qf, kf, scale, causal, window))
    p = torch.softmax(s, dim=-1)
    vr = torch.repeat_interleave(vf, rep, dim=2).transpose(1, 2)
    out = (_RoundedForward.apply(p) @ vr).transpose(1, 2)
    grads = torch.autograd.grad(out, (qf, kf, vf), g.float())
    return tuple(x.bfloat16() for x in grads)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", SWEEP)
def test_tensor_core_forward_numerics_match_pallas_and_jax_ref(b, s, h, kh, d, causal, window):
    q, k, v, _ = _inputs(b, s, h, kh, d, seed=b * 100 + s + d)
    got = emulate_tc_forward(q, k, v, causal, window)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    jq, jk, jv = (jnp.asarray(_np(x), jnp.bfloat16) for x in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, interpret=True)
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", SWEEP)
def test_tensor_core_backward_numerics_match_jax_grad(b, s, h, kh, d, causal, window):
    """The gradients, relative to the largest reference gradient, as
    chip_smoke.py holds the backward kernel (BWD_TOL)."""
    q, k, v, g = _inputs(b, s, h, kh, d, seed=b * 100 + s + d + 1)
    got = emulate_tc_backward(q, k, v, g, causal, window)
    jq, jk, jv, jg = (jnp.asarray(_np(x)) for x in (q, k, v, g))

    def loss(q, k, v):
        return jnp.sum(jax_ref.flash_attention_ref(q, k, v, causal=causal, window=window) * jg)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    worst = max(np.abs(_np(a) - np.asarray(w)).max() for a, w in zip(got, want))
    largest = max(np.abs(np.asarray(w)).max() for w in want)
    assert worst / largest <= BF16_TOL, (worst, largest)
