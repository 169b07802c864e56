"""The SSD intra-chunk backward on the CPU: the plain backward the card's
kernel (``csrc/ssd_scan_bwd.cu``) is held against, and its wiring.

- ``ref.ssd_intra_chunk_bwd_ref`` (the gradient written out, the mask
  before every exponent) against autograd of ``ref.ssd_intra_chunk_ref``,
  and against the same in float64, over ``tests/test_kernels.py``'s SSD
  shapes and reduced mamba2's chunk and state, x in f32 and bf16;
- ``ops.ssd_scan_chunked`` around ``ref.SSDIntraChunkRef`` (the card's glue
  with the plain forward and backward in the kernels' place) against
  ``jax.vjp`` of the JAX package's ``ssd_scan_ref``, a ragged sequence and
  an initial state included;
- the repaired mask: the forward's bits unchanged, gradients finite past a
  chunk span of 88, where the JAX reference's are NaN;
- the backward wrapper's checks on CPU and meta tensors, its CUDA
  source's limits, the train world's kernel warm list;
- reduced mamba2's ``loss_fn`` gradients through the glue around
  ``SSDIntraChunkRef`` against ``jax.value_and_grad``.

Inputs come from numpy seeds. The CUDA kernel runs only on the card
(``chip_smoke.py`` phases 24-27)."""

from __future__ import annotations

import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro.models import model as JM
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch.configs import get_config
from repro_torch.core import shadow
from repro_torch.distribution.step import make_grad_fn
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import ssd_scan as ssd_k
from repro_torch.models.convert import params_from_jax
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

# The written-out backward against autograd of the plain forward, both f32
# on the CPU: sums in another order. Measured within 4e-7 of the largest
# |gradient| on these shapes; the JAX kernel test's SSD bound leaves a
# margin of 25.
BWD_TOL = 1e-5
# The plain f32 backward against the same in f64, relative to the largest
# |gradient|: 5.1e-7 at most on these shapes and at spans past 88 when it
# was set (chip_smoke.py's SSD_BWD_TOL reads a margin of ~40 from it).
F64_TOL = 1e-6
# tests/test_torch_ssm.py's bounds: the port against the JAX package in
# f32 (scan outputs and model gradients), and the loss
SSD_TOL = 1e-5
GRAD_TOL = 2e-5
LOSS_TOL = 2e-6

SHAPES = [  # (b, s, h, p, n, chunk): tests/test_kernels.py's, then reduced mamba2's
    (1, 64, 2, 16, 32, 16),
    (2, 128, 3, 32, 64, 32),
    (1, 96, 4, 64, 128, 16),
    (2, 40, 2, 64, 16, 8),
]
NAMES = ("dx", "ddt", "dcum", "dB", "dC")


def _inputs(b, s, h, p, n, chunk, seed=0, span=None):
    """x, dt, A, B, C, the within-chunk cumsum of dt*A, and the output
    gradients dy, dS, as numpy; A scaled so that a chunk's mean span
    |Σ dt·A| is ``span`` when one is given."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    if span is not None:
        per_chunk = -(dt.reshape(b, s // chunk, chunk, h) * A).sum(2).mean()
        A = (A * span / per_chunk).astype(np.float32)
    cum = np.cumsum(dt.reshape(b, s // chunk, chunk, h) * A, axis=2, dtype=np.float32).reshape(b, s, h)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dS = rng.normal(size=(b, s // chunk, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, cum, dy, dS


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_units(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over one bf16 step at want's magnitude plus BWD_TOL
    of max |want| (where a sum cancels to near 0, the f32 error exceeds the
    value's own step)."""
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0**-126))) - 7)
    return float(((got.float() - w).abs() / (step + BWD_TOL * w.abs().max())).max())


def _old_forward(x, dt, cum, B, C, chunk):
    """The block as the JAX reference writes it, the mask after the
    exponent (``repro/kernels/ref.py:96-97``)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc, q = s // chunk, chunk
    xf = x.float().reshape(b, nc, q, h, p)
    dtc, cumc = dt.reshape(b, nc, q, h), cum.reshape(b, nc, q, h)
    Bc, Cc = B.reshape(b, nc, q, n), C.reshape(b, nc, q, n)
    diff = cumc[:, :, :, None, :] - cumc[:, :, None, :, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bctsh,bcshp->bcthp", CB[..., None] * L * dtc[:, :, None, :, :], xf).reshape(b, s, h, p)
    S = torch.einsum("bcqh,bcqn,bcqhp->bchpn", torch.exp(cumc[:, :, -1:, :] - cumc) * dtc, Bc, xf)
    return y, S


# ---------------------------------------------------------------------------
# The written-out backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("span", [None, 150.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SHAPES)
def test_bwd_ref_equals_autograd_of_the_forward(case, dtype, span):
    """Every gradient against autograd of the plain forward on the same
    inputs (the forward masks before the exponent, so its autograd is
    finite at any span): f32 within BWD_TOL of the largest |gradient|, a
    bf16 dx within one bf16 step more (both round f32 sums that differ in
    their last bits)."""
    b, s, h, p, n, chunk = case
    x, dt, _, B, C, cum, dy, dS = _t(*_inputs(*case, seed=s + h, span=span))
    x = x.to(getattr(torch, dtype))
    ins = [t.clone().requires_grad_(True) for t in (x, dt, cum, B, C)]
    y, S = ref.ssd_intra_chunk_ref(*ins, chunk)
    want = torch.autograd.grad((y, S), ins, (dy, dS))
    got = ref.ssd_intra_chunk_bwd_ref(x, dt, cum, B, C, dy, dS, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all() and torch.isfinite(w.float()).all(), name
        if g.dtype == torch.bfloat16:
            assert _bf16_units(g, w) <= 1.0, name
        else:
            assert _rel(g, w) <= BWD_TOL, name


def _bwd_f64(x, dt, cum, B, C, dy, dS, chunk):
    """``ssd_intra_chunk_bwd_ref`` with every ``.float()`` a ``.double()``."""
    src = inspect.getsource(ref.ssd_intra_chunk_bwd_ref).replace(".float()", ".double()")
    ns = dict(vars(ref))
    exec(src.replace("def ssd_intra_chunk_bwd_ref", "def bwd64"), ns)
    return ns["bwd64"](*(t.double() for t in (x, dt, cum, B, C, dy, dS)), chunk)


@pytest.mark.parametrize("span", [None, 150.0])
@pytest.mark.parametrize("case", SHAPES + [(1, 128, 8, 64, 128, 64)])
def test_bwd_ref_in_f32_is_near_its_f64(case, span):
    """The f32 rounding of the plain backward, against the same arithmetic
    in float64: what the card's tolerance (chip_smoke.py SSD_BWD_TOL) rests
    on, mamba2's chunk 64 included."""
    chunk = case[-1]
    x, dt, _, B, C, cum, dy, dS = _t(*_inputs(*case, seed=7, span=span))
    got = ref.ssd_intra_chunk_bwd_ref(x, dt, cum, B, C, dy, dS, chunk)
    want = _bwd_f64(x, dt, cum, B, C, dy, dS, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w.numpy()) <= F64_TOL, name


def test_the_mask_before_the_exponent_keeps_the_forward_and_the_gradient_finite():
    """Past a chunk span of 88, ``exp(cum_t - cum_s)`` above the diagonal
    overflows f32. The repaired block gives the same forward bits as the
    reference's formula and finite gradients; the formula's own autograd
    gives NaN, and so does ``jax.grad`` of the JAX reference."""
    case = (1, 64, 2, 16, 32, 16)
    chunk = case[-1]
    xn, dtn, An, Bn, Cn, cumn, dyn, dSn = _inputs(*case, seed=5, span=150.0)
    assert (-cumn.reshape(1, 4, chunk, 2)[:, :, -1]).max() > 88
    x, dt, cum, B, C, dy, dS = _t(xn, dtn, cumn, Bn, Cn, dyn, dSn)
    for a, b in zip(ref.ssd_intra_chunk_ref(x, dt, cum, B, C, chunk), _old_forward(x, dt, cum, B, C, chunk)):
        assert torch.equal(a, b)
    for forward in (ref.ssd_intra_chunk_ref, _old_forward):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, cum, B, C)]
        grads = torch.autograd.grad(forward(*ins, chunk), ins, (dy, dS))
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        assert finite == (forward is ref.ssd_intra_chunk_ref), forward.__name__
    assert all(bool(torch.isfinite(g).all()) for g in ref.ssd_intra_chunk_bwd_ref(x, dt, cum, B, C, dy, dS, chunk))
    jgrad = jax.grad(lambda a: jax_ref.ssd_scan_ref(*map(jnp.asarray, (xn, dtn)), a, *map(jnp.asarray, (Bn, Cn)),
                                                    chunk)[0].sum())(jnp.asarray(An))
    assert not np.isfinite(np.asarray(jgrad)).all()


# ---------------------------------------------------------------------------
# The glue around SSDIntraChunkRef against jax.vjp of the JAX scan
# ---------------------------------------------------------------------------

GLUE_CASES = [  # (b, s, h, p, n, chunk, with init_state)
    (1, 64, 2, 16, 32, 16, False),
    (2, 100, 3, 32, 64, 32, True),  # ragged: 3 chunks of 32 + 4
    (1, 90, 4, 64, 128, 16, True),  # ragged, mamba2's head dim and state
    (2, 40, 2, 64, 16, 8, True),  # reduced mamba2's chunk and state
]


def _jax_scan(x, dt, A, B, C, h0, chunk):
    """The JAX reference's scan, padded with dt = 0 to a chunk multiple and
    cropped (what the JAX ``ops.ssd_scan`` does around it)."""
    s = x.shape[1]
    pad = (-s) % chunk
    widths = lambda t: [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2)  # noqa: E731
    y, final = jax_ref.ssd_scan_ref(*(jnp.pad(t, widths(t)) for t in (x, dt)), A,
                                    *(jnp.pad(t, widths(t)) for t in (B, C)), chunk, h0)
    return y[:, :s], final


@pytest.mark.parametrize("b,s,h,p,n,chunk,init", GLUE_CASES)
def test_glue_with_the_plain_backward_equals_jax_vjp(b, s, h, p, n, chunk, init):
    """y, the final state and the gradients of x, dt, A, B, C and the
    initial state: the card's glue with ``SSDIntraChunkRef`` in the kernels'
    place against ``jax.vjp`` of the JAX scan (f32, within the bounds of
    tests/test_torch_ssm.py)."""
    rng = np.random.default_rng(s + h)
    x, dt, A, B, C, _, _, _ = _inputs(b, s + (-s) % chunk, h, p, n, chunk, seed=s)
    x, dt, B, C = (a[:, :s] for a in (x, dt, B, C))
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else np.zeros((b, h, p, n), np.float32)
    gy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    gf = rng.normal(size=(b, h, p, n)).astype(np.float32)
    (wy, wf), vjp = jax.vjp(lambda *a: _jax_scan(*a, chunk), *map(jnp.asarray, (x, dt, A, B, C, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gf)))
    ins = [t.requires_grad_(True) for t in _t(x, dt, A, B, C, h0)]
    y, final = ops.ssd_scan_chunked(*ins[:5], chunk, ins[5] if init else None, ref.SSDIntraChunkRef.apply)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy), atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(wf), atol=SSD_TOL, rtol=SSD_TOL)
    got = torch.autograd.grad((y, final), ins if init else ins[:5], _t(gy, gf))
    for name, g, w in zip(("x", "dt", "A", "B", "C", "init_state"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# The wrapper's checks, the CUDA source, the warm list
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(device):
    """Each bad argument is refused before any launch, on CPU and meta
    tensors alike; good shapes off the card are refused for their device."""
    x, dt, _, B, C, cum, dy, dS = (t.to(device) for t in _t(*_inputs(2, 64, 2, 64, 128, 16)))
    bwd = ssd_k.ssd_intra_chunk_bwd_cuda
    before = ssd_k.bwd_launches
    cases = {
        "dy: want": lambda: bwd(x, dt, cum, B, C, dy[:, :32], dS, 16),
        "dS: want float32": lambda: bwd(x, dt, cum, B, C, dy, dS.bfloat16(), 16),
        "dy must be contiguous": lambda: bwd(x, dt, cum, B, C, dy.transpose(1, 2).contiguous().transpose(1, 2), dS, 16),
        "dS: want": lambda: bwd(x, dt, cum, B, C, dy, dS[:, :2], 16),
        "x: want": lambda: bwd(x.half(), dt, cum, B, C, dy, dS, 16),
        "chunk 128": lambda: bwd(x, dt, cum, B, C, dy, dS, 128),
        "not a multiple": lambda: bwd(*(t[:, :60] for t in (x, dt, cum, B, C, dy)), dS, 16),
        "needs CUDA tensors": lambda: bwd(x, dt, cum, B, C, dy, dS, 16),
    }
    for match, call in cases.items():
        with pytest.raises(ValueError, match=match):
            call()
    assert ssd_k.bwd_launches == before


def test_ssd_autograd_node_refuses_cpu_tensors_at_the_backward():
    """The card's node runs its kernels or raises: a CPU tensor reaches the
    backward's check (the CPU path is ``ops``' plain scan, never this node)."""
    ctx = type("Ctx", (), {})()
    x, dt, _, B, C, cum, dy, dS = _t(*_inputs(1, 64, 2, 16, 32, 16))
    ctx.saved_tensors, ctx.chunk = (x, dt, cum, B, C), 16
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd_k.SSDIntraChunk.backward(ctx, dy, dS)


def test_bwd_source_limits_equal_the_wrappers():
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    limits = {k: int(v) for k, v in re.findall(r"constexpr int (kQ|kP|kN) = (\d+);", src)}
    assert limits == {"kQ": ssd_k.MAX_CHUNK, "kP": ssd_k.MAX_HEAD_DIM, "kN": ssd_k.MAX_STATE}
    assert "atomic" not in src.replace("no atomics", "")  # deterministic: no floating-point atomics
    assert build.library_path("ssd_scan_bwd").name.startswith("libssd_scan_bwd_")


def test_train_world_warms_the_ssd_libraries_for_an_ssm_model(monkeypatch):
    """A cold Prepare of a mamba2 train world on the card loads the SSD
    forward and backward libraries with the rest; a qwen3 one does not."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.optim import AdamWConfig

    warmed = []
    monkeypatch.setattr(shadow, "warm_device", lambda device, dtype, kernels: warmed.append(tuple(kernels)))
    for arch in ("mamba2-2.7b", "qwen3-1.7b"):
        shadow.build_train_world(get_config(arch), ParallelConfig(dp=2, tp=2), AdamWConfig(), 4, 64,
                                 devices=["cuda"] * 4)
    assert {"ssd_scan", "ssd_scan_bwd"} <= set(warmed[0]) and set(shadow._TRAIN_KERNELS) <= set(warmed[0])
    assert warmed[1] == shadow._TRAIN_KERNELS


# ---------------------------------------------------------------------------
# Reduced mamba2's loss and grads through the plain backward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced_mamba():
    jcfg = dataclasses.replace(jax_get_config("mamba2-2.7b").reduced(), d_ff=0)
    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(), d_ff=0)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    return jcfg, cfg, jparams, params_from_jax(flat, cfg, "cpu")


def test_loss_and_grads_through_the_plain_backward_equal_jax(reduced_mamba, monkeypatch):
    """``loss_fn``'s value and grads with the CPU scan replaced by the
    card's glue around ``SSDIntraChunkRef`` (the plain forward and the
    written-out backward) against ``jax.value_and_grad``; ``d_ff = 0`` as at
    full width, a ragged-free 32 tokens of chunk 8."""
    jcfg, cfg, jparams, params = reduced_mamba
    calls = []

    def scan(x, dt, A, B, C, chunk, init_state):
        calls.append(chunk)
        return ops.ssd_scan_chunked(x, dt, A, B, C, chunk, init_state, ref.SSDIntraChunkRef.apply)

    monkeypatch.setattr(ops, "_ssd_scan_cpu", scan)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}), has_aux=True))(jparams)
    loss, _, grads = make_grad_fn(cfg)(params, {"tokens": torch.from_numpy(tokens).long()})
    assert len(calls) >= cfg.num_layers  # every layer's scan went through the glue
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    want = jax_tree_paths(jgrads)
    assert sorted(tree_paths(grads)) == sorted(want)
    for path, g in tree_paths(grads).items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0, err_msg=path)
