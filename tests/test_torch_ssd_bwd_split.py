"""The numerics of the SSD backward kernel on the tensor cores
(``repro_torch/kernels/csrc/ssd_scan_bwd.cu``), emulated in torch on the CPU
and held against the plain backward (``ref.ssd_intra_chunk_bwd_ref``) and,
through the chunked scan's glue, against ``jax.vjp`` of the JAX package's
``ssd_scan_ref``.

The kernel runs its products (C.B^T, G = dy.x^T, B.dS^T, M^T.dy, x.dS,
D^T.C, D.B) as TF32 ``mma.sync`` with f32 accumulators, each f32 operand
split in two as the forward kernel splits it (``tests/test_torch_ssd_split.py``):
``hi`` rounded to TF32 to nearest, ties away from zero, ``lo`` the rest
read as TF32; a product is ``lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b)``. A
bf16 ``x`` splits into itself and zero, so G and x.dS take two products.
The emulation forms each product as f32 matrix products of the split
operands (TF32 products are exact in f32) and follows the kernel's order
of f32 operations elsewhere: L = exp(cum_t - cum_s) masked before the exp,
Q = CB.(L.G), D = (L.G).dt_s, M = (CB.L).dt_s, dx = M^T.dy + w.dSB, the row
and column sums of Q, ddt and dcum; dB = sum_h w.(x.dS) + (sum_h D)^T.C and
dC = (sum_h D).B, D summed over the heads before its two products.

Run as a script, the file prints each gradient's error against the plain
backward in units of its tolerance, for three TF32 products and for one,
at the kernel's tiles and at a chunk span of 150 (for ``PERF.md``).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_k

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

CSRC = Path(ssd_k.__file__).resolve().parent / "csrc"
# chip_smoke.py's SSD_BWD_TOL: the kernel's f32 outputs against the plain
# backward, relative to the largest |plain| value; a bf16 dx one bf16 step
# more (_bf16_units)
SSD_BWD_TOL = 2e-5
# tests/test_torch_ssd_bwd.py's bounds: the glue against the JAX package in
# f32 (scan outputs, gradients)
SSD_TOL = 1e-5
GRAD_TOL = 2e-5
# the training shape (4, 1024, 80, 64, 128, 64) at reduced b, s and h: its
# per-chunk tiles (chunk 64, head dim 64, state 128)
SHAPES = [(1, 128, 3, 64, 128, 64), (2, 64, 2, 64, 128, 64)]
SPAN = 150.0  # a chunk's mean |sum dt*A|: exp(cum_t - cum_s) above the diagonal overflows f32
NAMES = ("dx", "ddt", "dcum", "dB", "dC")


def rna_tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to TF32 to nearest, ties away from zero (the kernel's
    ``split``: half a unit of the 10th mantissa bit added, 13 bits dropped)."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(a: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register given as TF32."""
    return (a.view(torch.int32) & -0x2000).view(torch.float32)


def split(a: torch.Tensor, exact: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo); an operand exact in TF32 (a bf16 x) is itself and zero."""
    if exact:
        return a, torch.zeros_like(a)
    hi = rna_tf32(a)
    return hi, trunc_tf32(a - hi)


def tc(a: torch.Tensor, b: torch.Tensor, a_exact: bool = False, b_exact: bool = False,
       passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: 3xTF32 with f32 sums, the small
    terms first (a term whose lo is zero adds nothing), or one TF32 pass
    with ``passes=1``."""
    ah, al = split(a, a_exact)
    bh, bl = split(b, b_exact)
    if passes == 1:
        return rna_tf32(a) @ rna_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def emulated_bwd(x, dt, cum, B, C, dy, dS, chunk: int, passes: int = 3):
    """The kernel's (dx in x's dtype, ddt, dcum, dB, dC), emulated."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc, q = s // chunk, chunk
    exact_x = x.dtype == torch.bfloat16
    mm = lambda a, m, **kw: tc(a, m, passes=passes, **kw)  # noqa: E731
    xf = x.float().reshape(b, nc, q, h, p).transpose(2, 3)  # (b,nc,h,q,p)
    dyf = dy.reshape(b, nc, q, h, p).transpose(2, 3)
    dtc = dt.reshape(b, nc, q, h).transpose(2, 3)  # (b,nc,h,q)
    cumc = cum.reshape(b, nc, q, h).transpose(2, 3)
    Bc, Cc = B.reshape(b, nc, 1, q, n), C.reshape(b, nc, 1, q, n)
    CB = mm(Cc, Bc.transpose(-1, -2))  # (b,nc,1,t,s), once per chunk
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    diff = cumc[..., :, None] - cumc[..., None, :]
    L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)  # the mask before the exp
    d = dtc[..., None, :]  # dt_s
    G = mm(dyf, xf.transpose(-1, -2), b_exact=exact_x)
    lg = L * G
    Q = CB * lg
    D = lg * d
    M = CB * L * d
    E = torch.exp(cumc[..., -1:] - cumc)
    w = E * dtc
    sb = mm(Bc, dS.transpose(-1, -2))  # dS B_s: (b,nc,h,q,p)
    dx = mm(M.transpose(-1, -2), dyf) + w[..., None] * sb
    R = (xf * sb).sum(-1)
    # D enters dB and dC only through its sum over the heads
    Dsum = D.sum(2, keepdim=True)
    dB = (mm(xf, dS, a_exact=exact_x) * w[..., None]).sum(2) + mm(Dsum.transpose(-1, -2), Cc)[:, :, 0]
    dC = mm(Dsum, Bc)[:, :, 0]
    colq = Q.sum(-2)
    wR = w * R
    ddt = E * R + colq
    dcum = (Q * d).sum(-1) - dtc * colq - wR
    dcum[..., -1] += wR.sum(-1)
    back = lambda t: t.transpose(2, 3).reshape(b, s, h, *t.shape[4:])  # noqa: E731
    return (back(dx).to(x.dtype), back(ddt), back(dcum), dB.reshape(b, s, n), dC.reshape(b, s, n))


class EmulatedIntraChunk(torch.autograd.Function):
    """The plain forward with the emulated kernel backward: what
    ``ssd_scan.SSDIntraChunk`` computes, on the CPU."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C, chunk: int):
        ctx.save_for_backward(x, dt, cum, B, C)
        ctx.chunk = chunk
        return ref.ssd_intra_chunk_ref(x, dt, cum, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dS):
        x, dt, cum, B, C = ctx.saved_tensors
        return (*emulated_bwd(x, dt, cum, B, C, dy.contiguous(), dS.contiguous(), ctx.chunk), None)


def _inputs(b, s, h, p, n, chunk, seed=0, span=None):
    """x, dt, A, B, C, the within-chunk cumsum of dt*A, dy, dS as numpy; A
    scaled so that a chunk's mean span |sum dt*A| is ``span`` when given."""
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


def _bf16_units(got: torch.Tensor, want: torch.Tensor) -> float:
    """chip_smoke.py's bound for a bf16 dx: max |got - want| over one bf16
    step at want's magnitude plus SSD_BWD_TOL of max |want|."""
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0**-126))) - 7)
    return float(((got.float() - w).abs() / (step + SSD_BWD_TOL * w.abs().max())).max())


def errors(shape, dtype: str, span, passes: int = 3) -> dict:
    """Each gradient's error against the plain backward in units of its
    tolerance: max |error| / max |plain| over SSD_BWD_TOL, a bf16 dx in
    ``_bf16_units``."""
    chunk = shape[-1]
    x, dt, _, B, C, cum, dy, dS = _t(*_inputs(*shape, seed=sum(shape), span=span))
    x = x.to(getattr(torch, dtype))
    got = emulated_bwd(x, dt, cum, B, C, dy, dS, chunk, passes)
    want = ref.ssd_intra_chunk_bwd_ref(x, dt, cum, B, C, dy, dS, chunk)
    out = {}
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        if g.dtype == torch.bfloat16:
            out[name] = _bf16_units(g, w)
        else:
            out[name] = float((g - w).abs().max() / w.abs().max()) / SSD_BWD_TOL
    return out


@pytest.mark.parametrize("span", [None, SPAN])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_three_tf32_passes_equal_the_plain_backward(shape, dtype, span):
    """Every gradient within chip_smoke.py's SSD_BWD_TOL of the plain
    backward (a bf16 dx one bf16 step more), at spans as drawn and past
    exp's overflow: what the card's phase_ssd_bwd_cases holds the kernel to."""
    errs = errors(shape, dtype, span)
    assert max(errs.values()) <= 1.0, errs


def test_one_tf32_pass_does_not_hold():
    """The bound tells the split from a single TF32 pass (~3 decimal digits),
    so the tests above see the split's accuracy."""
    errs = errors(SHAPES[0], "float32", None, passes=1)
    assert max(errs.values()) > 10.0, errs


GLUE_CASES = [  # (b, s, h, p, n, chunk, with init_state): the kernel's tiles
    (1, 128, 3, 64, 128, 64, False),
    (2, 100, 2, 64, 128, 64, True),  # ragged: one chunk of 64 and 36 steps padded with dt = 0
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
def test_glue_with_the_emulated_backward_equals_jax_vjp(b, s, h, p, n, chunk, init):
    """y, the final state and the gradients of x, dt, A, B, C and the
    initial state through ``ops.ssd_scan_chunked`` with the emulated
    backward in the kernel's place, against ``jax.vjp`` of the JAX scan
    (spans as drawn, where the JAX gradient is finite), within
    tests/test_torch_ssd_bwd.py's bounds."""
    rng = np.random.default_rng(s + h)
    x, dt, A, B, C, _, _, _ = _inputs(b, s + (-s) % chunk, h, p, n, chunk, seed=s)
    x, dt, B, C = (a[:, :s] for a in (x, dt, B, C))
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else np.zeros((b, h, p, n), np.float32)
    gy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    gf = rng.normal(size=(b, h, p, n)).astype(np.float32)
    (wy, wf), vjp = jax.vjp(lambda *a: _jax_scan(*a, chunk), *map(jnp.asarray, (x, dt, A, B, C, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gf)))
    ins = [t.requires_grad_(True) for t in _t(x, dt, A, B, C, h0)]
    y, final = ops.ssd_scan_chunked(*ins[:5], chunk, ins[5] if init else None, EmulatedIntraChunk.apply)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy), atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(wf), atol=SSD_TOL, rtol=SSD_TOL)
    got = torch.autograd.grad((y, final), ins if init else ins[:5], _t(gy, gf))
    for name, g, w in zip(("x", "dt", "A", "B", "C", "init_state"), got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0, err_msg=name)


def _function_body(src: str, name: str) -> str:
    """The text of ``name``'s definition in a CUDA source, signature to the
    closing brace at the start of a line."""
    m = re.search(rf"^__device__ __forceinline__ void {name}\(.*?^}}", src, re.S | re.M)
    assert m, name
    return m.group(0)


def test_the_backward_source_runs_the_emulated_arithmetic():
    """The backward's products are TF32 mma.sync with f32 accumulators, and
    its split is the forward's, character for character."""
    bwd = (CSRC / "ssd_scan_bwd.cu").read_text()
    fwd = (CSRC / "ssd_scan.cu").read_text()
    assert re.search(r"mma\.sync\.aligned\.m16n8k8\.row\.col\.f32\.tf32\.tf32\.f32", bwd)
    assert _function_body(bwd, "split") == _function_body(fwd, "split")
    assert "constexpr int kPad = 4;" in bwd  # rows 4 words past a multiple of 32, as the forward's


if __name__ == "__main__":
    for shape in SHAPES:
        for dtype in ("float32", "bfloat16"):
            for span in (None, SPAN):
                for passes in (3, 1):
                    errs = errors(shape, dtype, span, passes)
                    print(shape, dtype, f"span {span}", f"{passes} TF32 pass(es):",
                          ", ".join(f"{k} {v:.3f}" for k, v in errs.items()), "of the tolerance")
