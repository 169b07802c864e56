"""The numerics of the SSD intra-chunk kernel on the tensor cores
(``repro_torch/kernels/csrc/ssd_scan.cu``), emulated in torch on the CPU and
held against the JAX package's ``ssd_intra_chunk_pallas`` in interpret mode
within the port's SSD tolerance (``tests/test_torch_ssm.py``'s 1e-5).

The kernel runs its three products (C.B^T, y = M.x, S = x^T.(w o B)) as
TF32 ``mma.sync`` with f32 accumulators, each f32 operand split in two:
``hi`` = the operand rounded to TF32 (10 mantissa bits) to nearest, ties
away from zero, and ``lo`` = the rest, which the tensor core reads as TF32
by dropping its 13 low bits; a product is ``lo(a).hi(b) + hi(a).lo(b) +
hi(a).hi(b)``. TF32 products are exact in f32, so the emulation forms the
three products as f32 matrix products of the split operands. A bf16 ``x``
splits into itself and zero. The emulation follows the kernel's order of
f32 operations elsewhere: M = C.B^T * exp(cum_t - cum_s) * dt_s, masked
before the exp, and w o B with w = exp(cum_last - cum) * dt.

Run as a script, the file prints the error of one TF32 pass (the hi parts
alone) at the same shapes, for ``PERF.md``; the tests do not assert on it.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_intra_chunk_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_k

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

SOURCE = Path(ssd_k.__file__).resolve().parent / "csrc" / "ssd_scan.cu"
# tests/test_torch_ssm.py's bound for the SSD block (f32 sums in another
# order over a chunk of up to 64 steps)
SSD_TOL = 1e-5
# the serving shape (8, 512, 80, 64, 128, 64) at reduced b, s and h: its
# per-chunk tiles (chunk 64, head dim 64, state 128)
SHAPES = [(1, 128, 3, 64, 128, 64), (2, 64, 2, 64, 128, 64)]


def rna_tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to TF32 to nearest, ties away from zero: half a unit of
    the 10th mantissa bit added to the magnitude, the 13 bits below dropped."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(a: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register given as TF32."""
    return (a.view(torch.int32) & -0x2000).view(torch.float32)


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(a)
    return hi, trunc_tf32(a - hi)


def tc_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernel forms it on the tensor cores: 3xTF32 (or one
    TF32 pass with ``passes=1``), f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def emulated_intra_chunk(x, dt, cum, B, C, chunk: int, passes: int = 3):
    """The kernel's y (b,s,h,p) and S (b,nc,h,p,n), emulated."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc, q = s // chunk, chunk
    xf = x.float().reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)  # (b,nc,h,q,p)
    cumc = cum.reshape(b, nc, q, h).permute(0, 1, 3, 2)  # (b,nc,h,q)
    dtc = dt.reshape(b, nc, q, h).permute(0, 1, 3, 2)
    Bc, Cc = B.reshape(b, nc, q, n), C.reshape(b, nc, q, n)
    CB = tc_matmul(Cc, Bc.transpose(-1, -2), passes)  # (b,nc,q,q), once per chunk
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    diff = cumc[..., :, None] - cumc[..., None, :]  # (b,nc,h,t,s)
    L = torch.exp(torch.where(tri, diff, 0.0))
    M = torch.where(tri, CB[:, :, None] * L * dtc[..., None, :], 0.0)
    y = tc_matmul(M, xf, passes)  # (b,nc,h,q,p)
    w = torch.exp(cumc[..., -1:] - cumc) * dtc  # (b,nc,h,q)
    wB = w[..., None] * Bc[:, :, None]  # (b,nc,h,q,n)
    S = tc_matmul(xf.transpose(-1, -2), wB, passes)  # (b,nc,h,p,n)
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p), S


def _inputs(b, s, h, p, n, chunk, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    a = torch.from_numpy(dt).reshape(b, s // chunk, chunk, h) * torch.from_numpy(A)
    cum = torch.cumsum(a, dim=2).reshape(b, s, h).numpy()
    return x, dt, cum, B, C


def _both(shape, dtype, seed, passes=3):
    """(emulated y, S), (JAX y, S) on the same inputs."""
    b, s, h, p, n, chunk = shape
    x, dt, cum, B, C = _inputs(*shape, seed)
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    want = ssd_intra_chunk_pallas(jx, jnp.asarray(dt), jnp.asarray(cum), jnp.asarray(B), jnp.asarray(C), chunk,
                                  interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = emulated_intra_chunk(tx, *(torch.from_numpy(a) for a in (dt, cum, B, C)), chunk, passes)
    return got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_three_tf32_passes_equal_the_jax_kernel(shape, dtype):
    (y, S), (wy, wS) = _both(shape, dtype, seed=sum(shape))
    assert y.dtype == S.dtype == torch.float32 and tuple(S.shape) == wS.shape
    np.testing.assert_allclose(y.numpy(), wy, atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(S.numpy(), wS, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_tf32_passes_equal_the_plain_version(dtype):
    """The same emulation against the port's plain block (f32 on the CPU)."""
    shape = SHAPES[0]
    x, dt, cum, B, C = (torch.from_numpy(a) for a in _inputs(*shape, seed=5))
    x = x.to(getattr(torch, dtype))
    y, S = emulated_intra_chunk(x, dt, cum, B, C, shape[-1])
    wy, wS = ref.ssd_intra_chunk_ref(x, dt, cum, B, C, shape[-1])
    torch.testing.assert_close(y, wy, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(S, wS, atol=SSD_TOL, rtol=SSD_TOL)


def test_the_split():
    """hi is a to nearest TF32 (at most half a unit of its last place away,
    13 low bits zero), ties away from zero; hi + lo is a to ~2^-21; a bf16
    value splits into itself and zero."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-20, 20, 4096)).astype(np.float32))
    hi, lo = split(a)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    exp = torch.floor(torch.log2(a.abs().double()))
    assert ((a.double() - hi.double()).abs() <= 2.0 ** (exp - 11)).all()
    assert ((a.double() - hi.double() - lo.double()).abs() <= 2.0 ** -21 * a.abs().double()).all()
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11])  # half-way cases
    assert rna_tf32(tie).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0 + 2 * 2.0**-10]
    b16 = a.to(torch.bfloat16).float()
    bh, bl = split(b16)
    assert torch.equal(bh, b16) and (bl == 0).all()


def test_the_kernel_source_runs_the_emulated_arithmetic():
    """The source's products are TF32 mma.sync with f32 accumulators, the
    arithmetic the emulation above holds against the JAX kernel."""
    assert re.search(r"mma\.sync\.aligned\.m16n8k8\.row\.col\.f32\.tf32\.tf32\.f32", SOURCE.read_text())


def one_pass_tf32_error() -> dict:
    """max |error| / max |JAX| over y and S of one TF32 pass at each shape
    and x dtype (for PERF.md; not asserted)."""
    out = {}
    for shape in SHAPES:
        for dtype in ("float32", "bfloat16"):
            (y, S), (wy, wS) = _both(shape, dtype, seed=sum(shape), passes=1)
            out[(shape, dtype)] = max(np.abs(y.numpy() - wy).max() / np.abs(wy).max(),
                                      np.abs(S.numpy() - wS).max() / np.abs(wS).max())
    return out


if __name__ == "__main__":
    for key, err in one_pass_tf32_error().items():
        print(key, f"one TF32 pass: max |error| / max |JAX| {err:.3e}")
