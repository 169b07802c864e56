"""The SSM slice's kernels and model against the JAX package: the plain
SSD intra-chunk block and RMSNorm against the Pallas kernels in interpret
mode (over ``tests/test_kernels.py``'s shapes), the port's chunked-scan
glue (the code the card runs around its kernel, here with the plain block
standing in for it) against the JAX ``ops.ssd_scan`` and the per-token
recurrence, ``models/ssm.py`` against ``repro.models.ssm``, and reduced
mamba2-2.7b (with its dense MLP, and with ``d_ff = 0`` as at full width)
against ``repro.models.model``: layout, counts, prefill, the SSD/conv
cache, greedy decode, ``loss_fn`` and its grads. The CUDA kernels run only
on the card (``chip_smoke.py``); here the tests cover their wrappers'
checks, which run before any launch. Inputs come from numpy seeds."""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.kernels.ssd_scan import ssd_intra_chunk_pallas
from repro.models import model as JM
from repro.models import ssm as jax_ssm
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch.configs import get_config
from repro_torch.distribution.step import make_grad_fn
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import rmsnorm as rms_k
from repro_torch.kernels import ssd_scan as ssd_k
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

# the JAX kernel test's bound for the SSD block and scan (f32 sums in
# another order over a chunk of up to 64 steps)
SSD_TOL = 1e-5
# tests/test_kernels.py::test_ssd_matches_sequential_recurrence's bound
RECURRENCE_TOL = 1e-4
# tests/test_kernels.py::test_rmsnorm_property's bound (f32), made relative
# above 1: across frameworks the mean and rsqrt round in other places, a
# few f32 ulps, and at |y| ~ 10 one ulp is ~1e-6
RMS_TOL = 1e-6
# tests/test_torch_serve.py's bounds: f32 on both sides
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
# tests/test_torch_train_model.py's bounds
LOSS_TOL = 2e-6
GRAD_TOL = 2e-5

SSD_SHAPES = [  # (b, s, h, p, n, chunk): tests/test_kernels.py::test_ssd_intra_chunk_sweep
    (1, 64, 2, 16, 32, 16),
    (2, 128, 3, 32, 64, 32),
    (1, 96, 4, 64, 128, 16),
]
SSM_FP32 = ("A_log", "dt_bias", "D", "conv_w", "conv_b", "norm_scale")


def _ssd_inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _cum(dt, A, chunk):
    """The within-chunk inclusive cumsum of dt*A, as both ``ops`` form it."""
    b, s, h = dt.shape
    a = torch.from_numpy(dt).reshape(b, s // chunk, chunk, h) * torch.from_numpy(A)
    return torch.cumsum(a, dim=2).reshape(b, s, h).numpy()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# The SSD intra-chunk block and the scan around it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_intra_chunk_ref_equals_pallas_interpret(b, s, h, p, n, chunk, dtype):
    """y and S of the plain block against the TPU kernel in interpret
    mode; bf16 x is the same rounding of the same f32 draw on both sides."""
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, seed=s + h)
    cum = _cum(dt, A, chunk)
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    wy, wS = ssd_intra_chunk_pallas(jx, jnp.asarray(dt), jnp.asarray(cum), jnp.asarray(B), jnp.asarray(C), chunk,
                                    interpret=True)
    tx, tdt, tcum, tB, tC = _t(x, dt, cum, B, C)
    y, S = ref.ssd_intra_chunk_ref(tx.to(getattr(torch, dtype)), tdt, tcum, tB, tC, chunk)
    assert y.dtype == S.dtype == torch.float32
    assert tuple(S.shape) == (b, s // chunk, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(wS), atol=SSD_TOL, rtol=SSD_TOL)


GLUE_CASES = [  # (b, s, h, p, n, chunk, with init_state)
    (1, 64, 2, 16, 32, 16, False),
    (2, 100, 3, 32, 64, 32, True),  # ragged: 100 = 3 chunks of 32 + 4
    (1, 90, 4, 64, 128, 16, True),  # ragged, mamba2's head dim and state
    (2, 40, 2, 64, 16, 8, False),  # reduced mamba2's chunk and state
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,init", GLUE_CASES)
def test_ssd_scan_glue_equals_jax_ops(monkeypatch, b, s, h, p, n, chunk, init):
    """The card's glue (padding, cumsum, decay, inter-chunk recurrence,
    crop) with the plain block in the kernel's place, against the JAX
    ``ops.ssd_scan`` running its Pallas kernel in interpret mode; and the
    CPU's ``ops.ssd_scan`` (the plain scan whole) against the same."""
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, seed=s)
    h0 = np.random.default_rng(1).normal(size=(b, h, p, n)).astype(np.float32) if init else None
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    wy, wf = jax_ops.ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                              init_state=None if h0 is None else jnp.asarray(h0))
    th0 = None if h0 is None else torch.from_numpy(h0)
    for got_y, got_f in (
        ops.ssd_scan_chunked(*_t(x, dt, A, B, C), chunk, th0, ref.ssd_intra_chunk_ref),
        ops.ssd_scan(*_t(x, dt, A, B, C), chunk, init_state=th0),
    ):
        assert tuple(got_y.shape) == (b, s, h, p) and tuple(got_f.shape) == (b, h, p, n)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(wy), atol=SSD_TOL, rtol=SSD_TOL)
        np.testing.assert_allclose(got_f.numpy(), np.asarray(wf), atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("path", ["glue", "ops"])
def test_ssd_scan_matches_sequential_recurrence(path):
    """The chunked scan equals the per-token recurrence (ground truth), at
    ``test_ssd_matches_sequential_recurrence``'s shapes and bound."""
    b, s, h, p, n, chunk = 1, 32, 2, 8, 16, 8
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, seed=7)
    state = np.zeros((b, h, p, n), np.float32)
    ys = np.zeros((b, s, h, p), np.float32)
    for t in range(s):
        decay = np.exp(dt[:, t] * A[None, :])
        state = decay[:, :, None, None] * state + (
            dt[:, t][:, :, None, None] * x[:, t][:, :, :, None] * B[:, t][:, None, None, :]
        )
        ys[:, t] = np.einsum("bhpn,bn->bhp", state, C[:, t])
    if path == "glue":
        y, final = ops.ssd_scan_chunked(*_t(x, dt, A, B, C), chunk, None, ref.ssd_intra_chunk_ref)
    else:
        y, final = ops.ssd_scan(*_t(x, dt, A, B, C), chunk)
    np.testing.assert_allclose(y.numpy(), ys, atol=RECURRENCE_TOL, rtol=RECURRENCE_TOL)
    np.testing.assert_allclose(final.numpy(), state, atol=RECURRENCE_TOL, rtol=RECURRENCE_TOL)


def test_ssd_scan_ref_equals_jax_ref():
    x, dt, A, B, C = _ssd_inputs(2, 64, 3, 16, 32, seed=3)
    h0 = np.random.default_rng(4).normal(size=(2, 3, 16, 32)).astype(np.float32)
    wy, wf = jax_ref.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, B, C)), 16, jnp.asarray(h0))
    y, f = ref.ssd_scan_ref(*_t(x, dt, A, B, C), 16, torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(wf), atol=SSD_TOL, rtol=SSD_TOL)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_compute():
    x, dt, A, B, C = _t(*_ssd_inputs(1, 64, 2, 64, 128))
    cum = dt.clone()
    with pytest.raises(ValueError, match="CUDA"):
        ssd_k.ssd_intra_chunk_cuda(x, dt, cum, B, C, 16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_k.ssd_intra_chunk_cuda(x[:, :60], dt[:, :60], cum[:, :60], B[:, :60], C[:, :60], 16)
    with pytest.raises(ValueError, match="chunk 128"):
        ssd_k.ssd_intra_chunk_cuda(x, dt, cum, B, C, 128)
    with pytest.raises(ValueError, match="head dim"):
        ssd_k.ssd_intra_chunk_cuda(torch.zeros(1, 64, 1, 128), dt[..., :1].contiguous(), cum[..., :1].contiguous(),
                                   B, C, 16)
    with pytest.raises(ValueError, match="B: want float32"):
        ssd_k.ssd_intra_chunk_cuda(x, dt, cum, B.double(), C, 16)
    with pytest.raises(ValueError, match="x: want"):
        ssd_k.ssd_intra_chunk_cuda(x.half(), dt, cum, B, C, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_k.ssd_intra_chunk_cuda(torch.zeros(1, 64, 64, 2).transpose(2, 3), dt, cum, B, C, 16)
    with pytest.raises(ValueError, match="different devices"):
        ops.ssd_scan(x, dt, A.to("meta"), B, C, 16)


def test_ssd_backward_raises_naming_the_roadmap_item():
    """A raw-pointer kernel is not connected to autograd: the Function's
    backward refuses, so a gradient through the card's scan fails loudly."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        ssd_k.SSDIntraChunk.backward(None, torch.zeros(1), torch.zeros(1))


def test_new_sources_are_built_with_the_others():
    assert {"ssd_scan", "rmsnorm"} <= {p.stem for p in build.CSRC.glob("*.cu")}
    for name in ("ssd_scan", "rmsnorm"):
        assert build.library_path(name).name.startswith(f"lib{name}_")


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 step at each value's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(v.astype(np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256, 2560, 2561, 6400])
@pytest.mark.parametrize("rows", [1, 37, 300])
def test_rmsnorm_ref_equals_pallas_interpret(rows, d, dtype):
    """``test_rmsnorm_property``'s shapes (rows 1-300, d 128/256) and
    mamba2's d_model, which the kernel's register body takes, and an odd d
    and one above the register cap, which its two-read body takes: f32
    within 1e-6 (relative above 1), bf16 within one bf16 step (both round
    the same f32 value, which may lie on either side of a rounding
    boundary)."""
    rng = np.random.default_rng(rows * d)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    sc = rng.normal(size=(d,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(rmsnorm_pallas(jnp.asarray(x, jdt), jnp.asarray(sc, jdt), interpret=True), np.float32)
    tx, tsc = (t.to(getattr(torch, dtype)) for t in _t(x, sc))
    got = ops.rmsnorm(tx, tsc)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=RMS_TOL, rtol=RMS_TOL)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    np.testing.assert_array_equal(got, ref.rmsnorm_ref(tx, tsc).float().numpy())


def test_rmsnorm_ref_equals_jax_ref_on_leading_axes():
    x = np.random.default_rng(2).normal(size=(2, 3, 96)).astype(np.float32)
    sc = np.random.default_rng(3).normal(size=(96,)).astype(np.float32)
    want = np.asarray(jax_ref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(sc), 1e-5))
    np.testing.assert_allclose(ref.rmsnorm_ref(*_t(x, sc), 1e-5).numpy(), want, atol=RMS_TOL, rtol=RMS_TOL)


def test_rmsnorm_register_cap_matches_the_cuda_source():
    """The register body's cap is named once in the CUDA source and once in
    the wrapper, which checks the library's at load; the body the wrapper
    picks: the fewest 16-byte vectors a lane that hold an aligned row, up to
    the cap, else the two-read body (0)."""
    text = (build.CSRC / "rmsnorm.cu").read_text()
    cap = re.search(r"constexpr int kMaxVecs = (\d+);", text)
    assert cap and int(cap.group(1)) == rms_k.REG_VECS
    assert "repro_rmsnorm_max_vecs() { return kMaxVecs; }" in text
    assert rms_k.body(2560, 2, True) == 10 and rms_k.body(2560, 4, True) == 20
    assert rms_k.body(32 * 8 * rms_k.REG_VECS, 2, True) == rms_k.REG_VECS
    assert rms_k.body(32 * 8 * rms_k.REG_VECS + 8, 2, True) == 0  # above the cap
    assert rms_k.body(32 * 4 * rms_k.REG_VECS + 4, 4, True) == 0
    assert rms_k.body(2561, 2, True) == 0 and rms_k.body(2560, 2, False) == 0  # odd d, misaligned
    assert rms_k.body(8, 2, True) == 1


def test_rmsnorm_wrapper_refuses_what_the_kernel_does_not_compute():
    x, sc = torch.zeros(4, 16), torch.ones(16)
    with pytest.raises(ValueError, match="CUDA"):
        rms_k.rmsnorm_cuda(x, sc)
    with pytest.raises(ValueError, match="scale: want"):
        rms_k.rmsnorm_cuda(x, torch.ones(8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rms_k.rmsnorm_cuda(x.half(), sc)
    with pytest.raises(ValueError, match="contiguous"):
        rms_k.rmsnorm_cuda(torch.zeros(16, 4).T, sc)
    with pytest.raises(ValueError, match="d > 0"):
        rms_k.rmsnorm_cuda(torch.zeros(4, 0), torch.ones(0))


# ---------------------------------------------------------------------------
# models/ssm.py alone, on reduced mamba2's layer 0
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2-2.7b (dense MLP, d_ff 128) and its ``d_ff = 0``
    variant (full width's MLP-free blocks), each with the JAX package's
    seed-0 weights and the port's copy of them."""
    out = {}
    for variant in ("reduced", "d_ff0"):
        jcfg = jax_get_config("mamba2-2.7b").reduced()
        cfg = get_config("mamba2-2.7b").reduced()
        if variant == "d_ff0":
            jcfg, cfg = dataclasses.replace(jcfg, d_ff=0), dataclasses.replace(cfg, d_ff=0)
        jparams = jax.jit(lambda key, c=jcfg: JM.init_params(c, key))(jax.random.key(0))
        flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
        out[variant] = (jcfg, cfg, jparams, flat, params_from_jax(flat, cfg, "cpu"))
    return out


def _layer0(jparams, tparams):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["pos0"]["mixer"])
    tp = {k: v[0] for k, v in tparams["blocks"]["pos0"]["mixer"].items()}
    return jp, tp


@pytest.mark.parametrize("with_state", ["none", "return", "init_and_return"])
def test_ssm_forward_equals_jax(mamba, with_state):
    jcfg, cfg, jparams, _, tparams = mamba["reduced"]
    jp, tp = _layer0(jparams, tparams)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)  # 21: not a chunk multiple
    init = None
    if with_state == "init_and_return":
        _, h, n, conv_ch = ssm.ssm_dims(cfg)
        init = {"ssd": rng.normal(size=(2, h, ssm.SSM_HEAD_DIM, n)).astype(np.float32),
                "conv": rng.normal(size=(2, ssm.CONV_WIDTH - 1, conv_ch)).astype(np.float32)}
    ret = with_state != "none"
    want = jax.jit(lambda p, x, init: jax_ssm.ssm_forward(p, jcfg, x, return_state=ret, init_state=init))(
        jp, jnp.asarray(x), None if init is None else {k: jnp.asarray(v) for k, v in init.items()}
    )
    with torch.no_grad():
        got = ssm.ssm_forward(tp, cfg, torch.from_numpy(x), return_state=ret,
                              init_state=None if init is None else {k: torch.from_numpy(v) for k, v in init.items()})
    if not ret:
        want, got = (want, {}), (got, {})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=LOGIT_ATOL, rtol=0)
    assert sorted(got[1]) == sorted(want[1])
    for name in want[1]:
        assert got[1][name].dtype == torch.float32
        np.testing.assert_allclose(got[1][name].numpy(), np.asarray(want[1][name]), atol=CACHE_ATOL, rtol=0,
                                   err_msg=name)


def test_ssm_decode_equals_jax_over_four_steps(mamba):
    jcfg, cfg, jparams, _, tparams = mamba["reduced"]
    jp, tp = _layer0(jparams, tparams)
    rng = np.random.default_rng(12)
    jstate = jax_ssm.ssm_init_state(jcfg, 2)
    tstate = ssm.ssm_init_state(cfg, 2)
    assert {k: tuple(v.shape) for k, v in tstate.items()} == {k: v.shape for k, v in jstate.items()}
    jdecode = jax.jit(lambda p, x, st: jax_ssm.ssm_decode(p, jcfg, x, st))
    for step in range(4):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = jdecode(jp, jnp.asarray(x), jstate)
        with torch.no_grad():
            ty, tstate = ssm.ssm_decode(tp, cfg, torch.from_numpy(x), tstate)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=LOGIT_ATOL, rtol=0, err_msg=f"step {step}")
        for name in ("ssd", "conv"):
            np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]), atol=CACHE_ATOL, rtol=0,
                                       err_msg=f"{name} step {step}")


# ---------------------------------------------------------------------------
# The model: reduced mamba2, with its dense MLP and with d_ff = 0
# ---------------------------------------------------------------------------

VARIANTS = ["reduced", "d_ff0"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_layout_and_param_count_equal_jax(mamba, variant):
    jcfg, cfg, jparams, _, _ = mamba[variant]
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in jax_tree_paths(jparams).items()}
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {p: (tuple(x.shape), str(x.dtype).removeprefix("torch.")) for p, x in tree_paths(got).items()} == want
    assert cfg.param_count() == jcfg.param_count() == M.analytic_param_count(cfg)
    assert ("ln2" in got["blocks"]["pos0"]) == (variant == "reduced")


def test_full_width_param_count_and_shapes_equal_jax():
    cfg, jcfg = get_config("mamba2-2.7b"), jax_get_config("mamba2-2.7b")
    assert cfg.param_count() == jcfg.param_count() == 2_831_296_000
    want = {p: tuple(x.shape) for p, x in jax_tree_paths(JM.abstract_params(jcfg)).items()}
    assert M.param_shapes(cfg) == want


def test_init_draws_the_jax_distributions():
    cfg = get_config("mamba2-2.7b").reduced()
    mixer = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")["blocks"]["pos0"]["mixer"]
    A = torch.exp(mixer["A_log"])
    assert A.min() >= 1.0 and A.max() <= 16.0
    assert torch.allclose(torch.nn.functional.softplus(mixer["dt_bias"]), torch.full_like(mixer["dt_bias"], 0.01))
    assert torch.equal(mixer["D"], torch.ones_like(mixer["D"])) and not mixer["conv_b"].any()
    assert abs(mixer["conv_w"].std().item() - 0.5) < 0.05  # 1/sqrt(fan_in = CONV_WIDTH)


@pytest.mark.parametrize("prompt_len,force_pallas", [(20, False), (64, True)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_cache_and_greedy_decode_equal_jax(mamba, monkeypatch, variant, prompt_len, force_pallas):
    """Prefill logits, the ssd/conv cache and 8 greedy decode steps. At 20
    (not a multiple of chunk 8) the JAX side pads in its jnp reference; at
    64 it runs the Pallas SSD kernel in interpret mode."""
    if force_pallas:
        monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    jcfg, cfg, jparams, _, tparams = mamba[variant]
    horizon = prompt_len + 8
    toks = np.random.default_rng(prompt_len).integers(0, cfg.vocab_size, (2, prompt_len), dtype=np.int32)
    jprefill = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t}, jnp.float32, horizon))
    jdecode = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
    jlogits, jcache, _ = jprefill(jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tlogits, tcache, _ = M.prefill(cfg, tparams, {"tokens": torch.from_numpy(toks).long()}, torch.float32, horizon)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)

    def check_cache():
        jflat, tflat = jax_tree_paths(jcache), tree_paths(tcache)
        assert sorted(jflat) == sorted(tflat) == ["pos0/conv", "pos0/ssd"]
        for path, w in jflat.items():
            assert tflat[path].dtype == torch.float32 and tuple(tflat[path].shape) == w.shape
            np.testing.assert_allclose(tflat[path].numpy(), np.asarray(w), atol=CACHE_ATOL, rtol=0, err_msg=path)

    check_cache()
    jcur = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
    tcur = tlogits[:, -1].argmax(dim=-1, keepdim=True)
    for i in range(8):
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur), err_msg=f"step {i}")
        jlogits, jcache = jdecode(jparams, jcache, jcur, jnp.int32(prompt_len + i))
        with torch.inference_mode():
            tlogits, tcache = M.decode_step(cfg, tparams, tcache, tcur, prompt_len + i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0, err_msg=f"step {i}")
        jcur = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
        tcur = tlogits[:, -1].argmax(dim=-1, keepdim=True)
    check_cache()
    assert ssd_k.launches == 0  # the CPU path never reaches the kernel


@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_grads_equal_jax(mamba, variant):
    """The ssm leg of ``test_smoke_forward_and_train_step``: ``loss_fn``'s
    value and grads through the plain scan under autograd."""
    jcfg, cfg, jparams, flat, _ = mamba[variant]
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}), has_aux=True
    ))(jparams)
    params = params_from_jax(flat, cfg, "cpu")
    loss, metrics, grads = make_grad_fn(cfg, device="cpu")(params, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["nll"]), float(jaux["nll"]), rtol=LOSS_TOL)
    want = jax_tree_paths(jgrads)
    assert sorted(tree_paths(grads)) == sorted(want)
    for path, g in tree_paths(grads).items():
        w = np.asarray(want[path])
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0, err_msg=path)


def test_cast_params_keeps_the_ssm_fp32_leaves(mamba):
    """The JAX mixer reads these six leaves in fp32: a bf16 copy would
    change the decay ``exp(dt*A)``. Matrices go to bf16."""
    _, cfg, _, _, tparams = mamba["reduced"]
    cast = tree_paths(M.cast_params(tparams, "bfloat16"))
    for name in SSM_FP32:
        assert cast[f"blocks/pos0/mixer/{name}"].dtype == torch.float32, name
    for name in ("wz", "wx", "wB", "wC", "wdt", "wo"):
        assert cast[f"blocks/pos0/mixer/{name}"].dtype == torch.bfloat16, name
    assert cast["blocks/pos0/ln1/scale"].dtype == torch.float32


def test_bf16_prefill_reads_the_fp32_leaves_as_the_uncast_params_do(mamba):
    """Pre-casting once equals casting at every use, bit for bit."""
    _, cfg, _, _, tparams = mamba["d_ff0"]
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    toks = {"tokens": torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))).long()}
    with torch.inference_mode():
        a, ca, _ = M.prefill(cfg, tparams, toks)
        b, cb, _ = M.prefill(cfg, M.cast_params(tparams, "bfloat16"), toks)
        assert torch.equal(a, b)
        cur = a[:, -1].argmax(-1, keepdim=True)
        a2, _ = M.decode_step(cfg, tparams, ca, cur, 24)
        b2, _ = M.decode_step(cfg, M.cast_params(tparams, "bfloat16"), cb, cur, 24)
    assert torch.equal(a2, b2)


def test_training_on_the_card_is_refused_without_a_tensor():
    """An SSM model has no backward kernel on the card: the train world,
    the grad function and the launcher's check raise before any tensor is
    built, naming the ROADMAP item; the CPU and attention models pass."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.shadow import build_train_world
    from repro_torch.optim import AdamWConfig

    cfg = get_config("mamba2-2.7b")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        build_train_world(cfg, ParallelConfig(dp=1, tp=1), AdamWConfig(), 4, 64, devices=["cuda"])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        make_grad_fn(cfg, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        T.check_trainable(cfg, torch.device("cuda", 0))
    T.check_trainable(cfg, "cpu")
    T.check_trainable(get_config("qwen3-1.7b"), "cuda")
