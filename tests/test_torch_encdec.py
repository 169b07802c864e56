"""The enc-dec family (seamless-m4t-large-v2) on the port, held against the
JAX package on the CPU: cross attention and its KV, the encoder, the
forward, ``loss_fn`` and its gradients on the reduced config from the JAX
package's weights (``params_from_jax``); the parameter tree, its logical
axes, its count and the train batch at full width (meta device, nothing
allocated); and the encoder's non-causal attention against the JAX
package's Pallas flash kernel in interpret mode at 128 frames. Inputs are
made with numpy: frames of 8 and 16 positions, prompts of 16 and 32
tokens. TF32 is off."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.shadow import abstract_batch as jax_abstract_batch
from repro.kernels import ops as jax_ops
from repro.models import attention as JA
from repro.models import model as JM
from repro.utils.pytree import axes_paths as jax_axes_paths
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch.configs import get_config
from repro_torch.core.shadow import abstract_batch
from repro_torch.data import SyntheticFrames
from repro_torch.distribution.step import make_grad_fn
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.utils.pytree import axes_paths, tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
BATCH = 2
# (frames, prompt) lengths
SHAPES = [(8, 16), (16, 32)]
# f32 on both sides, other summation orders: the parity test's bounds
# (tests/test_torch_model_archs.py), and the forward's of test_torch_train_model.py
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
ACT_TOL = 1e-4


@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    return jcfg, cfg, jparams, params_from_jax(flat, cfg, "cpu")


def _inputs(cfg, frames: int, prompt: int, seed: int = 0):
    rng = np.random.default_rng(seed + frames + prompt)
    return (rng.normal(size=(BATCH, frames, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32))


def _close(got: torch.Tensor, want, tol=ACT_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# Cross attention, the encoder, the forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames,prompt", SHAPES)
def test_cross_attention_equals_jax(reduced, frames, prompt):
    """``cross_attn_kv`` and ``cross_attn_forward`` of decoder layer 1,
    from the encoder output and from the precomputed (k, v)."""
    jcfg, cfg, jparams, params = reduced
    rng = np.random.default_rng(frames)
    enc = rng.normal(size=(BATCH, frames, cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(BATCH, prompt, cfg.d_model)).astype(np.float32)
    jcross = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"]["pos0"]["cross"])
    cross = {k: v[1] for k, v in params["blocks"]["pos0"]["cross"].items()}
    assert sorted(cross) == ["wk", "wo", "wq", "wv"]  # no bias, no qk-norm
    jk, jv = JA.cross_attn_kv(jcross, jcfg, jnp.asarray(enc))
    k, v = A.cross_attn_kv(cross, cfg, torch.from_numpy(enc))
    _close(k, jk, msg="k")
    _close(v, jv, msg="v")
    want = JA.cross_attn_forward(jcross, jcfg, jnp.asarray(x), jnp.asarray(enc))
    _close(A.cross_attn_forward(cross, cfg, torch.from_numpy(x), torch.from_numpy(enc)), want)
    _close(A.cross_attn_forward(cross, cfg, torch.from_numpy(x), (k, v)), want)


@pytest.mark.parametrize("frames,prompt", SHAPES)
def test_encode_and_forward_equal_jax(reduced, frames, prompt):
    jcfg, cfg, jparams, params = reduced
    f, toks = _inputs(cfg, frames, prompt)
    jenc = JM.encode(jcfg, jparams, jnp.asarray(f))
    jlogits, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(f)})
    with torch.no_grad():
        enc = M.encode(cfg, params, torch.from_numpy(f))
        logits, aux = M.forward(cfg, params, {"tokens": torch.from_numpy(toks).long(),
                                              "frames": torch.from_numpy(f)})
    assert enc.shape == (BATCH, frames, cfg.d_model) and float(aux) == 0.0
    _close(enc, jenc, msg="encoder output")
    _close(logits, jlogits, msg="logits")


@pytest.mark.parametrize("frames,prompt", SHAPES)
def test_loss_and_grads_equal_jax(reduced, frames, prompt):
    """Every leaf, the encoder's and the decoder's cross attention among
    them, within GRAD_TOL of its largest entry; the loss within LOSS_TOL."""
    jcfg, cfg, jparams, params = reduced
    f, toks = _inputs(cfg, frames, prompt, seed=1)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(f)}), has_aux=True
    ))(jparams)
    loss, metrics, grads = make_grad_fn(cfg)(params, {"tokens": torch.from_numpy(toks).long(),
                                                      "frames": torch.from_numpy(f)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL, atol=0)
    np.testing.assert_allclose(float(metrics["nll"]), float(jaux["nll"]), rtol=LOSS_TOL, atol=0)
    want, got = jax_tree_paths(jgrads), tree_paths(grads)
    assert sorted(got) == sorted(want)
    assert {"encoder/blocks/pos0/mixer/wq", "blocks/pos0/cross/wk", "blocks/pos0/ln_x/scale"} <= set(got)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        assert np.abs(w).max() > 0, path  # the frames reach every leaf
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0, err_msg=path)


def test_remat_recomputes_the_same_grads(reduced):
    """Remat per period in the encoder and the decoder: the same bits as
    keeping every activation."""
    _, cfg, _, params = reduced
    f, toks = _inputs(cfg, 8, 16, seed=2)
    batch = {"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(f)}
    full = make_grad_fn(cfg, remat="full")(params, batch)
    none = make_grad_fn(cfg, remat="none")(params, batch)
    assert torch.equal(full[0], none[0])
    for path, g in tree_paths(full[2]).items():
        assert torch.equal(g, tree_paths(none[2])[path]), path


def test_encoder_attention_equals_the_jax_pallas_kernel(reduced, monkeypatch):
    """At 128 frames and 128 tokens the JAX package's encoder takes its
    Pallas flash kernel (interpret mode), non-causal, and its decoder the
    causal one; the port's plain path gives the same encoder output and
    logits."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    causal_flags, kernel = [], jax_ops.flash_attention_pallas

    def counted(*args, **kw):
        causal_flags.append(kw["causal"])
        return kernel(*args, **kw)

    monkeypatch.setattr(jax_ops, "flash_attention_pallas", counted)
    jcfg, cfg, jparams, params = reduced
    f, toks = _inputs(cfg, 128, 128, seed=3)
    jenc = JM.encode(jcfg, jparams, jnp.asarray(f))
    jlogits, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(f)})
    # a call each time a stack's scanned body is traced: the encoder's in
    # encode and in forward (non-causal), the decoder's in forward (causal)
    assert sorted(causal_flags) == [False, False, True], causal_flags
    with torch.no_grad():
        enc = M.encode(cfg, params, torch.from_numpy(f))
        logits, _ = M.forward(cfg, params, {"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(f)})
    _close(enc, jenc, msg="encoder output")
    _close(logits, jlogits, msg="logits")


def test_zero_frames_overflow_at_depth_as_in_jax():
    """The JAX controller's zero frames through 24 encoder layers: each
    RMSNorm of an all-zero row scales the gradient by 1/sqrt(eps), and a
    zero activation times the overflowed gradient is NaN, in both packages
    and on the same leaves; ``data.SyntheticFrames``' frames keep every
    gradient finite (the port trains enc-dec models on them)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), encoder_layers=24, num_layers=2)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), encoder_layers=24, num_layers=2)
    jparams = JM.init_params(jcfg, jax.random.key(0))
    params = params_from_jax({p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}, cfg, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (BATCH, 16)).astype(np.int32)
    zeros = np.zeros((BATCH, 16, cfg.d_model), np.float32)
    jgrads = jax.jit(jax.grad(lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(zeros)})[0]))(jparams)
    batch = {"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(zeros)}
    grads = tree_paths(make_grad_fn(cfg)(params, batch)[2])
    jbad = {p for p, g in jax_tree_paths(jgrads).items() if not np.isfinite(np.asarray(g)).all()}
    bad = {p for p, g in grads.items() if not torch.isfinite(g).all()}
    assert bad == jbad and bad and all(p.startswith("encoder/") for p in bad)
    data = SyntheticFrames(cfg.vocab_size, 16, BATCH, cfg.d_model)
    batch["frames"] = data.frames_at(0, "cpu")
    assert all(torch.isfinite(g).all() for g in tree_paths(make_grad_fn(cfg)(params, batch)[2]).values())


# ---------------------------------------------------------------------------
# The parameter tree at full width, and the train batch
# ---------------------------------------------------------------------------


def test_full_width_params_and_count_equal_jax():
    """``param_shapes`` and ``param_count`` from the meta device against
    ``abstract_params`` and ``analytic_param_count``: 24 encoder and 24
    decoder layers, d_model 1024, 16 heads of 64, d_ff 8192, vocab 256206,
    untied head; the same logical axes."""
    port, ref = get_config(ARCH), jax_get_config(ARCH)
    want = {p: tuple(x.shape) for p, x in jax_tree_paths(JM.abstract_params(ref)).items()}
    assert M.param_shapes(port) == want
    assert all(x.device.type == "meta" for x in tree_paths(M.abstract_params(port)).values())
    assert port.param_count() == JM.analytic_param_count(ref) == 2_034_784_256
    assert axes_paths(M.param_logical_axes(port)) == jax_axes_paths(JM.param_logical_axes(ref))
    assert want["encoder/blocks/pos0/mixer/wq"] == want["blocks/pos0/cross/wq"] == (24, 1024, 1024)


def test_cast_params_keeps_the_norm_scales_fp32(reduced):
    _, _, _, params = reduced
    cast = tree_paths(M.cast_params(params, "bfloat16"))
    scales = {p for p in cast if p.endswith("/scale")}
    assert {"blocks/pos0/ln_x/scale", "encoder/final_norm/scale", "encoder/blocks/pos0/ln1/scale"} <= scales
    assert all(cast[p].dtype == torch.float32 for p in scales)
    assert all(x.dtype == torch.bfloat16 for p, x in cast.items() if p not in scales)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_abstract_batch_equals_jax(dtype):
    port = dataclasses.replace(get_config(ARCH), dtype=dtype)
    ref = dataclasses.replace(jax_get_config(ARCH), dtype=dtype)
    ours, theirs = abstract_batch(port, 4, 1024), jax_abstract_batch(ref, 4, 1024)
    assert sorted(ours) == sorted(theirs) == ["frames", "tokens"]
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape and ours[k].device.type == "meta"
    assert str(ours["frames"].dtype).removeprefix("torch.") == str(theirs["frames"].dtype)
