"""The port's training path through the model against the JAX package:
autograd of the plain flash-attention version against ``jax.grad`` of
``repro.kernels.ref.flash_attention_ref`` over ``tests/test_kernels.py``'s
flash sweep (GQA, causal and window, t != s), and ``loss_fn``'s value and
grads on reduced qwen3-1.7b against ``jax.value_and_grad`` of
``repro.models.model.loss_fn`` from the JAX package's weights, at seq 32
and 128, with and without remat. The backward CUDA kernel runs only on the
card, where ``chip_smoke.py`` holds it against this plain version; here the
tests cover its wrapper's checks, which run before any launch. Inputs come
from numpy seeds; TF32 is off."""

from __future__ import annotations

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
from repro_torch.distribution.step import make_grad_fn
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(2)

# f32 on both sides, other summation orders (the JAX sweep's own f32 bound)
BWD_TOL = 2e-6
# the loss: a mean over b x (s-1) positions of ~6.8
LOSS_TOL = 2e-6
# grads of the whole model: sums over b x s positions and 4 layers, relative
# to the largest gradient of the leaf
GRAD_TOL = 2e-5

SWEEP = [  # (b, s, t, h, kh, d, causal, window): test_kernels.py's sweep and its t > s case
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (2, 256, 256, 4, 1, 32, True, 128),  # MQA + sliding window
    (1, 128, 128, 2, 2, 128, False, 0),
    (1, 384, 384, 6, 3, 64, True, 0),  # GQA rep=2
    (1, 128, 256, 2, 2, 64, True, 0),  # t > s: right-aligned queries
    (2, 70, 150, 4, 2, 64, False, 32),  # ragged, non-causal window
]


@pytest.mark.parametrize("b,s,t,h,kh,d,causal,window", SWEEP)
def test_plain_flash_backward_equals_jax_grad(b, s, t, h, kh, d, causal, window):
    rng = np.random.default_rng(b * 1000 + s + t + h + d)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32)
                  for shape in [(b, s, h, d), (b, t, kh, d), (b, t, kh, d), (b, s, h, d)])

    def jax_loss(q, k, v):
        return jnp.sum(jax_ref.flash_attention_ref(q, k, v, causal=causal, window=window) * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=BWD_TOL * max(1.0, np.abs(w).max()),
                                   rtol=BWD_TOL, err_msg=name)


def test_backward_wrapper_refuses_what_the_kernel_does_not_compute():
    q = torch.zeros(1, 64, 2, 64)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse[:, :1], q)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse, q.double())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd_cuda(*(torch.zeros(1, 64, 2, 48),) * 4, lse, torch.zeros(1, 64, 2, 48))


def test_backward_source_is_built_with_the_others():
    assert {"flash_attention", "flash_attention_bwd", "reshard_pack", "reshard_quant"} <= {
        p.stem for p in build.CSRC.glob("*.cu")
    }
    assert build.library_path("flash_attention_bwd").name.startswith("libflash_attention_bwd_")


# ---------------------------------------------------------------------------
# loss_fn on reduced qwen3-1.7b
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    cfg = get_config("qwen3-1.7b").reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    return jcfg, cfg, jparams, flat


@pytest.mark.parametrize("seq", [32, 128])
def test_loss_and_grads_equal_jax(reduced, seq):
    """At seq 128 the JAX package's model is at its flash gate: both sides
    take the plain attention on the CPU (the Pallas kernel has no backward)."""
    jcfg, cfg, jparams, flat = reduced
    tokens = np.random.default_rng(seq).integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}), has_aux=True
    )(jparams)
    params = params_from_jax(flat, cfg, "cpu")
    loss, metrics, grads = make_grad_fn(cfg)(params, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["nll"]), float(jaux["nll"]), rtol=LOSS_TOL)
    want = jax_tree_paths(jgrads)
    assert sorted(tree_paths(grads)) == sorted(want)
    for path, g in tree_paths(grads).items():
        w = np.asarray(want[path])
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0, err_msg=path)


def test_forward_logits_equal_jax(reduced):
    jcfg, cfg, jparams, flat = reduced
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jlogits, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, aux = M.forward(cfg, params_from_jax(flat, cfg, "cpu"), {"tokens": torch.from_numpy(tokens).long()})
    assert float(aux) == 0.0 and logits.shape == (2, 32, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)


def test_remat_recomputes_the_same_grads(reduced):
    """``remat="full"`` (one checkpoint a period) against keeping every
    activation: the same arithmetic, so the same bits."""
    _, cfg, _, flat = reduced
    params = params_from_jax(flat, cfg, "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32))).long()}
    full = make_grad_fn(cfg, remat="full")(params, batch)
    none = make_grad_fn(cfg, remat="none")(params, batch)
    assert torch.equal(full[0], none[0])
    for path, g in tree_paths(full[2]).items():
        assert torch.equal(g, tree_paths(none[2])[path]), path
    with pytest.raises(NotImplementedError, match="dots"):
        T.stack_forward(params["blocks"], cfg, torch.zeros(1, 4, cfg.d_model), torch.zeros(1, 4), remat="dots")


def test_model_training_path_refuses_unported_families():
    for name in ("jamba-v0.1-52b", "mixtral-8x7b"):
        cfg = get_config(name).reduced()
        with pytest.raises(NotImplementedError, match="not ported"):
            M.loss_fn(cfg, {}, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
