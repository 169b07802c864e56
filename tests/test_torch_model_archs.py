"""Every dense and MoE architecture the port runs, held against the JAX
package's model: ``loss_fn``'s value and gradients on each reduced config against
``jax.value_and_grad`` of ``repro.models.model.loss_fn``, from the JAX
package's weights through ``params_from_jax``. gemma-7b covers GeGLU and
the tied head, qwen2.5-14b the qkv bias (drawn nonzero in the JAX params
before conversion: it is zero at init, where a wrong bias path would not
show), minitron-8b and chameleon-34b their widths, the six gpt sizes
the paper's family, and mixtral-8x7b, llama4-scout-17b-a16e (top-1 and a
shared expert) and jamba-v0.1-52b (SSD and attention mixers, MoE every
second layer) the MoE MLP with its aux loss in the loss: at the reduced
capacity factor (no pair dropped) and, for mixtral, at the full config's
1.25 (pairs dropped), set on both sides. qwen3-1.7b and mamba2-2.7b have their own files
(``test_torch_train_model.py``, ``test_torch_ssm.py``), seamless
``test_torch_encdec.py``. Batch 2 x 64 tokens from a numpy seed; TF32 off;
at 64 tokens the JAX model takes its plain attention, as it does on the
CPU below 128."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.utils.pytree import tree_from_paths as jax_tree_from_paths
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch.configs import get_config
from repro_torch.distribution.step import make_grad_fn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import block_program
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(2)

ARCHS = ["gemma-7b", "qwen2.5-14b", "minitron-8b", "chameleon-34b",
         "gpt-1.7b", "gpt-7b", "gpt-14b", "gpt-20b", "gpt-30b", "gpt-70b",
         "mixtral-8x7b", "llama4-scout-17b-a16e", "jamba-v0.1-52b", "mixtral-8x7b@1.25"]
BATCH, SEQ = 2, 64
# f32 on both sides, other summation orders: the loss relative to its
# value, each gradient leaf relative to its largest entry (measured on
# these configs: 1.4e-7 and 2.75e-6 at most)
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
# the SSD mixers' leaves, as tests/test_torch_ssm.py holds mamba2's:
# against the port in float64, the JAX package's own f32 gradients of the
# reduced jamba's mixer D and A_log are 2.3e-5 and 1.8e-5 of their maxima
# away. Every other leaf, jamba's attention, router, experts and dense
# MLPs too, is held to GRAD_TOL
SSM_GRAD_TOL = 2e-5


def _jax_params(jcfg, seed: int) -> tuple[dict, dict]:
    """The JAX package's init with every qkv bias drawn from N(0, 0.5):
    (the JAX tree, its leaves by path as numpy arrays)."""
    init = JM.init_params(jcfg, jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(init).items()}
    rng = np.random.default_rng(seed)
    for p in flat:
        if p.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
            flat[p] = rng.normal(0.0, 0.5, flat[p].shape).astype(flat[p].dtype)
    return jax_tree_from_paths({p: jnp.asarray(x) for p, x in flat.items()}, init), flat


def _configs(name: str):
    """Both packages' reduced config of ``name``; ``arch@factor`` sets the
    MoE capacity factor on both."""
    arch, _, factor = name.partition("@")
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if factor:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=float(factor))
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(factor))
    return jcfg, cfg


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_equal_jax(name):
    jcfg, cfg = _configs(name)
    jparams, flat = _jax_params(jcfg, seed=len(name))
    biases = [p for p in flat if p.rsplit("/", 1)[-1] in ("bq", "bk", "bv")]
    assert bool(biases) == cfg.qkv_bias and all(np.abs(flat[p]).max() > 0 for p in biases)
    tokens = np.random.default_rng(SEQ + len(name)).integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}), has_aux=True
    ))(jparams)
    loss, metrics, grads = make_grad_fn(cfg)(params_from_jax(flat, cfg, "cpu"),
                                            {"tokens": torch.from_numpy(tokens).long()})

    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL, atol=0)
    np.testing.assert_allclose(float(metrics["nll"]), float(jaux["nll"]), rtol=LOSS_TOL, atol=0)
    np.testing.assert_allclose(float(metrics["moe_aux"]), float(jaux["moe_aux"]), rtol=LOSS_TOL, atol=0)
    assert (float(metrics["moe_aux"]) > 0) == (cfg.num_experts > 0)
    want = jax_tree_paths(jgrads)
    got = tree_paths(grads)
    assert sorted(got) == sorted(want)
    ssd_mixers = tuple(f"blocks/pos{j}/mixer/" for j, (mixer, _) in enumerate(block_program(cfg)) if mixer == "ssm")
    assert bool(ssd_mixers) == (cfg.family == "hybrid")
    for path, g in got.items():
        w = np.asarray(want[path])
        tol = SSM_GRAD_TOL if path.startswith(ssd_mixers) else GRAD_TOL
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, atol=tol * np.abs(w).max(), rtol=0, err_msg=path)
