"""The serving slice as a whole: the port's prefill + greedy decode held
against ``repro.models.model`` on the same weights and prompts.

Both packages get the JAX init (``jax.random.key(0)``) through
``params_from_jax`` and token prompts made with numpy. The caches are kept
in float32 on both sides (``cache_dtype``), so that the cache comparison
measures the model and not where a bf16 rounding boundary falls.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as port_fa
from repro_torch.models import model as M
from repro_torch.models.attention import attn_forward
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.driver import serve_once
from repro_torch.utils.pytree import tree_paths

torch.set_num_threads(2)

BATCH = 2
GEN = 8
# f32 on both sides; the bound covers summation order across frameworks
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


def _setup(cfg_jax, cfg, seed=0):
    """JAX params from ``jax.random.key(seed)`` and the port's copy of them."""
    params = JM.init_params(cfg_jax, jax.random.key(seed))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(params).items()}
    return params, params_from_jax(flat, cfg, "cpu")


def _tokens(cfg, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (BATCH, s), dtype=np.int32)


def _np(tree) -> dict:
    return {p: np.asarray(x, np.float32) for p, x in tree.items()}


@pytest.fixture(scope="module")
def qwen_reduced():
    cfg_jax, cfg = jax_get_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    jparams, tparams = _setup(cfg_jax, cfg)
    return cfg_jax, cfg, jparams, tparams


@pytest.mark.parametrize("prompt_len,force_pallas", [(32, False), (128, True)])
def test_prefill_and_greedy_decode_match_jax(qwen_reduced, monkeypatch, prompt_len, force_pallas):
    """Prefill logits, every cache leaf, every decode step's logits and the
    greedy tokens agree. At 128 the JAX side runs its Pallas flash kernel
    in interpret mode (as tests/test_kernels.py does); at 32 its jnp ref."""
    if force_pallas:
        monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    cfg_jax, cfg, jparams, tparams = qwen_reduced
    horizon = prompt_len + GEN
    toks = _tokens(cfg, prompt_len)

    jprefill = jax.jit(lambda p, t: JM.prefill(cfg_jax, p, {"tokens": t}, jnp.float32, horizon))
    jdecode = jax.jit(lambda p, c, t, pos: JM.decode_step(cfg_jax, p, c, t, pos))
    jlogits, jcache, _ = jprefill(jparams, jnp.asarray(toks))

    with torch.inference_mode():
        tlogits, tcache, cross = M.prefill(
            cfg, tparams, {"tokens": torch.from_numpy(toks).long()}, torch.float32, horizon
        )
    assert cross is None
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    jflat, tflat = _np(jax_tree_paths(jcache)), _np(tree_paths(tcache))
    assert jflat.keys() == tflat.keys()
    for path in jflat:
        assert tflat[path].shape == jflat[path].shape, path
        np.testing.assert_allclose(tflat[path], jflat[path], atol=CACHE_ATOL, rtol=0, err_msg=path)

    jcur = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
    tcur = tlogits[:, -1].argmax(dim=-1, keepdim=True)
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    for i in range(GEN):
        jlogits, jcache = jdecode(jparams, jcache, jcur, jnp.int32(prompt_len + i))
        with torch.inference_mode():
            tlogits, tcache = M.decode_step(cfg, tparams, tcache, tcur, prompt_len + i)
        np.testing.assert_allclose(
            tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0, err_msg=f"step {i}"
        )
        jcur = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
        tcur = tlogits[:, -1].argmax(dim=-1, keepdim=True)
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur), err_msg=f"step {i}")
    jflat, tflat = _np(jax_tree_paths(jcache)), _np(tree_paths(tcache))
    for path in jflat:
        np.testing.assert_allclose(tflat[path], jflat[path], atol=CACHE_ATOL, rtol=0, err_msg=path)
    assert port_fa.launches == 0  # the CPU path never reaches the kernel


def test_prefill_bf16_matches_jax(qwen_reduced):
    """bf16 activations. Both packages round every matmul output and cast
    point to bf16, in different summation orders, so they cannot agree to
    f32 precision. The tolerance is set from the JAX package's own bf16
    error on these inputs, ``e = max|JAX bf16 - JAX f32|`` (~0.05 on logits
    of size ~3, some 6 bf16 steps): the port's bf16 logits must lie within
    ``2e`` of the JAX bf16 logits and of the f32 logits. A wrong mask, head
    mapping or norm moves logits by O(1)."""
    cfg_jax, cfg, jparams, tparams = qwen_reduced
    toks = _tokens(cfg, 64, seed=1)
    jf32, _, _ = jax.jit(lambda p, t: JM.prefill(cfg_jax, p, {"tokens": t}))(jparams, jnp.asarray(toks))
    cfg_jax = dataclasses.replace(cfg_jax, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jbf16, _, _ = jax.jit(lambda p, t: JM.prefill(cfg_jax, p, {"tokens": t}))(jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tlogits, _, _ = M.prefill(cfg, tparams, {"tokens": torch.from_numpy(toks).long()})
    assert tlogits.dtype == torch.bfloat16
    jf32, jbf16 = np.asarray(jf32, np.float32), np.asarray(jbf16, np.float32)
    port = tlogits.float().numpy()
    e = np.abs(jbf16 - jf32).max()
    assert 0 < e < 0.2
    np.testing.assert_allclose(port, jbf16, atol=2 * e, rtol=0)
    np.testing.assert_allclose(port, jf32, atol=2 * e, rtol=0)


def test_cast_params_is_bit_identical(qwen_reduced):
    """Pre-casting the weights once gives bitwise the logits of casting at
    every use; norm scales stay fp32."""
    _, cfg, _, tparams = qwen_reduced
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    cast = M.cast_params(tparams, "bfloat16")
    flat = tree_paths(cast)
    assert flat["blocks/pos0/mixer/wq"].dtype == torch.bfloat16
    assert flat["blocks/pos0/mixer/q_norm"].dtype == torch.float32
    assert flat["final_norm/scale"].dtype == torch.float32
    toks = {"tokens": torch.from_numpy(_tokens(cfg, 48, seed=2)).long()}
    with torch.inference_mode():
        a, ca, _ = M.prefill(cfg, tparams, toks, max_seq=52)
        b, cb, _ = M.prefill(cfg, cast, toks, max_seq=52)
        assert torch.equal(a, b)
        cur = a[:, -1].argmax(-1, keepdim=True)
        a2, _ = M.decode_step(cfg, tparams, ca, cur, 48)
        b2, _ = M.decode_step(cfg, cast, cb, cur, 48)
    assert torch.equal(a2, b2)


@pytest.mark.parametrize("causal", [True, False])
def test_attn_forward_sdpa_path_matches_jax(qwen_reduced, causal):
    """``use_kernel=False`` (the written-out ``_sdpa``) against the JAX
    package's own ``use_kernel=False`` path on layer 0's weights."""
    from repro.models.attention import attn_forward as jax_attn_forward

    cfg_jax, cfg, jparams, tparams = qwen_reduced
    x = np.random.default_rng(3).normal(size=(BATCH, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (BATCH, 24))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["pos0"]["mixer"])
    tp = {k: v[0] for k, v in tparams["blocks"]["pos0"]["mixer"].items()}
    want = jax_attn_forward(jp, cfg_jax, jnp.asarray(x), jnp.asarray(pos), causal=causal, use_kernel=False)
    got = attn_forward(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()), causal=causal, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    got_kernel_path = attn_forward(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()), causal=causal)
    np.testing.assert_allclose(got_kernel_path.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_sliding_window_decode_matches_jax():
    """A windowed dense model (ring-buffer cache, window mask in prefill
    and decode) against the JAX package, prompt a multiple of the window."""
    base = dataclasses.replace(jax_get_config("qwen3-1.7b"), sliding_window=16)
    cfg_jax = base.reduced()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), sliding_window=16).reduced()
    jparams, tparams = _setup(cfg_jax, cfg, seed=1)
    toks = _tokens(cfg, 32, seed=4)
    jlogits, jcache, _ = JM.prefill(cfg_jax, jparams, {"tokens": jnp.asarray(toks)}, jnp.float32, 36)
    with torch.inference_mode():
        tlogits, tcache, _ = M.prefill(cfg, tparams, {"tokens": torch.from_numpy(toks).long()}, torch.float32, 36)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    jcur = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
    for i in range(4):
        jlogits, jcache = JM.decode_step(cfg_jax, jparams, jcache, jcur, jnp.int32(32 + i))
        with torch.inference_mode():
            tlogits, tcache = M.decode_step(cfg, tparams, tcache, torch.from_numpy(np.array(jcur)).long(), 32 + i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
        jcur = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]


def test_serve_once_cpu_is_deterministic():
    cfg = get_config("qwen3-1.7b").reduced()
    a = serve_once(cfg, batch=2, prompt_len=16, gen=4, device="cpu")
    b = serve_once(cfg, batch=2, prompt_len=16, gen=4, device="cpu")
    assert a["tokens"].shape == (2, 5)
    assert a["tokens"].min() >= 0 and a["tokens"].max() < cfg.vocab_size
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = serve_once(cfg, batch=2, prompt_len=16, gen=4, device="cpu", temperature=1.0)
    assert c["tokens"].shape == (2, 5)


def test_serve_once_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_once(get_config("qwen3-1.7b").reduced(), batch=1, prompt_len=8, gen=1)
