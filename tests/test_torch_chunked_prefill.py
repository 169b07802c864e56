"""Chunked prefill in the port against the JAX package, on the CPU at the
reduced sizes: ``models.model.prefill_chunked`` (through
``transformer.stack_chunk`` and ``attention.attn_chunk``) against
``repro.models.model.prefill_chunked`` from the same weights
(``params_from_jax``), then one decode step from each cache, for the four
families of ``tests/test_chunked_prefill.py`` (qwen3, mamba2, jamba,
mixtral) and the ring case (mixtral, window 64, prompt 128 in chunks of
32: the ring wraps at every chunk past the first two). The port's chunked
prefill is also held against its own whole prefill, as the JAX test holds
the JAX one. On the CPU the attention goes through the plain version of
the flash kernel (right-aligned queries, keys in absolute order) and the
SSD scan through its plain version from the carried state. Inputs come
from numpy seeds; TF32 is off."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

# logits of ~4 in float32 after 4 layers, the same operations in other
# summation orders (the port's flash plain version against the JAX
# package's masked _sdpa over the whole cache)
LOGIT_TOL = 2e-5
# the cache: K/V and SSD states of the same computation
CACHE_TOL = 2e-5
# the JAX test's bound for chunked against whole prefill
WHOLE_TOL = 2e-4

FAMILIES = ["qwen3-1.7b", "mamba2-2.7b", "jamba-v0.1-52b", "mixtral-8x7b"]
# (arch, batch, prompt, chunk): the JAX test's shapes, and its ring case
CASES = [(arch, 2, 32, 8) for arch in FAMILIES] + [("mixtral-8x7b", 1, 128, 32)]


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax.jit(JM.init_params, static_argnums=0)(jcfg, jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    return jcfg, cfg, jparams, params_from_jax(flat, cfg, "cpu")


@pytest.mark.parametrize("arch,b,s,C", CASES)
def test_chunked_prefill_and_decode_equal_jax(arch, b, s, C):
    jcfg, cfg, jparams, params = _models(arch)
    if s > 32:
        assert cfg.sliding_window == 64 and s > cfg.sliding_window + C  # the ring wraps
    toks = np.random.default_rng(s + C).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    jlast, jcache = jax.jit(JM.prefill_chunked, static_argnums=(0, 3, 4))(
        jcfg, jparams, {"tokens": jnp.asarray(toks[:, :s])}, C, s + 4
    )
    jdec, _ = jax.jit(JM.decode_step, static_argnums=0)(jcfg, jparams, jcache, jnp.asarray(toks[:, s:]), jnp.int32(s))
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        last, cache = M.prefill_chunked(cfg, params, {"tokens": t[:, :s]}, C, max_seq=s + 4, cache_dtype=torch.float32)
        want = jax_tree_paths(jcache)
        for path, x in tree_paths(cache).items():
            np.testing.assert_allclose(x.numpy(), np.asarray(want[path]), rtol=0,
                                       atol=CACHE_TOL * max(1.0, np.abs(want[path]).max()), err_msg=path)
        dec, _ = M.decode_step(cfg, params, cache, t[:, s:], s)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=LOGIT_TOL * np.abs(jlast).max())
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=0, atol=LOGIT_TOL * np.abs(jdec).max())


@pytest.mark.parametrize("arch,b,s,C", CASES)
def test_chunked_prefill_equals_whole_prefill(arch, b, s, C):
    _, cfg, _, params = _models(arch)
    toks = torch.from_numpy(np.random.default_rng(s).integers(0, cfg.vocab_size, (b, s + 1))).long()
    with torch.no_grad():
        whole, wcache, _ = M.prefill(cfg, params, {"tokens": toks[:, :s]}, cache_dtype=torch.float32, max_seq=s + 4)
        chunked, ccache = M.prefill_chunked(cfg, params, {"tokens": toks[:, :s]}, C, max_seq=s + 4,
                                            cache_dtype=torch.float32)
        assert {p: x.shape for p, x in tree_paths(ccache).items()} == {p: x.shape for p, x in tree_paths(wcache).items()}
        assert float((chunked - whole).abs().max()) < WHOLE_TOL
        dw, _ = M.decode_step(cfg, params, wcache, toks[:, s:], s)
        dc, _ = M.decode_step(cfg, params, ccache, toks[:, s:], s)
    assert float((dc - dw).abs().max()) < WHOLE_TOL


def test_attn_chunk_keys_cover_the_ring_in_absolute_order():
    """A chunk through a wrapping ring sees exactly the keys of positions
    ``pos0 - T .. pos0 + C - 1``: its output equals the plain masked
    attention over the full history's K/V, and the write lands at
    ``pos0 % T`` after the read."""
    _, cfg, _, params = _models("mixtral-8x7b")
    bp = {k: v[0] for k, v in params["blocks"]["pos0"]["mixer"].items()}
    T, C, pos0 = cfg.sliding_window, 32, 96
    g = torch.Generator().manual_seed(3)
    hist = torch.randn(1, pos0 + C, cfg.d_model, generator=g)
    pos = torch.arange(pos0 + C, dtype=torch.int32)[None]
    _, k_all, v_all = A._project_qkv(bp, cfg, hist, pos)
    cache_k = torch.zeros(1, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache_v = torch.zeros_like(cache_k)
    for p in range(pos0 - T, pos0):  # the ring before the chunk
        cache_k[:, p % T], cache_v[:, p % T] = k_all[:, p], v_all[:, p]
    out, ck, cv = A.attn_chunk(bp, cfg, hist[:, pos0:], cache_k, cache_v, pos0)
    q, _, _ = A._project_qkv(bp, cfg, hist[:, pos0:], pos[:, pos0:])
    mask = A._causal_mask(C, pos0 + C, cfg.sliding_window, "cpu", q_offset=pos0)
    want = A._sdpa(q, k_all, v_all, mask, cfg.resolved_head_dim**-0.5).reshape(1, C, -1) @ bp["wo"]
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ck[:, pos0 % T : pos0 % T + C], k_all[:, pos0:], rtol=0, atol=0)
    with pytest.raises(ValueError, match="T % C"):
        A.attn_chunk(bp, cfg, hist[:, :24], cache_k, cache_v, 120)


def test_prefill_chunked_refuses_encdec_and_ragged_prompts():
    cfg = get_config("qwen3-1.7b").reduced()
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of chunk_len"):
        M.prefill_chunked(cfg, params, {"tokens": torch.zeros(1, 30, dtype=torch.long)}, 8)
    enc = get_config("seamless-m4t-large-v2").reduced()
    with pytest.raises(ValueError, match="decoder-only"):
        M.prefill_chunked(enc, {}, {"tokens": torch.zeros(1, 32, dtype=torch.long)}, 8)
