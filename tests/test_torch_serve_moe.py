"""Serving the MoE MLP on the port, held against the JAX package: reduced
mixtral-8x7b and jamba-v0.1-52b prefill and greedy decode from the JAX
package's weights, mixtral's ring cache past its window of 64
(``tests/test_models.py::test_sliding_window_ring_cache``), and an elastic
serving run of reduced mixtral that changes the expert-parallel degree
mid-generation (dp2tp2 -> dp2tp2ep2 -> dp1tp2ep4 -> dp1tp4): tokens equal
to its unresized run, which equals the JAX package's ``ServeSession``,
and each commit's planned bytes equal to the JAX ``serve_plan``'s.

The reduced configs' capacity factor drops no (token, choice) pair, so a
prefill followed by decode steps computes what the full forward computes;
below a factor of ``num_experts`` it would not, in either package: capacity
is counted per call, over the call's tokens."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as JM
from repro.serve import LiveServeController as JaxController
from repro.serve import ServeSession as JaxSession
from repro.serve import cache_view as JC
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch import configs
from repro_torch.core.events import ResizeEvent
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.controller import LiveServeController
from repro_torch.serve.loop import ServeSession

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PC, JPC = configs.ParallelConfig, jax_configs.ParallelConfig
LOGIT_ATOL = 1e-4  # f32 on both sides, as tests/test_torch_ssm.py holds mamba2's logits
N_SLOTS, PLEN, GEN, MAX_SEQ = 4, 16, 10, 32
# (dp, tp, ep) at each commit time: every world fits 8 ranks
TRACE = [((2, 2, 2), 3.0), ((1, 2, 4), 5.0), ((1, 4, 1), 7.0)]


def _both(arch: str):
    jcfg, cfg = jax_configs.get_config(arch).reduced(), configs.get_config(arch).reduced()
    init = JM.init_params(jcfg, jax.random.key(0))
    return jcfg, cfg, init, params_from_jax(jax_tree_paths(init), cfg, "cpu")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b"])
def test_prefill_and_greedy_decode_equal_jax(arch):
    jcfg, cfg, jparams, params = _both(arch)
    tokens = np.random.default_rng(len(arch)).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jc, _ = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t}, cache_dtype=jnp.float32, max_seq=32))(
        jparams, jnp.asarray(tokens))
    jdecode = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
    with torch.inference_mode():
        tl, tc, _ = M.prefill(cfg, params, {"tokens": torch.from_numpy(tokens).long()}, torch.float32, 32)
        for step in range(6):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0, err_msg=f"step {step}")
            jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
            tt = tl[:, -1].argmax(-1, keepdim=True)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            jl, jc = jdecode(jparams, jc, jt, jnp.int32(24 + step))
            tl, tc = M.decode_step(cfg, params, tc, tt, 24 + step)


def test_sliding_window_ring_cache_equals_the_full_forward():
    """Decode past mixtral's window of 64: the ring cache's logits equal the
    full forward's at the same positions, in the port and in the JAX
    package."""
    jcfg, cfg, jparams, params = _both("mixtral-8x7b")
    assert cfg.sliding_window == 64
    s, n = 128, 8  # a prompt of two windows (the ring-aligned prefill), then 8 tokens teacher-forced
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, s + n)).astype(np.int32)
    jfull, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        full, _ = M.forward(cfg, params, {"tokens": torch.from_numpy(toks).long()})
        np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=LOGIT_ATOL, rtol=0)
        _, cache, _ = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :s]).long()}, torch.float32, s + n)
        assert cache["pos0"]["k"].shape[2] == cfg.sliding_window
        for i in range(n):
            logits, cache = M.decode_step(cfg, params, cache, torch.from_numpy(toks[:, s + i : s + i + 1]).long(), s + i)
            assert float((logits[:, 0] - full[:, s + i]).abs().max()) < 2e-4, i


@pytest.fixture(scope="module")
def runs():
    """The port's uninterrupted and resized sessions of reduced mixtral and
    the JAX package's uninterrupted one, from the JAX seed-0 weights."""
    jcfg, cfg, _, _ = _both("mixtral-8x7b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PLEN) for _ in range(6)]
    jflat = jax_tree_paths(JM.init_params(jcfg, jax.random.key(0)))

    def port_run(trace):
        ctrl = LiveServeController(cfg, PC(dp=2, tp=2), N_SLOTS, PLEN, MAX_SEQ, sync_prepare=True, device="cpu",
                                   params=params_from_jax(jflat, cfg, "cpu"))
        sess = ServeSession(ctrl, step_time_s=1.0)
        for p in prompts:
            sess.submit(p, GEN)
        results, metrics = sess.run([ResizeEvent(time_s=t, target=PC(dp=d, tp=tp, ep=ep)) for (d, tp, ep), t in trace])
        recs = list(ctrl.records)
        ctrl.shutdown()
        return results, metrics, recs

    jctrl = JaxController(jcfg, JPC(dp=1, tp=1), N_SLOTS, PLEN, MAX_SEQ, sync_prepare=True, seed=0)
    jsess = JaxSession(jctrl, step_time_s=1.0)
    for p in prompts:
        jsess.submit(p, GEN)
    jax_results, _ = jsess.run([])
    jctrl.shutdown()
    return {"plain": port_run([]), "resized": port_run(TRACE), "jax": jax_results, "jcfg": jcfg}


def test_uninterrupted_mixtral_session_equals_the_jax_session(runs):
    results, metrics, recs = runs["plain"]
    assert metrics.dropped == 0 and len(results) == 6 and not recs
    assert all(len(t) == GEN for t in results.values())
    assert results == runs["jax"]


def test_mixtral_survives_three_expert_parallel_resizes(runs):
    results, metrics, recs = runs["resized"]
    assert metrics.dropped == 0 and metrics.commits == 3 and len(results) == 6
    assert results == runs["plain"][0]
    assert [(r.src, r.dst) for r in recs] == [
        ("dp2xpp1xtp2", "dp2xpp1xtp2xep2"), ("dp2xpp1xtp2xep2", "dp1xpp1xtp2xep4"), ("dp1xpp1xtp2xep4", "dp1xpp1xtp4"),
    ]
    assert all(r.cut_step > 0 and r.outcome == "committed" for r in recs)
    # every commit changes ep, so every one moves expert slices
    assert all(r.executed_bytes > 0 for r in recs)
    jspecs = JC.serve_state_specs(runs["jcfg"], N_SLOTS, MAX_SEQ, cache_dtype="float32")
    prev = (2, 2, 1)
    for rec, ((dp, tp, ep), _) in zip(recs, TRACE):
        want = JC.serve_plan(runs["jcfg"], jspecs, JPC(dp=prev[0], tp=prev[1], ep=prev[2]), JPC(dp=dp, tp=tp, ep=ep))
        assert (rec.plan_network_bytes, rec.plan_local_bytes, rec.skipped_bytes) == (
            want.network_bytes, want.local_bytes, want.resident_bytes,
        )
        prev = (dp, tp, ep)


def test_the_cli_serves_reduced_mixtral_on_the_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mixtral-8x7b", "--reduced", "--device", "cpu",
           "--batch", "2", "--prompt-len", "32", "--gen", "4"]
    out = subprocess.run(cmd, env={**os.environ, "PYTHONPATH": str(REPO / "src")}, capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "[prefill] 2x32 tokens" in out.stdout and "[decode] 4 steps x batch 2" in out.stdout
