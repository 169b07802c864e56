"""Serving, resizing and training seamless-m4t-large-v2 (enc-dec) on the
port, held against the JAX package on the CPU: ``prefill`` (logits, cache,
cross-attention KV) and 4 decode steps; the serving specs with the
``cross/`` leaves; the serving plans task by task and the port's
LiveExecutor against the JAX byte oracle (``SimExecutor`` over per-rank
numpy shards) on the card's elastic chain dp2tp2 -> dp1tp2 -> dp1tp4 ->
dp2tp2; a ``ServeSession`` with three resizes mid-generation, token for
token equal to the port's uninterrupted run, which equals the JAX
package's; a ``LiveRController`` streamed resize bitwise equal to a run
never resized; the serving CLI. Reduced seamless, frames of 8 and 16
positions and prompts of 16 and 32 tokens made with numpy.

The encoder's layer i and the decoder's layer i share a global layer id
(``/pos0/`` and the stacked index), as in the JAX package: the planner
streams them together."""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.resource_view import view_of
from repro.core.streaming import allocate_destination, execute_plan, materialize_rank
from repro.models import model as JM
from repro.serve import LiveServeController as JaxController
from repro.serve import ServeSession as JaxSession
from repro.serve import cache_view as JC
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch import configs
from repro_torch.core.controller import LiveRController
from repro_torch.core.events import ResizeEvent
from repro_torch.core.reshard import named_state_leaves
from repro_torch.core.resource_view import itemsize
from repro_torch.data import SyntheticFrames, SyntheticLM
from repro_torch.models import kvcache
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.reshard import LiveExecutor, ReshardEngine
from repro_torch.serve import cache_view as C
from repro_torch.serve.controller import LiveServeController
from repro_torch.serve.driver import demo_batch, serve_once
from repro_torch.serve.loop import ServeSession
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
BATCH, DECODE = 2, 4
SHAPES = [(8, 16), (16, 32)]  # (frames, prompt)
LOGIT_ATOL, CACHE_ATOL = 1e-4, 1e-5  # f32 on both sides (tests/test_torch_serve.py)
BUDGET = 8192
CPU = torch.device("cpu")
# chip_smoke.py's elastic chain: (src (dp, tp), dst)
CHAIN = [((2, 2), (1, 2)), ((1, 2), (1, 4)), ((1, 4), (2, 2))]
N_SLOTS, PLEN, FRAMES, GEN, MAX_SEQ = 4, 16, 8, 10, 32


def _pcs(a, b):
    return (configs.ParallelConfig(dp=a[0], tp=a[1]), configs.ParallelConfig(dp=b[0], tp=b[1])), (
        jax_configs.ParallelConfig(dp=a[0], tp=a[1]),
        jax_configs.ParallelConfig(dp=b[0], tp=b[1]),
    )


def _astuples(items):
    return [dataclasses.astuple(x) for x in items]


@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = jax_configs.get_config(ARCH).reduced(), configs.get_config(ARCH).reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    return jcfg, cfg, jparams, flat


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames,prompt", SHAPES)
def test_prefill_and_decode_equal_jax(reduced, frames, prompt):
    jcfg, cfg, jparams, flat = reduced
    params = params_from_jax(flat, cfg, "cpu")
    rng = np.random.default_rng(frames + prompt)
    f = rng.normal(size=(BATCH, frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    horizon = prompt + DECODE
    jlogits, jcache, jcross = JM.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(f)}, jnp.float32, horizon
    )
    with torch.inference_mode():
        logits, cache, cross = M.prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(f)},
            torch.float32, horizon,
        )
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    for name, ours, theirs in (("cache", cache, jcache), ("cross", cross, jcross)):
        want, got = jax_tree_paths(theirs), tree_paths(ours)
        assert sorted(got) == sorted(want), name
        for path, x in got.items():
            assert x.dtype == torch.float32 and tuple(x.shape) == want[path].shape, (name, path)
            np.testing.assert_allclose(x.numpy(), np.asarray(want[path]), atol=CACHE_ATOL, rtol=0,
                                       err_msg=f"{name}/{path}")
    assert tuple(cross["pos0"]["k"].shape) == (cfg.num_layers, BATCH, frames, cfg.num_kv_heads, cfg.resolved_head_dim)

    jcur = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
    cur = logits[:, -1].argmax(dim=-1, keepdim=True)
    for i in range(DECODE):
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jcur, jnp.int32(prompt + i), jcross)
        with torch.inference_mode():
            logits, cache = M.decode_step(cfg, params, cache, cur, prompt + i, cross)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0, err_msg=f"step {i}")
        jcur = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
        cur = logits[:, -1].argmax(dim=-1, keepdim=True)
        np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur), err_msg=f"step {i}")
    for path, x in tree_paths(cache).items():
        np.testing.assert_allclose(x.numpy(), np.asarray(jax_tree_paths(jcache)[path]), atol=CACHE_ATOL, rtol=0)


def test_prefill_holds_the_cross_kv_in_the_cache_dtype(reduced):
    """The serving specs hold the cross KV in the cache dtype, so prefill
    returns it so (a bf16 cache from an f32 model here); the JAX package
    returns it in ``cfg.dtype``."""
    _, cfg, _, flat = reduced
    params = params_from_jax(flat, cfg, "cpu")
    batch = demo_batch(cfg, BATCH, 16, "cpu", frames_len=8)
    with torch.inference_mode():
        _, cache, cross = M.prefill(cfg, params, batch, torch.bfloat16, 20)
        _, _, cross32 = M.prefill(cfg, params, batch, torch.float32, 20)
    assert all(x.dtype == torch.bfloat16 for x in (*tree_paths(cache).values(), *tree_paths(cross).values()))
    for path, x in tree_paths(cross).items():
        assert torch.equal(x, tree_paths(cross32)[path].to(torch.bfloat16)), path
    like = kvcache.init_cross_kv(cfg, BATCH, 8, torch.bfloat16, "cpu")
    assert {p: (x.shape, x.dtype) for p, x in tree_paths(like).items()} == {
        p: (x.shape, x.dtype) for p, x in tree_paths(cross).items()}
    assert kvcache.init_cross_kv(configs.get_config("qwen3-1.7b").reduced(), BATCH, 8, device="cpu") is None


# ---------------------------------------------------------------------------
# Specs and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cross_len", [8, 16])
def test_serve_state_specs_equal_jax(cross_len):
    port, ref = configs.get_config(ARCH).reduced(), jax_configs.get_config(ARCH).reduced()
    ours = C.serve_state_specs(port, 4, 32, "float32", cross_len=cross_len)
    assert _astuples(ours) == _astuples(JC.serve_state_specs(ref, 4, 32, cache_dtype="float32", cross_len=cross_len))
    cross = [s for s in ours if s.collection == "cross"]
    assert [s.name for s in cross] == ["cross/pos0/k", "cross/pos0/v"]
    assert all(s.shape == (port.num_layers, 4, cross_len, port.num_kv_heads, port.resolved_head_dim) for s in cross)
    assert all(s.roles == ("pp", "none", "none", "tp", "none") for s in cross)


def test_full_width_serve_state_holds_the_served_dtypes():
    """At full width (8 slots x 544 positions, 512 frames, bf16): the cache
    and cross specs equal the JAX package's; the params differ only in
    dtype (bf16 matrices, fp32 norm scales). 4.07 GB of params, 0.43 GB of
    self-attention cache, 0.40 GB of cross KV."""
    port, ref = configs.get_config(ARCH), jax_configs.get_config(ARCH)
    ours = C.serve_state_specs(port, 8, 544, "bfloat16", cross_len=512)
    theirs = JC.serve_state_specs(ref, 8, 544, cache_dtype="bfloat16", cross_len=512)
    assert _astuples(dataclasses.replace(s, dtype="-") for s in ours) == _astuples(
        dataclasses.replace(t, dtype="-") for t in theirs)
    live = [s for s in ours if s.collection != "params"]
    assert _astuples(live) == _astuples([t for t in theirs if t.collection != "params"])
    by = {c: sum(s.nbytes for s in ours if s.collection == c) for c in ("params", "cache", "cross")}
    assert by == {"params": 4_069_818_368, "cache": 427_819_008, "cross": 402_653_184}
    scales = {s.name for s in ours if s.name.endswith("/scale")}
    assert all(s.dtype == ("float32" if s.name in scales else "bfloat16") for s in ours if s.collection == "params")


@pytest.mark.parametrize("a,b", CHAIN)
def test_serve_plan_equals_jax(a, b):
    """Params, cache and cross KV, task by task, the cross cells among
    them; encoder layer i streams under decoder layer i's layer id."""
    port, ref = configs.get_config(ARCH).reduced(), jax_configs.get_config(ARCH).reduced()
    ours, theirs = _pcs(a, b)
    specs = C.serve_state_specs(port, 4, 32, "float32", cross_len=8)
    plan = C.serve_plan(port, specs, *ours)
    want = JC.serve_plan(ref, JC.serve_state_specs(ref, 4, 32, cache_dtype="float32", cross_len=8), *theirs)
    assert _astuples(plan.tasks) == _astuples(want.tasks)
    assert (plan.network_bytes, plan.local_bytes, plan.resident_bytes) == (
        want.network_bytes, want.local_bytes, want.resident_bytes)
    assert {t.tensor for t in plan.tasks if t.collection == "cross"} == {"cross/pos0/k", "cross/pos0/v"}
    layers = lambda name: {t.layer for t in plan.tasks if t.tensor == name}  # noqa: E731
    assert layers("params/encoder/blocks/pos0/mixer/wq") == set(range(port.encoder_layers))
    assert layers("params/blocks/pos0/mixer/wq") == layers("cross/pos0/k") == set(range(port.num_layers))


@pytest.mark.parametrize("a,b", CHAIN)
def test_full_width_serve_plan_matches_jax_up_to_dtype(a, b):
    """8 slots x 544 positions and 512 frames (the card's elastic path):
    the JAX planner's tasks, each task's bytes scaled by the itemsize the
    port serves that tensor in. The cross cells move where the tp degree
    changes (16 kv heads over 2 or 4 ranks) and stay resident where not."""
    port, ref = configs.get_config(ARCH), jax_configs.get_config(ARCH)
    ours, theirs = _pcs(a, b)
    specs = C.serve_state_specs(port, 8, 544, "bfloat16", cross_len=512)
    jspecs = JC.serve_state_specs(ref, 8, 544, cache_dtype="bfloat16", cross_len=512)
    plan, want = C.serve_plan(port, specs, *ours), JC.serve_plan(ref, jspecs, *theirs)
    ours_size = {s.name: itemsize(s.dtype) for s in specs}
    jax_size = {s.name: np.dtype(s.dtype).itemsize for s in jspecs}
    assert len(plan.tasks) == len(want.tasks)
    for got, exp in zip(plan.tasks, want.tasks):
        scaled = exp.nbytes // jax_size[exp.tensor] * ours_size[exp.tensor]
        assert dataclasses.astuple(got) == dataclasses.astuple(dataclasses.replace(exp, nbytes=scaled))
    cross = [t for t in plan.tasks if t.collection == "cross"]
    assert cross and all((t.kind == "resident") == (a[1] == b[1]) for t in cross)


@pytest.mark.parametrize("a,b", CHAIN)
def test_live_executor_delivers_the_oracle_bytes(a, b):
    """The whole reduced serving state (params, cache, cross KV) through
    the port's LiveExecutor against the JAX byte oracle: the same stream
    stats, and every destination shard byte for byte."""
    port, ref = configs.get_config(ARCH).reduced(), jax_configs.get_config(ARCH).reduced()
    (ca, cb), (ja, jb) = _pcs(a, b)
    specs = C.serve_state_specs(port, 4, 32, "float32", cross_len=8)
    jspecs = JC.serve_state_specs(ref, 4, 32, cache_dtype="float32", cross_len=8)
    rng = np.random.default_rng(a[0] * 10 + b[1])
    g = {s.name: rng.normal(size=s.shape).astype(np.float32) for s in specs}
    src = {r: materialize_rank(jspecs, ja, r, g) for r in range(ja.world_size)}
    dst = {r: allocate_destination(jspecs, jb, r) for r in range(jb.world_size)}
    sim = execute_plan(JC.serve_plan(ref, jspecs, ja, jb), src, dst, staging_bytes=BUDGET)
    tensors = {s.name: torch.from_numpy(g[s.name].copy()) for s in specs}
    ex = LiveExecutor({s.name: s for s in specs}, tensors, [CPU] * ca.world_size, [CPU] * cb.world_size, BUDGET)
    stats = ReshardEngine(C.serve_plan(port, specs, ca, cb), ex, staging_bytes=BUDGET).run()
    ex.block_until_ready()
    for field in ("network_bytes", "local_bytes", "resident_bytes", "layers_streamed"):
        assert getattr(stats, field) == getattr(sim, field), field
    stats.assert_bounded(BUDGET)
    for s in specs:
        got = ex.results()[s.name].numpy()
        np.testing.assert_array_equal(got, g[s.name], err_msg=s.name)
        for r in range(jb.world_size):
            v = view_of(s, jb, r)
            if v is None or s.name not in dst[r].shards:
                continue
            np.testing.assert_array_equal(got[tuple(slice(lo, hi) for lo, hi in v.bounds)], dst[r].shards[s.name])
    assert (stats.executed_bytes == 0) == (a[1] == b[1])


# ---------------------------------------------------------------------------
# Elastic serving end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sessions(reduced):
    """The port's uninterrupted and thrice-resized sessions and the JAX
    package's uninterrupted one, from the JAX package's seed-0 weights; 6
    requests with frames, so the 4 slots take two waves."""
    jcfg, cfg, _, flat = reduced
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, PLEN), rng.normal(size=(FRAMES, cfg.d_model)).astype(np.float32))
            for _ in range(6)]

    def port_run(trace):
        ctrl = LiveServeController(cfg, configs.ParallelConfig(dp=2, tp=2), N_SLOTS, PLEN, MAX_SEQ,
                                   frames_len=FRAMES, sync_prepare=True, device="cpu",
                                   params=params_from_jax(flat, cfg, "cpu"))
        sess = ServeSession(ctrl, step_time_s=1.0)
        for prompt, frames in reqs:
            sess.submit(prompt, GEN, frames=frames)
        events = [ResizeEvent(time_s=3.0 * (i + 1), target=configs.ParallelConfig(dp=dp, tp=tp))
                  for i, (_, (dp, tp)) in enumerate(trace)]
        results, metrics = sess.run(events)
        records = list(ctrl.records)
        ctrl.shutdown()
        return results, metrics, records

    jctrl = JaxController(jcfg, jax_configs.ParallelConfig(dp=1, tp=1), N_SLOTS, PLEN, MAX_SEQ,
                          frames_len=FRAMES, sync_prepare=True, seed=0)
    jsess = JaxSession(jctrl, step_time_s=1.0)
    for prompt, frames in reqs:
        jsess.submit(prompt, GEN, frames=frames)
    jax_results, _ = jsess.run([])
    jctrl.shutdown()
    return {"plain": port_run([]), "resized": port_run(CHAIN), "jax": jax_results}


def test_uninterrupted_session_equals_the_jax_session(sessions):
    results, metrics, records = sessions["plain"]
    assert metrics.dropped == 0 and len(results) == 6 and metrics.waves == 2 and not records
    assert results == sessions["jax"]


def test_generation_survives_three_resizes_token_for_token(sessions):
    """dp2tp2 -> dp1tp2 -> dp1tp4 -> dp2tp2 mid-generation: the cache and
    the cross KV migrate with the params, and the tokens are the
    uninterrupted run's."""
    results, metrics, records = sessions["resized"]
    assert metrics.commits == 3 and metrics.dropped == 0
    assert results == sessions["plain"][0] == sessions["jax"]
    assert [(r.src, r.dst) for r in records] == [
        ("dp2xpp1xtp2", "dp1xpp1xtp2"), ("dp1xpp1xtp2", "dp1xpp1xtp4"), ("dp1xpp1xtp4", "dp2xpp1xtp2")]
    assert all(r.cut_step > 0 for r in records)
    first, second, third = records
    assert first.executed_bytes == 0 and first.cache_resident_layers == configs.get_config(ARCH).reduced().num_layers
    assert second.executed_bytes > 0 and third.executed_bytes > 0 and third.cache_resident_layers == 0
    # each record's planned bytes are the JAX planner's over the same state
    ref = jax_configs.get_config(ARCH).reduced()
    jspecs = JC.serve_state_specs(ref, N_SLOTS, MAX_SEQ, cache_dtype="float32", cross_len=FRAMES)
    for rec, (a, b) in zip(records, CHAIN):
        want = JC.serve_plan(ref, jspecs, *_pcs(a, b)[1])
        assert (rec.plan_network_bytes, rec.plan_local_bytes, rec.skipped_bytes) == (
            want.network_bytes, want.local_bytes, want.resident_bytes)


def test_demo_batch_and_serve_once_are_seeded():
    cfg = configs.get_config(ARCH).reduced()
    a, b = demo_batch(cfg, 2, 16, "cpu", frames_len=8), demo_batch(cfg, 2, 16, "cpu", frames_len=8)
    assert tuple(a["frames"].shape) == (2, 8, cfg.d_model) and a["frames"].dtype == torch.float32
    assert all(torch.equal(a[k], b[k]) for k in ("tokens", "frames"))
    out = serve_once(cfg, batch=2, prompt_len=16, gen=4, device="cpu", frames_len=8)
    again = serve_once(cfg, batch=2, prompt_len=16, gen=4, device="cpu", frames_len=8)
    assert out["tokens"].shape == (2, 5) and (out["tokens"] == again["tokens"]).all()
    assert out["tokens"].min() >= 0 and out["tokens"].max() < cfg.vocab_size


def test_controller_feeds_the_frames_of_its_data():
    """``data.SyntheticFrames``: each step's frames keyed on (seed, step),
    drawn the same however often, and fed by the controller in cfg.dtype;
    the tokens are SyntheticLM's."""
    cfg = configs.get_config(ARCH).reduced()
    data = SyntheticFrames(cfg.vocab_size, 16, 4, cfg.d_model, seed=3)
    a, b = data.frames_at(5, "cpu"), data.frames_at(5, "cpu")
    assert tuple(a.shape) == (4, 16, cfg.d_model) and a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, data.frames_at(6, "cpu"))
    assert not torch.equal(a, SyntheticFrames(cfg.vocab_size, 16, 4, cfg.d_model, seed=4).frames_at(5, "cpu"))
    np.testing.assert_array_equal(data.global_batch_at(5), SyntheticLM(cfg.vocab_size, 16, 4, seed=3).global_batch_at(5))
    ctrl = LiveRController(dataclasses.replace(cfg, dtype="bfloat16"), configs.ParallelConfig(dp=2, tp=2),
                           AdamWConfig(), seq_len=16, global_batch=4, data=data, device="cpu")
    ctrl.train_steps(2)
    batch = ctrl._batch()
    assert batch["frames"].dtype == torch.bfloat16
    assert torch.equal(batch["frames"], data.frames_at(2, "cpu").to(torch.bfloat16))


def test_serve_cli_runs_seamless_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
                                      "--frames-len", "8", "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    serve.main()
    out = capsys.readouterr().out
    assert "[prefill] 2x16 tokens" in out and "[decode] 4 steps x batch 2" in out


# ---------------------------------------------------------------------------
# Live-resized training
# ---------------------------------------------------------------------------


def test_streamed_resize_equals_the_unresized_run_bitwise():
    """Reduced seamless under ``LiveRController`` on zero frames (the
    frontend's stub): dp2tp2 -> dp2tp4 streamed with the split-step commit,
    then dp2tp4 -> dp1tp4 by stop-copy; the losses and every state tensor
    bit for bit those of a run never resized."""
    cfg = configs.get_config(ARCH).reduced()
    kw = dict(seq_len=16, global_batch=4, device="cpu")
    ctrl = LiveRController(cfg, configs.ParallelConfig(dp=2, tp=2), AdamWConfig(), stream_k=1, **kw)
    batch = ctrl._batch()
    assert tuple(batch["frames"].shape) == (4, 16, cfg.d_model) and not batch["frames"].any()
    losses = ctrl.train_steps(2)
    for target, overlap in ((configs.ParallelConfig(dp=2, tp=4), "stream"),
                            (configs.ParallelConfig(dp=1, tp=4), "stop_copy")):
        ctrl.request_resize(target, overlap=overlap)
        n = len(ctrl.records)
        while len(ctrl.records) == n:
            losses += ctrl.train_steps(1)
            assert len(losses) < 40, "the resize never committed"
    losses += ctrl.train_steps(2)
    assert [(r.mode, r.dst) for r in ctrl.records] == [("live_overlap", "dp2xpp1xtp4"), ("live", "dp1xpp1xtp4")]
    assert ctrl.records[0].executed_bytes > 0 and ctrl.records[1].executed_bytes == 0
    control = LiveRController(cfg, configs.ParallelConfig(dp=2, tp=2), AdamWConfig(), **kw)
    assert control.train_steps(len(losses)) == losses
    assert all(torch.isfinite(torch.tensor(losses)))
    got, _ = named_state_leaves(ctrl.params, ctrl.opt_state)
    want, _ = named_state_leaves(control.params, control.opt_state)
    assert sorted(got) == sorted(want) and any(n.startswith("params/encoder/") for n in got)
    for name, x in want.items():
        assert torch.equal(got[name], x), name
