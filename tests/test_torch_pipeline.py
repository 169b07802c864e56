"""Pipeline stages in the port (``distribution/pipeline.py``) on the CPU at
the reduced sizes:

- the pipelined loss and its gradients (pp2, 4 microbatches, batch 8 x 32)
  against ``jax.value_and_grad`` of the JAX package's
  ``make_pipeline_loss`` on a mesh of 2 host devices, for qwen3 and
  mixtral, from the same weights (the JAX side runs in one subprocess);
- mamba2 pp2 against the port's own dense step (the JAX package pins SSM
  worlds to tp-only layouts, so it has no pipelined SSM step to hold it
  to), and the pipelined loss equal to the dense one where no MoE aux
  term is dropped;
- the refusals: an enc-dec model, ``int8_ef`` with ``pp > 1`` (also by the
  training CLI), stages that do not divide the periods, too few
  microbatches;
- ``LiveRController`` through dp2tp2 -> pp2tp2 (streamed, split-step
  commit: the old world's dense gradients, the update on the pp world) ->
  pp4tp1 (stop-copy), its params bitwise those of a control that takes
  the same worlds at the same steps and carries the state by plain tensor
  copies.

Inputs come from numpy seeds; TF32 is off."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig as P
from repro_torch.core.controller import LiveRController
from repro_torch.core.shadow import build_train_world
from repro_torch.data import SyntheticLM
from repro_torch.distribution.pipeline import check_pipeline, make_pipeline_grad_fn, make_pipeline_train_step
from repro_torch.distribution.step import init_opt_state, init_train_state, make_grad_fn
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.utils.pytree import tree_from_paths, tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

# the loss: a mean over 4 microbatches x 2 x 31 positions of ~6.8, summed
# in another order
LOSS_TOL = 1e-6
# each gradient leaf, relative to its largest entry: sums over 256
# positions and 4 layers in another order
GRAD_TOL = 1e-5
PIPE = dict(pp=2, microbatches=4, batch=8, seq=32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-1.7b", "mixtral-8x7b")

JAX_SIDE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.distribution.pipeline import make_pipeline_loss
from repro.distribution.sharding import make_elastic_mesh
from repro.models import model as M
from repro.utils.pytree import tree_paths

out_dir, pipe = sys.argv[1], json.loads(sys.argv[2])
parallel = ParallelConfig(pp=pipe["pp"])
mesh = make_elastic_mesh(parallel)
for arch in pipe["archs"]:
    cfg = get_config(arch).reduced()
    params = jax.jit(M.init_params, static_argnums=0)(cfg, jax.random.key(0))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (pipe["batch"], pipe["seq"])).astype(np.int32)
    loss_fn = make_pipeline_loss(cfg, parallel, pipe["microbatches"], mesh)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jnp.asarray(toks))))(params)
    flat = {"loss": np.asarray(loss), "tokens": toks}
    flat.update({"param/" + p: np.asarray(x) for p, x in tree_paths(params).items()})
    flat.update({"grad/" + p: np.asarray(x) for p, x in tree_paths(grads).items()})
    np.savez(f"{out_dir}/{arch}.npz", **flat)
"""


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    """The JAX pipeline's loss and gradients of each arch, with its weights
    and tokens, from one subprocess with 2 host devices."""
    out = tmp_path_factory.mktemp("jax_pipeline")
    arg = json.dumps({**PIPE, "archs": ARCHS})
    run_with_devices(f"import sys; sys.argv = ['-', {str(out)!r}, {arg!r}]\n" + JAX_SIDE, n_devices=2, timeout=600)
    got = {}
    for arch in ARCHS:
        with np.load(out / f"{arch}.npz") as z:
            got[arch] = {k: z[k] for k in z.files}
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_pipelined_loss_and_grads_equal_jax(jax_pipeline, arch):
    ref = jax_pipeline[arch]
    cfg = get_config(arch).reduced()
    params = params_from_jax({k[6:]: v for k, v in ref.items() if k.startswith("param/")}, cfg, "cpu")
    grad_step = make_pipeline_grad_fn(cfg, P(pp=PIPE["pp"]), PIPE["microbatches"])
    loss, metrics, grads = grad_step(params, {"tokens": torch.from_numpy(ref["tokens"]).long()})
    assert metrics == {}
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=LOSS_TOL)
    for path, g in tree_paths(grads).items():
        want = ref[f"grad/{path}"]
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=GRAD_TOL * np.abs(want).max(), err_msg=path)


def _reduced(arch: str):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 32))).long()
    return cfg, params, tokens


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "qwen3-1.7b"])
def test_pipelined_grads_equal_the_dense_step(arch):
    """No MoE aux term to drop: the pipelined step is the dense step's
    ``scan_loss`` exactly, and its gradients are the explicit
    accumulation's to float32 rounding."""
    cfg, params, tokens = _reduced(arch)
    batch = {"tokens": tokens}
    loss, _, grads = make_pipeline_grad_fn(cfg, P(pp=2), 4)(params, batch)
    s_loss, _, s_grads = make_grad_fn(cfg, 4, grad_accum="scan_loss")(params, batch)
    e_loss, _, e_grads = make_grad_fn(cfg, 4)(params, batch)
    assert float(loss) == float(s_loss)
    np.testing.assert_allclose(float(loss), float(e_loss), rtol=LOSS_TOL)
    for path, g in tree_paths(grads).items():
        torch.testing.assert_close(g, tree_paths(s_grads)[path], rtol=0, atol=0)
        want = tree_paths(e_grads)[path]
        torch.testing.assert_close(g, want, rtol=0, atol=GRAD_TOL * float(want.abs().max()))


def test_pipeline_leaves_out_the_moe_aux_loss():
    cfg, params, tokens = _reduced("mixtral-8x7b")
    pipe, _, _ = make_pipeline_grad_fn(cfg, P(pp=2), 2)(params, {"tokens": tokens})
    halves = [M.loss_fn(cfg, params, {"tokens": tokens[i * 4 : (i + 1) * 4]})[1] for i in range(2)]
    assert float(halves[0]["moe_aux"]) > 0
    np.testing.assert_allclose(float(pipe), (float(halves[0]["nll"]) + float(halves[1]["nll"])) / 2, rtol=LOSS_TOL)


def test_pipeline_refusals():
    cfg = get_config("qwen3-1.7b").reduced()
    opt = AdamWConfig()
    with pytest.raises(ValueError, match="decoder-only"):
        check_pipeline(get_config("seamless-m4t-large-v2").reduced(), P(pp=2), 2)
    with pytest.raises(ValueError, match="error-feedback"):
        make_pipeline_train_step(cfg, P(pp=2), opt, 2, compression="int8_ef")
    with pytest.raises(ValueError, match="error-feedback"):
        build_train_world(cfg, P(pp=2), opt, 8, 32, devices=["cpu"] * 2, compression="int8_ef")
    with pytest.raises(ValueError, match="multiple of pp=3"):
        make_pipeline_grad_fn(cfg, P(pp=3), 3)
    with pytest.raises(ValueError, match="never fills"):
        make_pipeline_grad_fn(cfg, P(pp=2), 1)
    # a world takes max(microbatches, pp) microbatches, as the JAX package
    # builds it, and the controller refuses at the request what the
    # pipeline refuses
    world = build_train_world(cfg, P(pp=4), opt, 8, 32, microbatches=1, devices=["cpu"] * 4)
    params = M.init_params(cfg, device="cpu")
    _, _, m = world.step_fn(params, init_opt_state(params), {"tokens": torch.zeros(8, 32, dtype=torch.long)})
    assert np.isfinite(float(m["loss"]))
    ctrl = LiveRController(cfg, P(dp=2, tp=2), opt, 32, 8, device="cpu", compression="int8_ef")
    with pytest.raises(ValueError, match="error-feedback"):
        ctrl.request_resize(P(pp=2, tp=2))
    assert not ctrl.reconfig_pending


def _schedule_run(cfg, opt, kw, plan):
    """The control: the worlds of ``plan`` (``[(steps, parallel), ...]``),
    each built by ``build_train_world`` and its step run for ``steps`` on
    the controller's data, the state handed from one world to the next by
    plain tensor copies."""
    params, opt_state = init_train_state(cfg, 0, "none", "cpu")
    data = SyntheticLM(cfg.vocab_size, kw["seq_len"], kw["global_batch"], 0)
    losses = []
    for steps, parallel in plan:
        world = build_train_world(cfg, parallel, opt, kw["global_batch"], kw["seq_len"],
                                  devices=["cpu"] * parallel.world_size)
        params = tree_from_paths({p: x.clone() for p, x in tree_paths(params).items()})
        opt_state = tree_from_paths({p: x.clone() for p, x in tree_paths(opt_state).items()})
        for _ in range(steps):
            batch = {"tokens": torch.from_numpy(data.global_batch_at(len(losses))).long()}
            params, opt_state, m = world.step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))
    return params, losses


def test_controller_resizes_into_and_out_of_pp_bitwise():
    cfg = get_config("qwen3-1.7b").reduced()
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2)
    kw = dict(seq_len=32, global_batch=8)
    ctrl = LiveRController(cfg, P(dp=2, tp=2), opt, device="cpu", overlap="stream", stream_k=2, **kw)
    losses = ctrl.train_steps(2)
    ctrl.request_resize(P(pp=2, tp=2))
    ctrl.wait_shadow_ready(60)
    while not ctrl.records:
        losses += ctrl.train_steps(1)
    streamed_at = ctrl.step  # the split step ran on dp2tp2's gradients
    ctrl.request_resize(P(pp=4, tp=1), overlap="stop_copy")
    ctrl.wait_shadow_ready(60)
    losses += ctrl.train_steps(1)  # the stop-copy commits at this boundary
    stopped_at = ctrl.step
    losses += ctrl.train_steps(2)
    recs = [(r.mode, r.src, r.dst) for r in ctrl.records]
    assert recs == [("live_overlap", "dp2xpp1xtp2", "dp1xpp2xtp2"), ("live", "dp1xpp2xtp2", "dp1xpp4xtp1")]
    assert all(r.executed_bytes > 0 for r in ctrl.records)
    assert stopped_at == streamed_at + 1
    plan = [(streamed_at, P(dp=2, tp=2)), (stopped_at - streamed_at, P(pp=2, tp=2)),
            (ctrl.step - stopped_at, P(pp=4, tp=1))]
    params, c_losses = _schedule_run(cfg, opt, kw, plan)
    assert c_losses == losses
    for path, x in tree_paths(params).items():
        assert torch.equal(x, tree_paths(ctrl.params)[path]), path


def test_train_cli_refuses_int8_ef_with_pipeline_stages():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
           "--pp", "2", "--compression", "int8_ef", "--steps", "2", "--seq", "32", "--batch", "8"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 2 and "error-feedback" in res.stderr and "Traceback" not in res.stderr
