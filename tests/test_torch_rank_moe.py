"""Per-rank worlds with expert parallelism (``models/moe.py::
moe_apply_rank`` over ``distribution/groups.py``'s ep and tp groups), in
one gloo world of 8 CPU rank processes.

Reduced mixtral-8x7b (4 layers of 4 experts, top-2, f32, TF32 off) at a
capacity factor of 1, so that capacity drops pairs; weights from the JAX
package through ``models.convert.params_from_jax``, a batch of 8 x 32
tokens from a numpy seed:

- on ep2tp2, ep4, tp4 and dp2ep2tp2 every rank computes its loss and
  gradients on its shards and dp rows; the loss, its nll and aux terms
  and the gradients assembled from the shards are held against
  ``jax.value_and_grad`` of the JAX ``loss_fn`` (its aux weight 0.01) and
  against the port's one process, to ``tests/test_torch_model_archs.py``'s
  limits; every rank routes the same pairs, and keeps and drops the same
  ones, as one process does; the router's gradient is the same on every
  rank of an ep group;
- pp2ep2 (the pipeline, aux weight 0) against the port's one-process pp2
  world;
- the clip's norm, summed over pp, ep and tp, against one process's;
- the mock process groups on an ep rank and on a pp x ep rank, op for op
  against the real world's;
- the JAX package's transition (``tests/test_system.py``) dp2tp2ep2 ->
  dp1tp2ep4 through ``RankExecutor`` against the JAX byte oracle, and
  ``RankController`` streamed to it (split-step commit) and back by
  stop-copy, bitwise a control that takes the same worlds' steps, near a
  one-process run never resized (``tests/test_torch_rank_pipeline.py``'s
  checks)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig as P
from repro_torch.core.resource_view import build_tensor_specs, view_of
from repro_torch.launch.ranks import run_ranks
from repro_torch.optim import AdamWConfig
from repro_torch.utils.pytree import tree_paths
from test_torch_rank_pipeline import (
    assembled,
    check_against_jax_oracle,
    check_resize_run,
    oracle_case,
    param_specs,
    rank_steps,
    resize_run,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

ARCH = "mixtral-8x7b"
FACTOR = 1.0  # capacity 16 of a row's 64 (token, choice) pairs an expert: some drop
BATCH, SEQ = 8, 32
STEP_WORLDS = [P(ep=2, tp=2), P(ep=4), P(tp=4), P(dp=2, ep=2, tp=2), P(pp=2, ep=2)]
IDS = ["ep2tp2", "ep4", "tp4", "dp2ep2tp2", "pp2ep2"]
DENSE = range(4)  # the worlds without pipeline stages
SRC, DST = P(dp=2, tp=2, ep=2), P(tp=2, ep=4)
LOSS_TOL = 1e-6  # tests/test_torch_model_archs.py's
GRAD_TOL = 1e-5
NORM_TOL = 1e-6
OPT = AdamWConfig(learning_rate=1e-3, warmup_steps=2)
RUN = dict(before=2, between=2, after=2, stream_k=1)


def _cfg():
    return dataclasses.replace(get_config(ARCH).reduced(), moe_capacity_factor=FACTOR)


class _Keeps:
    """Records the keep mask of every ``moe.route`` call while installed."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.orig, self.keeps = moe, moe.route, []

    def __call__(self, probs, cfg):
        out = self.orig(probs, cfg)
        self.keeps.append(out[3].clone())
        return out

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def take(self) -> list:
        out, self.keeps = self.keeps, []
        return out


def _rank_program(rank: int, flat: dict, tokens: np.ndarray, state: dict) -> dict:
    from repro_torch.distribution.groups import RankPool, make_world_groups

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg()
    pool = RankPool()
    groups = make_world_groups(pool, STEP_WORLDS + [SRC, DST])
    specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
    with _Keeps() as keeps:
        steps = rank_steps(cfg, STEP_WORLDS, groups, rank, flat, tokens, OPT, microbatches=1, probe=keeps.take)
    return {"steps": steps, "oracle": oracle_case(rank, pool, specs, SRC, DST, state),
            "run": resize_run(rank, pool, groups, cfg, SRC, DST, RUN, BATCH, SEQ, 1, OPT)}


@pytest.fixture(scope="module")
def world():
    """The JAX reference, the one-process port and the 8-rank world's
    results, computed once."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    from repro.utils.pytree import tree_paths as jax_tree_paths
    from repro_torch.distribution.pipeline import make_pipeline_grad_fn
    from repro_torch.distribution.step import make_grad_fn
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import global_norm

    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), moe_capacity_factor=FACTOR)
    cfg = _cfg()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}), has_aux=True))(jparams)

    batch = {"tokens": torch.from_numpy(tokens).long()}
    with _Keeps() as keeps:
        loss, metrics, grads = make_grad_fn(cfg)(params_from_jax(flat, cfg, "cpu"), batch)
    pp_loss, _, pp_grads = make_pipeline_grad_fn(cfg, P(pp=2), 2)(params_from_jax(flat, cfg, "cpu"), batch)

    specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
    rng = np.random.default_rng(5)
    state = {s.name: rng.normal(size=s.shape).astype(s.dtype) for s in specs}
    ranks = run_ranks(_rank_program, 8, flat, tokens, state, timeout=600)
    return {
        "jax": {"loss": float(jloss), "nll": float(jaux["nll"]), "moe_aux": float(jaux["moe_aux"]),
                "grads": {p: np.asarray(g) for p, g in jax_tree_paths(jgrads).items()}},
        "one": {"loss": float(loss), **{k: float(v) for k, v in metrics.items()},
                "grads": {p: g.numpy() for p, g in tree_paths(grads).items()}, "keeps": keeps.take(),
                "norm": float(global_norm(grads))},
        "one_pp": {"loss": float(pp_loss), "grads": {p: g.numpy() for p, g in tree_paths(pp_grads).items()},
                   "norm": float(global_norm(pp_grads))},
        "state": state, "ranks": ranks,
    }


@pytest.mark.parametrize("i", DENSE, ids=IDS[:4])
def test_expert_ranks_equal_jax(world, i):
    par = STEP_WORLDS[i]
    for r in range(par.world_size):
        res = world["ranks"][r]["steps"][i]
        for ref in (world["jax"], world["one"]):
            np.testing.assert_allclose(res["loss"], ref["loss"], rtol=LOSS_TOL, atol=0)
            for k in ("nll", "moe_aux"):
                np.testing.assert_allclose(res["metrics"][k], ref[k], rtol=LOSS_TOL, atol=0, err_msg=k)
    got = assembled(world["ranks"], i, par, param_specs(_cfg()))
    assert sorted(got) == sorted(world["jax"]["grads"])
    for p, g in got.items():
        for ref in (world["jax"], world["one"]):
            want = ref["grads"][p]
            np.testing.assert_allclose(g, want, atol=GRAD_TOL * np.abs(want).max(), rtol=0, err_msg=p)


@pytest.mark.parametrize("i", DENSE, ids=IDS[:4])
def test_expert_ranks_drop_the_pairs_one_process_drops(world, i):
    """Each route call of the step (forward and rematerialised, layer by
    layer) keeps the same pairs on every rank as on one process, and
    capacity drops some."""
    par, want = STEP_WORLDS[i], world["one"]["keeps"]
    assert len(want) == 2 * _cfg().num_layers and not all(bool(k.all()) for k in want)
    for r in range(par.world_size):
        got = world["ranks"][r]["steps"][i]["probe"]
        dp, b = par.rank_coords(r)[0], BATCH // par.dp
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w[dp * b:(dp + 1) * b]), r


@pytest.mark.parametrize("i", DENSE, ids=IDS[:4])
def test_experts_cut_by_ep_and_router_whole_on_every_rank(world, i):
    par, specs = STEP_WORLDS[i], param_specs(_cfg())
    e = _cfg().num_experts
    for r in range(par.world_size):
        grads = world["ranks"][r]["steps"][i]["grads"]
        for p, g in grads.items():
            assert tuple(g.shape) == view_of(specs[p], par, r).shape(), (r, p)
        assert grads["blocks/pos0/mlp/wi_gate"].shape[1] == e // par.ep
    # the ranks of an ep group (same dp, pp and tp coordinates) hold the same router gradient
    for r in range(par.world_size):
        dp, pp, _, tp = par.rank_coords(r)
        first = par.coords_rank(dp, pp, 0, tp)
        assert torch.equal(world["ranks"][r]["steps"][i]["grads"]["blocks/pos0/mlp/router"],
                           world["ranks"][first]["steps"][i]["grads"]["blocks/pos0/mlp/router"]), r


def test_pp_ep_world_equals_one_process(world):
    i, par, ref = 4, STEP_WORLDS[4], world["one_pp"]
    for r in range(par.world_size):
        np.testing.assert_allclose(world["ranks"][r]["steps"][i]["loss"], ref["loss"], rtol=LOSS_TOL, atol=0)
    got = assembled(world["ranks"], i, par, param_specs(_cfg()))
    for p, g in got.items():
        want = ref["grads"][p]
        np.testing.assert_allclose(g, want, atol=GRAD_TOL * np.abs(want).max(), rtol=0, err_msg=p)


@pytest.mark.parametrize("i", range(len(STEP_WORLDS)), ids=IDS)
def test_clip_norm_counts_each_element_once(world, i):
    par = STEP_WORLDS[i]
    want = world["one_pp" if par.pp > 1 else "one"]["norm"]
    norms = [world["ranks"][r]["steps"][i]["norm"] for r in range(par.world_size)]
    assert len(set(norms)) == 1
    np.testing.assert_allclose(norms[0], want, rtol=NORM_TOL)


@pytest.mark.parametrize("i,rank", [(0, 1), (4, 2)], ids=["ep2tp2-rank1", "pp2ep2-rank2"])
def test_mock_collectives_equal_an_expert_ranks(world, i, rank):
    from repro_torch.core.mock_groups import mock_warmup
    from repro_torch.core.shadow import rank_meta_args, rank_step_fns

    cfg, par = _cfg(), STEP_WORLDS[i]
    mock = mock_warmup(lambda g: rank_step_fns(cfg, par, OPT, 1, g)[0], par, rank,
                       rank_meta_args(cfg, par, rank, BATCH, SEQ))
    real = world["ranks"][rank]["steps"][i]["collectives"]
    assert mock.collectives == real
    assert ("all_reduce_sum", "ep") in {(op, g) for op, g, _ in real}


def test_rank_executor_moves_the_jax_oracles_bytes(world):
    from repro.configs import get_config as jax_get_config
    from repro.core.resource_view import build_tensor_specs as jax_specs

    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), moe_capacity_factor=FACTOR)
    jspecs = jax_specs(jcfg, include_optimizer=True, zero_sharding=False)
    check_against_jax_oracle(world["ranks"], "oracle", jspecs, SRC, DST, world["state"])


def test_resize_across_ep_rank_to_rank(world):
    from repro.configs import get_config as jax_get_config
    from repro.core.resource_view import build_tensor_specs as jax_specs

    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), moe_capacity_factor=FACTOR)
    jspecs = jax_specs(jcfg, include_optimizer=True, zero_sharding=False)
    check_resize_run(world["ranks"], SRC, DST, _cfg(), jspecs, 1)
