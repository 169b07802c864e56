"""The per-rank step of dp x tp worlds (``distribution/{groups,tp,step}.py``
and the models' ``groups=`` paths) against the JAX package, in one gloo
world of 8 CPU rank processes.

Reduced qwen3-1.7b (4 layers, d_model 64, 4/2 heads of 16, vocab 512,
f32, TF32 off) from the JAX package's weights through
``models.convert.params_from_jax``; a batch of 4 x 32 tokens from a numpy
seed. On dp2tp2, dp1tp4 and dp2tp4 each rank computes its loss and
gradients on its shards and dp rows; assembled from the shards they are
held against ``jax.value_and_grad`` of the JAX ``loss_fn`` (the loss to
1e-6 of its value, each gradient leaf to 1e-5 of its largest entry, as
``tests/test_torch_model_archs.py``), and three AdamW steps against the
port's one-process step (within 1e-5: at a learning rate of 1e-4 the
steps move the params by about 3e-4; at 1e-3 Adam turned the gradients'
summation order into a difference of 5.4e-6). The world's
ranks run port code only: the JAX package is imported by the tests, not by
the module the rank processes load."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.resource_view import assemble, build_tensor_specs, view_of
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.attention import local_heads
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

WORLDS = [ParallelConfig(dp=2, tp=2), ParallelConfig(dp=1, tp=4), ParallelConfig(dp=2, tp=4)]
IDS = ["dp2tp2", "dp1tp4", "dp2tp4"]
BATCH, SEQ, STEPS = 4, 32, 3
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
STEP_TOL = 1e-5
OPT = AdamWConfig(learning_rate=1e-4, warmup_steps=2)


def _cfg():
    return get_config("qwen3-1.7b").reduced()


def _rank_program(rank: int, flat: dict, batches: list) -> dict:
    """Each world this rank belongs to: its loss, gradient shards and, after
    STEPS per-rank train steps, param shards; keyed by the world's index."""
    from repro_torch.distribution.groups import RankPool, make_world_groups
    from repro_torch.distribution.step import init_opt_state, make_grad_fn, make_train_step, shard_train_state

    cfg = _cfg()
    torch.backends.cuda.matmul.allow_tf32 = False
    groups = make_world_groups(RankPool(), WORLDS)
    out = {}
    for i, world in enumerate(WORLDS):
        g = groups[world]
        if not g.member:
            continue
        params = params_from_jax(flat, cfg, "cpu")
        params, opt = shard_train_state(cfg, params, init_opt_state(params), world, rank)
        rows = slice(g.dp_rank * BATCH // world.dp, (g.dp_rank + 1) * BATCH // world.dp)
        local = [{"tokens": torch.from_numpy(b[rows]).long()} for b in batches]
        loss, metrics, grads = make_grad_fn(cfg, groups=g)(params, local[0])
        step = make_train_step(cfg, OPT, groups=g)
        for b in local:
            params, opt, _ = step(params, opt, b)
        out[i] = {"loss": float(loss), "nll": float(metrics["nll"]), "grads": tree_paths(grads),
                  "params": tree_paths(params), "collectives": len(g.collectives)}
    return out


@pytest.fixture(scope="module")
def world():
    """The JAX reference, the one-process port and the 8-rank world's
    results, computed once."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    from repro.utils.pytree import tree_paths as jax_tree_paths
    from repro_torch.distribution.step import init_opt_state, make_train_step

    jcfg, cfg = jax_get_config("qwen3-1.7b").reduced(), _cfg()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    rng = np.random.default_rng(SEQ)
    batches = [rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32) for _ in range(STEPS)]
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(batches[0])}), has_aux=True
    ))(jparams)

    params = params_from_jax(flat, cfg, "cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, OPT)
    for b in batches:
        params, opt, _ = step(params, opt, {"tokens": torch.from_numpy(b).long()})

    ranks = run_ranks(_rank_program, 8, flat, batches, timeout=600)
    specs = {s.name[len("params/"):]: s for s in build_tensor_specs(cfg, include_optimizer=False)}
    return {
        "jax_loss": float(jloss), "jax_nll": float(jaux["nll"]),
        "jax_grads": {p: np.asarray(g) for p, g in jax_tree_paths(jgrads).items()},
        "one_process": {p: x.numpy() for p, x in tree_paths(params).items()},
        "ranks": ranks, "specs": specs,
    }


def _assembled(world, i: int, what: str) -> dict[str, np.ndarray]:
    par = WORLDS[i]
    return {p: assemble({r: world["ranks"][r][i][what][p] for r in range(par.world_size)}, spec, par).numpy()
            for p, spec in world["specs"].items()}


@pytest.mark.parametrize("i", range(len(WORLDS)), ids=IDS)
def test_rank_loss_and_grads_equal_jax(world, i):
    par = WORLDS[i]
    for r in range(par.world_size):
        res = world["ranks"][r][i]
        np.testing.assert_allclose(res["loss"], world["jax_loss"], rtol=LOSS_TOL, atol=0)
        np.testing.assert_allclose(res["nll"], world["jax_nll"], rtol=LOSS_TOL, atol=0)
        assert res["collectives"] > 0
    got = _assembled(world, i, "grads")
    assert sorted(got) == sorted(world["jax_grads"])
    for p, g in got.items():
        want = world["jax_grads"][p]
        np.testing.assert_allclose(g, want, atol=GRAD_TOL * np.abs(want).max(), rtol=0, err_msg=p)


@pytest.mark.parametrize("i", range(len(WORLDS)), ids=IDS)
def test_three_adamw_steps_equal_one_process(world, i):
    got = _assembled(world, i, "params")
    for p, want in world["one_process"].items():
        np.testing.assert_allclose(got[p], want, atol=STEP_TOL, rtol=0, err_msg=p)


def test_kv_heads_cut_mid_head(world):
    """At tp4 reduced qwen3's wk (64 x 32, 2 kv heads of 16) gives each rank
    8 columns, half a head; each rank's query head reads kv head rank // 2,
    and the assembled wk and wv gradients are JAX's."""
    cfg, i = _cfg(), IDS.index("dp1tp4")
    for r in range(4):
        wk = world["ranks"][r][i]["grads"]["blocks/pos0/mixer/wk"]
        assert tuple(wk.shape) == (cfg.num_layers, cfg.d_model, 8)
        assert local_heads(cfg, 4, r) == (r, 1, r // 2, 1)
    got = _assembled(world, i, "grads")
    for leaf in ("wk", "wv"):
        want = world["jax_grads"][f"blocks/pos0/mixer/{leaf}"]
        np.testing.assert_allclose(got[f"blocks/pos0/mixer/{leaf}"], want, atol=GRAD_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("i", range(len(WORLDS)), ids=IDS)
def test_norm_scales_split_on_embed(world, i):
    """The planner splits ln1, ln2 and final_norm's scales over tp; each rank
    holds d_model / tp of them and their gradients assemble to JAX's."""
    cfg, par = _cfg(), WORLDS[i]
    got = _assembled(world, i, "grads")
    for p in ("blocks/pos0/ln1/scale", "blocks/pos0/ln2/scale", "final_norm/scale"):
        assert world["specs"][p].roles[-1] == "tp"
        assert world["ranks"][0][i]["grads"][p].shape[-1] == cfg.d_model // par.tp
        want = world["jax_grads"][p]
        np.testing.assert_allclose(got[p], want, atol=GRAD_TOL * np.abs(want).max(), rtol=0, err_msg=p)


@pytest.mark.parametrize("i", range(len(WORLDS)), ids=IDS)
def test_qk_norm_grads_all_reduced_over_tp(world, i):
    """q_norm and k_norm are whole on every rank (role none) and each rank
    normalises only its heads: the all-reduce makes every rank's gradient
    the same, JAX's."""
    par = WORLDS[i]
    for leaf in ("q_norm", "k_norm"):
        p = f"blocks/pos0/mixer/{leaf}"
        assert world["specs"][p].roles == ("pp", "none")
        ranks = [world["ranks"][r][i]["grads"][p] for r in range(par.world_size)]
        assert all(torch.equal(ranks[0], x) for x in ranks[1:]), p
        want = world["jax_grads"][p]
        np.testing.assert_allclose(ranks[0].numpy(), want, atol=GRAD_TOL * np.abs(want).max(), rtol=0, err_msg=p)


def test_views_are_the_shards(world):
    """Each rank's shards are exactly its view_of boxes."""
    cfg = _cfg()
    for i, par in enumerate(WORLDS):
        for r in range(par.world_size):
            for p, x in world["ranks"][r][i]["params"].items():
                assert tuple(x.shape) == view_of(world["specs"][p], par, r).shape(), (par, r, p)
    assert cfg.num_kv_heads % 4 and not cfg.num_kv_heads % 2


def _refuse_tp3():
    from repro_torch.distribution.step import check_rank_model

    check_rank_model(_cfg(), ParallelConfig(tp=3))


def _refuse_mixtral_tp8():
    """Reduced mixtral's 4 query heads and 4 router columns (experts) do
    not split 8 ways."""
    from repro_torch.distribution.step import check_rank_model

    check_rank_model(get_config("mixtral-8x7b").reduced(), ParallelConfig(tp=8))


def _refuse_compression():
    """int8_ef has no per-rank update, nor does ``--nproc`` take it."""
    from repro_torch.core.mock_groups import MockGroups
    from repro_torch.distribution.step import make_update_fn

    make_update_fn(OPT, "int8_ef", groups=MockGroups(ParallelConfig(dp=2, tp=2), 0))


@pytest.mark.parametrize("bad", [_refuse_compression, _refuse_mixtral_tp8, _refuse_tp3],
                         ids=["int8_ef", "mixtral-tp8", "tp3"])
def test_rank_worlds_refuse_what_they_do_not_run(bad):
    with pytest.raises(ValueError):
        bad()


@pytest.mark.parametrize("par,batch,mb,want", [
    (ParallelConfig(dp=2, tp=2), 8, 2, 2),  # 4 rows a rank, in the 2 microbatches asked for
    (ParallelConfig(dp=2, tp=2), 4, 4, 2),  # 2 rows a rank: at most 2 microbatches
    (ParallelConfig(dp=4, tp=2), 4, 4, 1),  # 1 row a rank: one pass
    (ParallelConfig(pp=2, tp=2), 4, 1, 2),  # a pipeline world runs at least pp
], ids=["dp2tp2-mb2", "dp2tp2-rows2", "dp4tp2-rows1", "pp2tp2-mb1"])
def test_rank_worlds_step_in_their_microbatches(monkeypatch, par, batch, mb, want):
    """A per-rank world honours ``microbatches`` as far as its rows a rank
    go: the microbatches its step cuts the batch into, seen in the mock
    warm-up's one step on meta while the world is built."""
    from repro_torch.core.mock_groups import MockGroups
    from repro_torch.core.shadow import build_rank_world
    from repro_torch.distribution import pipeline, step

    seen, micro = [], step._micro
    for mod in (step, pipeline):
        monkeypatch.setattr(mod, "_micro", lambda b, n: seen.append(n) or micro(b, n))
    build_rank_world(_cfg(), par, OPT, batch, SEQ, MockGroups(par, 0), "cpu", mb)
    assert seen == ([want] if want > 1 else [])


def test_rank_worlds_refuse_rows_that_microbatches_do_not_divide():
    """6 rows a rank do not cut into 4 microbatches: the world is refused
    before it is built, not cut unevenly."""
    from repro_torch.core.mock_groups import MockGroups
    from repro_torch.core.shadow import build_rank_world, world_microbatches

    par = ParallelConfig(dp=2, tp=2)
    with pytest.raises(ValueError, match="not a multiple of microbatches=4"):
        world_microbatches(par, 4, 12)
    with pytest.raises(ValueError, match="not a multiple of microbatches=4"):
        build_rank_world(_cfg(), par, OPT, 12, SEQ, MockGroups(par, 0), "cpu", 4)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-2.7b", "seamless-m4t-large-v2"])
def test_rank_worlds_refuse_other_families(arch):
    from repro_torch.distribution.step import check_rank_model

    with pytest.raises(ValueError):
        check_rank_model(get_config(arch).reduced(), ParallelConfig(dp=2, tp=2))
