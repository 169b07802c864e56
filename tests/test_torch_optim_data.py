"""The port's optimizer, data pipeline and train step against the JAX
package's: ``SyntheticLM`` (a copy) gives the same tokens; ``cosine_lr``,
``global_norm`` and the clip give the same float32 values; one train step
of reduced qwen3-1.7b (and one with ``microbatches=2``) from the JAX
package's weights leaves the same params, ``mu``, ``nu`` and ``count`` as
``repro.distribution.step.make_train_step``. The copies of the generation
machine and the goodput ledger answer as their originals. Inputs come from
numpy seeds; TF32 is off."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import downtime as JD
from repro.core import generations as JG
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.distribution.step import make_train_step as jax_make_train_step
from repro.models import model as JM
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_lr as jax_cosine_lr
from repro.optim import global_norm as jax_global_norm
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch.configs import get_config
from repro_torch.core import downtime as D
from repro_torch.core import generations as G
from repro_torch.data import SyntheticLM
from repro_torch.distribution.step import make_grad_fn, make_train_step, make_update_fn
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_lr, global_norm, optimizer_logical_axes
from repro_torch.utils.pytree import tree_from_paths, tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(2)

# One AdamW step in float32: the same operations in the same order, but
# XLA fuses and vectorises them differently, and pow/cos/sqrt may differ by
# an ulp; an update of lr * m/(sqrt(v)+eps) ~ lr is then off by ~1e-7 lr.
STEP_TOL = 1e-6
# After a step from gradients that differ in their last bits (another
# summation order), Adam's m/(sqrt(v)+eps) turns an element whose gradient
# is near eps into a visibly different update, up to 2 lr (the reasoning
# of the JAX package's RESHAPE_PARITY_TOL, tests/conftest.py): all but a
# few elements in 10^4 must agree to STEP_TOL, and every one within 2 lr.
STRAY_SHARE = 1e-3
# a loss of ~6.8 summed in another order over 4 x 31 positions
LOSS_TOL = 2e-6


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["structured", "uniform"])
def test_synthetic_lm_copy_gives_the_same_tokens(mode):
    ours, theirs = SyntheticLM(512, 32, 8, seed=7, mode=mode), JaxSyntheticLM(512, 32, 8, seed=7, mode=mode)
    for step in (0, 3, 17):
        np.testing.assert_array_equal(ours.global_batch_at(step), theirs.global_batch_at(step))
        for dp in (1, 2, 4):
            for rank in range(dp):
                np.testing.assert_array_equal(ours.shard_at(step, rank, dp), theirs.shard_at(step, rank, dp))


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------


def test_cosine_lr_equals_jax():
    for kw in ({}, dict(learning_rate=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
               dict(warmup_steps=0, total_steps=5)):
        ours, theirs = AdamWConfig(**kw), JaxAdamWConfig(**kw)
        for step in (0, 1, 5, 9, 10, 11, 57, 100, 10_000, 20_000):
            got = cosine_lr(ours, torch.tensor(step, dtype=torch.int32))
            want = jax_cosine_lr(theirs, jnp.int32(step))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def _tree(rng, scale=1.0):
    return {"a": {"w": rng.normal(size=(6, 5)).astype(np.float32) * scale},
            "b": rng.normal(size=(7,)).astype(np.float32) * scale}


def test_global_norm_equals_jax():
    t = _tree(np.random.default_rng(0))
    got = global_norm(tree_from_paths({p: torch.from_numpy(x) for p, x in tree_paths(t).items()}))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_global_norm(t)), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 1e3], ids=["unclipped", "clipped"])
def test_adamw_update_equals_jax(grad_scale):
    """Three updates from the same grads: params, moments, count, lr and
    grad norm, with the clip off (norm < 1) and on (norm >> 1)."""
    rng = np.random.default_rng(1)
    p0, grads = _tree(rng), [_tree(rng, grad_scale) for _ in range(3)]
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    t = lambda tree: tree_from_paths({p: torch.from_numpy(x.copy()) for p, x in tree_paths(tree).items()})  # noqa: E731
    params, opt = t(p0), adamw_init(t(p0))
    jp, jo = p0, jax_adamw_init(p0)
    for g in grads:
        params, opt, m = adamw_update(AdamWConfig(**kw), t(g), opt, params)
        jp, jo, jm = jax_adamw_update(JaxAdamWConfig(**kw), g, jo, jp)
        np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(m["lr"].numpy(), np.asarray(jm["lr"]), rtol=1e-6)
    assert int(opt["count"]) == int(jo["count"]) == 3 and opt["count"].dtype == torch.int32
    for path, x in jax_tree_paths({"params": jp, "mu": jo["mu"], "nu": jo["nu"]}).items():
        coll, rest = path.split("/", 1)
        got = tree_paths(params if coll == "params" else opt[coll])[rest]
        np.testing.assert_allclose(got.numpy(), np.asarray(x), rtol=STEP_TOL, atol=STEP_TOL * 1e-2, err_msg=path)


def test_adamw_update_is_in_place_and_the_state_keeps_the_reference_paths():
    p = {"x": {"w": torch.ones(3)}}
    opt = adamw_init(p)
    ptr = (p["x"]["w"].data_ptr(), opt["mu"]["x"]["w"].data_ptr(), opt["nu"]["x"]["w"].data_ptr())
    params, opt2, _ = adamw_update(AdamWConfig(warmup_steps=0), {"x": {"w": torch.ones(3)}}, opt, p)
    assert params is p and opt2 is opt
    assert ptr == (p["x"]["w"].data_ptr(), opt["mu"]["x"]["w"].data_ptr(), opt["nu"]["x"]["w"].data_ptr())
    assert float(p["x"]["w"][0]) < 1.0
    jopt = jax_adamw_init({"x": {"w": jnp.ones(3)}})
    assert sorted(tree_paths(opt)) == sorted(jax_tree_paths(jopt))
    assert optimizer_logical_axes({"x": ("embed",)}) == {"mu": {"x": ("embed",)}, "nu": {"x": ("embed",)}, "count": ()}


# ---------------------------------------------------------------------------
# one train step of reduced qwen3-1.7b against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    cfg = get_config("qwen3-1.7b").reduced()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    return jcfg, cfg, jparams, flat, tokens


@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_train_step_equals_jax(reduced, microbatches):
    jcfg, cfg, jparams, flat, tokens = reduced
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    params = params_from_jax(flat, cfg, "cpu")
    opt = adamw_init(params)
    params, opt, m = make_train_step(cfg, AdamWConfig(**kw), microbatches)(
        params, opt, {"tokens": torch.from_numpy(tokens).long()}
    )
    step = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**kw), microbatches))
    jp, jo, jm = step(jparams, jax_adamw_init(jparams), {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jm["grad_norm"]), rtol=1e-5)
    assert int(opt["count"]) == int(jo["count"]) == 1
    for path, x in tree_paths(params).items():
        diff = np.abs(x.numpy() - np.asarray(jax_tree_paths(jp)[path]))
        assert diff.max() <= 2 * kw["learning_rate"], (path, diff.max())
        assert (diff > STEP_TOL).mean() <= STRAY_SHARE, (path, (diff > STEP_TOL).mean())
    for coll in ("mu", "nu"):
        want = jax_tree_paths(jo[coll])
        for path, x in tree_paths(opt[coll]).items():
            ref = np.asarray(want[path])
            # (1-b1) g and (1-b2) g^2 from grads that agree to ~1e-6 relative
            np.testing.assert_allclose(x.numpy(), ref, rtol=1e-4, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"{coll}/{path}")


def test_microbatched_grads_are_the_mean_of_the_halves(reduced):
    _, cfg, _, flat, tokens = reduced
    params = params_from_jax(flat, cfg, "cpu")
    batch = torch.from_numpy(tokens).long()
    loss, _, grads = make_grad_fn(cfg, microbatches=2)(params, {"tokens": batch})
    halves = [make_grad_fn(cfg)(params, {"tokens": batch[i * 2 : (i + 1) * 2]}) for i in range(2)]
    assert float(loss) == pytest.approx((float(halves[0][0]) + float(halves[1][0])) / 2, rel=1e-6)
    for path, g in tree_paths(grads).items():
        want = (tree_paths(halves[0][2])[path] + tree_paths(halves[1][2])[path]) / 2
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="multiple of microbatches"):
        make_grad_fn(cfg, microbatches=3)(params, {"tokens": batch})


def test_gradient_compression_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        make_update_fn(AdamWConfig(), compression="int8_ef")


# ---------------------------------------------------------------------------
# copies: the generation machine and the goodput ledger
# ---------------------------------------------------------------------------


def test_generation_machine_copy_walks_the_same_states():
    ours, theirs = G.GenerationMachine(), JG.GenerationMachine()
    trace = []
    for m, mod in ((ours, G), (theirs, JG)):
        gen = m.begin_prepare("a")
        m.mark_ready(gen.gen_id, payload=1)
        m.begin_switch(gen.gen_id)
        m.commit_switch(gen.gen_id)
        states = [m.state.value]
        m.finish_cleanup()
        states.append(m.state.value)
        gen2 = m.begin_prepare("b")
        m.cancel()
        states.append(m.state.value)
        errors = []
        for bad in (lambda: m.mark_ready(gen2.gen_id + 1), lambda: m.begin_switch(gen2.gen_id)):
            with pytest.raises((mod.InvalidTransition, mod.StaleGeneration)) as err:
                bad()
            errors.append(type(err.value).__name__)
        trace.append((states, errors, m.active.gen_id))
    assert trace[0] == trace[1]


def test_goodput_ledger_copy_counts_the_same():
    ours, theirs = D.GoodputLedger(), JD.GoodputLedger()
    for ledger in (ours, theirs):
        ledger.record(0.0, 2.0, "train", 4)
        ledger.record(2.0, 2.5, "pause", 8)
        ledger.record(2.5, 3.0, "reshard_overlap", 4)
        ledger.record(3.0, 4.0, "train", 8)
    assert ours.goodput == theirs.goodput
    assert ours.pause_seconds == theirs.pause_seconds
    assert ours.gpu_seconds() == theirs.gpu_seconds()
