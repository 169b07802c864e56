"""The port's MoE MLP (``models/moe.py``) against the JAX package's
(``repro/models/moe.py``): ``moe_apply`` and ``moe_aux_loss``, their values
and their gradients (``jax.grad`` against autograd, for every parameter
and the input), and the (token, choice) pairs that capacity drops, on
reduced mixtral-8x7b (8 experts at full size, top-2) and
llama4-scout-17b-a16e (top-1 and a shared expert).

Cases: the reduced configs' capacity factor (``num_experts``: nothing is
dropped), the full configs' 1.25 (pairs dropped), a zero router (every
probability equal: each token picks experts ``0..k-1``, the ties broken
toward the lower index as ``jax.lax.top_k`` breaks them, and capacity
drops the rest) and ``s = 1`` (a decode step). The JAX package's weights
are carried over as numpy arrays; inputs are drawn with numpy from a seed;
TF32 off."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as JMOE
from repro.utils.pytree import tree_from_paths as jax_tree_from_paths
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.utils.pytree import tree_from_paths, tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
# (case, capacity factor or None for the reduced config's, sequence length)
CASES = [("no_drop", None, 48), ("drops", 1.25, 48), ("zero_router", 1.25, 48), ("decode", None, 1)]
OUT_TOL = 1e-6  # relative to the output's largest entry
GRAD_TOL = 1e-5  # each gradient leaf relative to its largest entry


def _setup(arch: str, case: str, factor):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
    init, _ = JMOE.moe_init(jax.random.key(len(arch)), jcfg, jnp.float32)
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(init).items()}
    if case == "zero_router":
        flat["router"] = np.zeros_like(flat["router"])
    jparams = jax_tree_from_paths({p: jnp.asarray(x) for p, x in flat.items()}, init)
    return jcfg, cfg, jparams, flat


def _torch_params(flat: dict) -> dict:
    return tree_from_paths({p: torch.from_numpy(x.copy()).requires_grad_(True) for p, x in flat.items()})


def _jax_keep(params, cfg, x) -> np.ndarray:
    """The JAX package's keep mask (b, s, k), by its own expressions
    (``repro/models/moe.py:46-62``)."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    capacity = max(1, int(cfg.moe_capacity_factor * k * s / e))
    probs = jax.nn.softmax((x @ params["router"].astype(x.dtype)).astype(jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(b, s * k, e)
    pos = jnp.einsum("bske,bske->bsk", (jnp.cumsum(flat, axis=1) - flat).reshape(b, s, k, e), onehot)
    return np.asarray(pos < capacity), np.asarray(gate_idx)


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    w = np.asarray(want)
    assert tuple(got.shape) == w.shape, what
    np.testing.assert_allclose(got.detach().numpy(), w, atol=tol * max(np.abs(w).max(), 1e-30), rtol=0, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case,factor,s", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_and_aux_equal_jax(arch, case, factor, s):
    jcfg, cfg, jparams, flat = _setup(arch, case, factor)
    rng = np.random.default_rng(s + len(arch))
    x = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)

    # the same (token, choice) pairs routed, and dropped
    keep, idx = _jax_keep(jparams, jcfg, jnp.asarray(x))
    gates, gate_idx, slot, got_keep, capacity = MOE.routing(_torch_params(flat), cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(gate_idx.numpy(), idx)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    assert capacity == max(1, int(cfg.moe_capacity_factor * cfg.experts_per_token * s / cfg.num_experts))
    assert (gates.detach().numpy()[~keep] == 0).all()
    dropped = int((~keep).sum())
    if case in ("no_drop", "decode"):
        assert dropped == 0
    else:
        assert dropped > 0
    if case == "zero_router":
        k = cfg.experts_per_token
        assert (idx == np.arange(k)).all()  # ties to the lower expert index
        # each of the k experts takes `capacity` tokens of a row, in order
        assert (keep.sum(axis=1) == min(capacity, s)).all() and keep[:, :capacity].all()

    def jax_objective(p, xx):
        y = JMOE.moe_apply(p, jcfg, xx)
        return jnp.sum(y * cot), (y, JMOE.moe_aux_loss(p, jcfg, xx))

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jax_objective, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))
    jga = jax.grad(lambda p: JMOE.moe_aux_loss(p, jcfg, jnp.asarray(x)))(jparams)

    params = _torch_params(flat)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    y = MOE.moe_apply(params, cfg, tx)
    aux = MOE.moe_aux_loss(params, cfg, tx)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    _close(y, jy, OUT_TOL, "moe_apply")
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=OUT_TOL, atol=0)

    leaves = tree_paths(params)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [*leaves.values(), tx], allow_unused=True)
    want = jax_tree_paths(jgp)
    for (path, leaf), g in zip(leaves.items(), grads):
        g = torch.zeros_like(leaf) if g is None else g
        if path == "router" and cfg.experts_per_token == 1:
            # top-1: every gate is v / v = 1, so the router has no gradient
            # through moe_apply; both packages give roundoff, held to the
            # input gradient's scale
            scale = np.abs(np.asarray(jgx)).max()
            assert np.abs(np.asarray(want[path])).max() <= GRAD_TOL * scale
            assert g.abs().max().item() <= GRAD_TOL * scale
            continue
        _close(g, want[path], GRAD_TOL, f"d moe_apply / {path}")
    _close(grads[-1], jgx, GRAD_TOL, "d moe_apply / x")
    aux_grads = torch.autograd.grad(MOE.moe_aux_loss(params, cfg, torch.from_numpy(x)), list(leaves.values()),
                                    allow_unused=True)
    want = jax_tree_paths(jga)
    for (path, leaf), g in zip(leaves.items(), aux_grads):
        g = torch.zeros_like(leaf) if g is None else g
        _close(g, want[path], GRAD_TOL, f"d moe_aux_loss / {path}")


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3], [0.4, 0.1, 0.4, 0.1]])
    vals, idx = MOE.top_k(probs, 2)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    assert idx.tolist() == [[0, 1], [1, 2], [0, 2]]


def test_init_axes_and_the_served_cast():
    """The port's init has the JAX package's paths, shapes and axes; drawn
    with a served dtype, it is the bits of the float32 draw cast after."""
    for arch in ARCHS:
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        jp, jaxes = JMOE.moe_init(jax.random.key(0), jcfg, jnp.float32)
        ours = tree_paths(MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu"))
        assert {p: tuple(x.shape) for p, x in ours.items()} == {p: x.shape for p, x in jax_tree_paths(jp).items()}
        assert tree_paths(MOE.moe_axes(cfg)) == jax_tree_paths(jaxes, is_leaf=lambda a: isinstance(a, tuple))
        d = cfg.d_model
        assert abs(ours["wi_gate"].std().item() - d**-0.5) < 0.1 * d**-0.5
        assert abs(ours["wo"].std().item() - cfg.d_ff**-0.5) < 0.1 * cfg.d_ff**-0.5

        served = MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu", (2,),
                              cast=lambda tree: M.cast_params(tree, torch.bfloat16))
        full = MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu", (2,))
        for path, x in tree_paths(served).items():
            assert x.dtype == torch.bfloat16 and torch.equal(x, tree_paths(full)[path].to(torch.bfloat16)), path


def _boolean_mask_dispatch(params, cfg, x) -> torch.Tensor:
    """The slot table as the port wrote it before its dispatch dropped the
    boolean-mask index: ``src[flat[keep]] = rows[keep]``."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    _, gate_idx, slot, keep, c = MOE.routing(params, cfg, x)
    rows = torch.arange(b * s).reshape(b, s, 1).expand(b, s, k)
    flat = (gate_idx * b + torch.arange(b).reshape(b, 1, 1)) * c + slot
    src = torch.full((e * b * c,), b * s, dtype=torch.long)
    src[flat[keep]] = rows[keep]
    return src


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case,factor,s", CASES, ids=[c[0] for c in CASES])
def test_dispatch_without_a_boolean_index_is_the_same_table(arch, case, factor, s):
    """The dispatch writes every pair at ``where(keep, slot, e*b*c)`` into
    a table one slot longer and cuts the last: the kept pairs' slots are
    distinct, so the gathered rows, and so ``moe_apply``'s bits, are those
    of the boolean-mask form (whose values against the JAX package
    ``test_moe_apply_and_aux_equal_jax`` holds)."""
    _, cfg, _, flat = _setup(arch, case, factor)
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((3, s, cfg.d_model)).astype(np.float32))
    params = _torch_params(flat)
    want = _boolean_mask_dispatch(params, cfg, x)
    seen = []
    orig = torch.Tensor.__getitem__

    def spy(self, idx):
        if isinstance(idx, torch.Tensor) and self.dim() == 2 and idx.dtype == torch.long and not seen:
            seen.append(idx.clone())
        return orig(self, idx)

    torch.Tensor.__getitem__ = spy
    try:
        MOE.moe_apply(params, cfg, x)
    finally:
        torch.Tensor.__getitem__ = orig
    assert torch.equal(seen[0], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_runs_on_meta(arch):
    """Shapes only, at full width: nothing on the path needs a value (no
    boolean-mask index, whose size depends on the data)."""
    cfg = get_config(arch)
    params = MOE.moe_init(None, cfg, torch.bfloat16, "meta")
    x = torch.empty((2, 64, cfg.d_model), dtype=torch.bfloat16, device="meta", requires_grad=True)
    y = MOE.moe_apply(params, cfg, x)
    assert y.shape == x.shape and y.device.type == "meta"
    (gx,) = torch.autograd.grad(y, x, torch.empty_like(y))
    assert gx.shape == x.shape
