"""Mixture-of-Experts MLP with capacity-based GShard-style dispatch.

The counterpart of ``repro/models/moe.py``. Expert weights are stacked on a
leading ``expert`` logical axis (``wi_gate`` is ``(e, d, f)``), so that the
planner gives that axis the ``ep`` role and an expert-parallel resize moves
slices of these tensors like any other (``core/resource_view.py``).

The routing is the JAX package's, step for step: the router product in
the activation dtype, its logits and softmax in float32, the top ``k``
experts of each token (a tie goes to the lower expert index, as
``jax.lax.top_k`` breaks it; ``torch.topk`` promises no order, so the
choice is a stable descending sort), the gates renormalised over the ``k``
choices with a ``1e-9`` floor, and each (token, choice) pair's slot in its
expert's buffer from the running count over the flattened ``(s, k)``
order, ``k`` inner. Capacity is counted per batch row and per call:
``max(1, int(capacity_factor * k * s / e))``. Pairs at or past it are
dropped: their gate is zeroed after the renormalisation, and they take no
slot.

The dispatch is by index, not by the JAX package's one-hot ``(b, s, e, c)``
dispatch and combine tensors: each kept pair's token row is gathered into
an ``(e, b, c, d)`` buffer (empty slots read a zero row; the slot table is
written without a boolean-mask index, so nothing waits for the host), the three expert
products run as batched matrix products over ``e``, and each token gathers
back its ``k`` expert outputs and sums them weighted by its gates, cast to
the activation dtype. The same pairs are dropped and the same products are
summed; only the summation order differs. A gathered token row keeps its
gradient path to ``x`` (the gathers' backward adds at most ``k`` rows into
each token's gradient, in a fixed order).

:func:`moe_apply_rank` is the layer on one rank of a per-rank world
(``distribution/groups.py``), which holds ``e / ep`` experts (the ``ep``
cut of the expert dimension), their ``ffn`` columns cut by tp, and the
router's expert columns cut by tp. As in the JAX package the batch is cut
over dp only, so every rank of an ep group sees the same rows: each routes
all of them, with the whole router (its logits gathered over tp) and the
same capacity and stable top-k, runs the products of its own experts only
and combines only the pairs they took. The expert input and the gates
enter through ``copy_to`` over ep and tp, and the combined output leaves
through ``reduce_from`` over ep and tp (``distribution/tp.py``): the
router's gradient is whole and alike on every rank, and the aux loss's
gradient is counted once.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import tp as TP
from repro_torch.models.layers import MLP_AXES, _act, _dense_init, mlp_apply, mlp_init

MOE_AXES = {
    "router": ("embed", "expert_in"),
    "wi_gate": ("expert", "embed", "ffn"),
    "wi_up": ("expert", "embed", "ffn"),
    "wo": ("expert", "ffn", "embed"),
}


def moe_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`moe_init`'s params (``shared``: a dense MLP's)."""
    return {**MOE_AXES, "shared": MLP_AXES} if cfg.moe_shared_expert else dict(MOE_AXES)


def moe_init(gen, cfg: ModelConfig, dtype, device, lead=(), cast=None) -> dict:
    """Router ``N(0, 1/d)``, expert matrices ``N(0, 1/fan_in)`` over their
    input dim, and the shared expert a dense MLP's init. ``cast``, given,
    maps ``{name: leaf}`` to the served dtypes as each expert matrix is
    drawn, so that only one float32 expert matrix is ever held."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    cast = cast or (lambda tree: tree)
    params = cast({"router": _dense_init(gen, (d, e), dtype, device, lead)})
    for name, shape in (("wi_gate", (e, d, f)), ("wi_up", (e, d, f)), ("wo", (e, f, d))):
        params.update(cast({name: _dense_init(gen, shape, dtype, device, lead, in_axis=1)}))
    if cfg.moe_shared_expert:
        params["shared"] = cast(mlp_init(gen, cfg, dtype, device, lead))
    return params


def router_probs(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Softmax of the router logits, float32 (b, s, e); the product in
    ``x.dtype``."""
    logits = (x @ params["router"].to(x.dtype)).float()
    return torch.softmax(logits, dim=-1)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the ``k`` largest values and
    their indices, ties to the lower index (a stable descending sort)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def route(probs: torch.Tensor, cfg: ModelConfig):
    """(gates (b, s, k) float32, zero where dropped; expert index (b, s, k);
    slot (b, s, k) in the expert's buffer; keep (b, s, k) bool; capacity)
    of the router's probabilities (b, s, e)."""
    b, s, _ = probs.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    capacity = max(1, int(cfg.moe_capacity_factor * k * s / e))
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # the pairs routed to each expert before this one, over (s, k) with k inner
    onehot = torch.nn.functional.one_hot(gate_idx.reshape(b, s * k), e)  # (b, s*k, e)
    before = onehot.cumsum(dim=1) - onehot
    slot = before.gather(-1, gate_idx.reshape(b, s * k, 1)).reshape(b, s, k)
    keep = slot < capacity
    return gate_vals * keep.to(gate_vals.dtype), gate_idx, slot, keep, capacity


def routing(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """:func:`route` of ``x``'s router probabilities."""
    return route(router_probs(params, x), cfg)


def _experts(params: dict, cfg: ModelConfig, x: torch.Tensor, gates, gate_idx, slot, keep, c, e0: int = 0):
    """The routed pairs of experts ``[e0, e0 + el)`` (``el`` the experts
    ``params`` holds) through their products, each token's pairs summed
    weighted by its gates; the pairs of other experts and dropped pairs
    add nothing."""
    b, s, d = x.shape
    el, k = params["wi_gate"].shape[0], cfg.experts_per_token
    mine = keep if el == cfg.num_experts else keep & (gate_idx >= e0) & (gate_idx < e0 + el)
    # a buffer slot's source row: its token's, or the zero row b*s
    rows = torch.arange(b * s, device=x.device).reshape(b, s, 1).expand(b, s, k)
    flat = ((gate_idx - e0) * b + torch.arange(b, device=x.device).reshape(b, 1, 1)) * c + slot  # (el, b, c) order
    # kept pairs have distinct slots; another's or a dropped pair writes the
    # extra last slot, which is cut off: no boolean-mask index, so no host
    # sync on the card and a form the meta device runs
    src = torch.full((el * b * c + 1,), b * s, dtype=torch.long, device=x.device)
    src[torch.where(mine, flat, el * b * c).reshape(-1)] = rows.reshape(-1)
    src = src[: el * b * c]
    x_rows = torch.cat([x.reshape(b * s, d), x.new_zeros(1, d)])
    xin = x_rows[src].reshape(el, b * c, d)
    gate = _act(cfg.act, torch.bmm(xin, params["wi_gate"].to(x.dtype)))
    up = torch.bmm(xin, params["wi_up"].to(x.dtype))
    yout = torch.bmm(gate * up, params["wo"].to(x.dtype)).reshape(el * b * c, d)
    # each pair reads its slot's output; a pair not taken here reads the zero row
    y_rows = torch.cat([yout, yout.new_zeros(1, d)])
    picked = y_rows[torch.where(mine, flat, el * b * c)].reshape(b * s, k, d)
    return torch.bmm(gates.to(x.dtype).reshape(b * s, 1, k), picked).reshape(b, s, d)


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (b, s, d) -> (b, s, d): the routed experts' weighted sum, plus the
    shared expert where the config has one."""
    y = _experts(params, cfg, x, *routing(params, cfg, x))
    if cfg.moe_shared_expert:
        y = y + mlp_apply(params["shared"], x, cfg.act)
    return y


def moe_apply_rank(params: dict, cfg: ModelConfig, x: torch.Tensor, groups) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` on one rank's shards (the module docstring), inside
    the tp region (``x`` whole and alike on every rank of the tp and ep
    groups): returns (the layer's output, whole on every rank; the aux
    loss of its router probabilities)."""
    if cfg.moe_shared_expert:
        raise ValueError(f"{cfg.name}: a shared expert is not ported to per-rank worlds")
    logits = TP.gather_whole((x @ params["router"].to(x.dtype)).float(), groups)
    probs = torch.softmax(logits, dim=-1)
    gates, gate_idx, slot, keep, c = route(probs, cfg)
    gates = TP.copy_to(TP.copy_to(gates, groups, "ep"), groups, "tp")
    e0 = groups.ep_rank * params["wi_gate"].shape[0]
    y = _experts(params, cfg, TP.copy_to(x, groups, "ep"), gates, gate_idx, slot, keep, c, e0)
    return TP.reduce_from(TP.reduce_from(y, groups, "ep"), groups, "tp"), aux_loss(probs, cfg.num_experts, groups)


def aux_loss(probs: torch.Tensor, e: int, groups=None) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style) of router
    probabilities (b, s, e), float32: ``e`` times the dot of each expert's
    share of top-1 choices (the first maximum, as ``jnp.argmax`` takes it)
    and its mean probability. ``groups``: the shares averaged over dp (the
    module docstring)."""
    top1 = probs.argmax(dim=-1)
    frac_tokens = torch.nn.functional.one_hot(top1, e).float().mean(dim=(0, 1))
    if groups is not None and groups.dp > 1:
        frac_tokens = groups.all_reduce(frac_tokens, "dp") / groups.dp
    frac_probs = probs.mean(dim=(0, 1))
    return e * (frac_tokens * frac_probs).sum()


def moe_aux_loss(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """:func:`aux_loss` of ``x``'s router probabilities."""
    return aux_loss(router_probs(params, x), cfg.num_experts)
