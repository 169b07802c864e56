"""Train-step builders: gradients (with microbatch accumulation), the
optimizer update (with optional int8 error-feedback gradient
compression), and the two joined.

The counterpart of ``repro/distribution/step.py``, reduced to one device:
``make_*`` return plain functions over the world's tensors, and a world's
state is global tensors on its device (``core/shadow.py``), so no function
here takes a mesh or shardings. The grad/update split carries over: the
split-step commit computes gradients on the old world and applies
``make_update_fn``'s update to the new world's state
(``core/controller.py``).

The update is in place (``optim.adamw``): ``update(grads, opt_state,
params)`` writes the new values into ``params`` and ``opt_state`` and
returns them. Before its first write it makes the current stream wait on
``fence`` when one is given: the event that says the reshard executor's
reads of these tensors have retired (``reshard/executors.py::sync_staging``,
the port's analogue of the JAX package's donation).

``compression="int8_ef"`` sends every gradient leaf through the int8
round trip with error feedback before the update
(``kernels/reshard_quant.py::compress_decompress_with_ef``); its residuals
are ``opt_state["ef"]``, float32 zeros at init. Pipeline stages are
``distribution/pipeline.py``.

The per-rank step. With ``groups`` (a world's
``distribution/groups.py::RankGroups``, or ``core/mock_groups.py::
MockGroups`` on the meta device) the same builders return one rank's step
over its shards (:func:`shard_train_state`): the batch is the rank's dp
rows (``data/pipeline.py::SyntheticLM.shard_at``), the loss runs the
model's tp and ep regions (``models/model.py::loss_fn(groups=)``), the
gradients and the loss are averaged over dp, and the update runs AdamW on
the shards in place with the clip's norm counting each element once
(``optim/adamw.py::global_norm`` over :func:`split_paths`). A world with
pipeline stages takes its step from ``distribution/pipeline.py``. Refused
there for now: ``compression="int8_ef"``, SSM and enc-dec models, a shared
expert, and tied embeddings across stages (``check_rank_model``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.reshard_quant import compress_decompress_with_ef
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.utils.pytree import tree_from_paths, tree_paths

__all__ = [
    "check_rank_model",
    "init_opt_state",
    "init_train_state",
    "join_step",
    "make_grad_fn",
    "make_train_step",
    "make_update_fn",
    "rank_grad_step",
    "shard_params",
    "shard_train_state",
    "split_paths",
]

COMPRESSIONS = ("none", "int8_ef")
GRAD_ACCUMS = ("explicit", "scan_loss")


def _choice(name: str, value: str, allowed: tuple) -> None:
    if value not in allowed:
        raise ValueError(f"{name}={value!r}: want one of {allowed}")


def _autograd_leaves(paths: dict) -> dict:
    """The leaves autograd differentiates, aliasing the params' storage: a
    stacked block parameter (``blocks/...``, periods on dim 0) becomes one
    leaf per period (``encoder/blocks/...`` too). Through views of one
    stacked leaf, autograd would zero-fill a copy of the whole stack for
    every period's gradient and add them up, moving the stack's bytes once
    per period."""
    out = {}
    for path, x in paths.items():
        base = x.detach()
        if path.startswith(("blocks/", "encoder/blocks/")):
            out[path] = [base[i].requires_grad_(True) for i in range(base.shape[0])]
        else:
            out[path] = base.requires_grad_(True)
    return out


def value_and_grad(loss_of, paths: dict):
    """``loss_of(tree) -> (loss, metrics)`` and its gradients with respect
    to the leaves ``paths`` names, by one autograd pass over
    :func:`_autograd_leaves`: (loss, metrics, grads by path), detached."""
    leaves = _autograd_leaves(paths)
    loss, metrics = loss_of(tree_from_paths(leaves))
    flat = [t for v in leaves.values() for t in (v if isinstance(v, list) else [v])]
    grads = list(torch.autograd.grad(loss, flat))
    out, i = {}, 0
    for path, v in leaves.items():
        n = len(v) if isinstance(v, list) else 1
        out[path] = torch.stack(grads[i : i + n]) if isinstance(v, list) else grads[i]
        grads[i : i + n] = [None] * n  # let each period's gradient go once stacked
        i += n
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, out


def _micro(batch: dict, microbatches: int) -> list[dict]:
    """``batch`` cut into ``microbatches`` equal slices along dim 0."""
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of microbatches={microbatches}")
    mb = b // microbatches
    return [{k: v[i * mb : (i + 1) * mb] for k, v in batch.items()} for i in range(microbatches)]


def check_rank_model(cfg: ModelConfig, parallel) -> None:
    """Refuse what a per-rank world does not run yet: a model other than a
    decoder of attention blocks with dense or MoE MLPs (no shared expert),
    tied embeddings across pipeline stages, a pipeline its stages do not
    divide, and a tp that does not divide its heads, kv columns, widths,
    vocabulary and router columns, or an ep that does not divide its
    experts (the collectives take equal parts)."""
    from repro_torch.distribution.groups import check_rank_world
    from repro_torch.models.attention import local_heads
    from repro_torch.models.transformer import block_program

    check_rank_world(parallel)
    if cfg.family == "encdec" or any(m != "attn" or f not in ("dense", "moe") for m, f in block_program(cfg)):
        raise ValueError(f"{cfg.name}: per-rank worlds run decoders of attention blocks with dense or MoE MLPs only")
    if cfg.moe_shared_expert:
        raise ValueError(f"{cfg.name}: a shared expert is not ported to per-rank worlds")
    if parallel.pp > 1:
        from repro_torch.distribution.pipeline import check_pipeline

        check_pipeline(cfg, parallel, parallel.pp)
        if cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tied embeddings live on the first and the last stage at once")
    tp = parallel.tp
    sizes = {"d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
             "kv columns": cfg.num_kv_heads * cfg.resolved_head_dim}
    if cfg.num_experts:
        sizes["router columns"] = cfg.num_experts
    bad = {k: v for k, v in sizes.items() if v % tp}
    if bad:
        raise ValueError(f"{cfg.name}: tp={tp} does not divide {bad}")
    if parallel.ep > 1 and cfg.num_experts % parallel.ep:
        raise ValueError(f"{cfg.name}: ep={parallel.ep} does not divide {cfg.num_experts} experts")
    for r in range(tp):
        local_heads(cfg, tp, r)


def split_paths(cfg: ModelConfig, parallel) -> dict:
    """The param paths the planner cuts over ep or tp in ``parallel``, each
    with the groups it is cut over (``("ep",)``, ``("tp",)`` or ``("ep",
    "tp")``; degrees of 1 cut nothing): the leaves whose squares the clip
    sums over those groups."""
    from repro_torch.core.resource_view import build_tensor_specs

    out = {}
    for spec in build_tensor_specs(cfg, include_optimizer=False):
        cut = tuple(g for g in ("ep", "tp") if g in spec.roles and getattr(parallel, g) > 1)
        if cut:
            out[spec.name[len("params/"):]] = cut
    return out


def shard_params(cfg: ModelConfig, tree: dict, parallel, rank: int) -> dict:
    """Rank ``rank``'s shards of a whole param tree, or of a moment tree
    (``mu``, ``nu``: the planner lays them out as their params): each
    leaf's ``core/resource_view.py::shard_of`` box; a leaf the rank holds
    no part of (another stage's) is absent."""
    from repro_torch.core.resource_view import build_tensor_specs, shard_of

    specs = {s.name[len("params/"):]: s for s in build_tensor_specs(cfg, include_optimizer=False)}
    shards = {p: shard_of(x, specs[p], parallel, rank) for p, x in tree_paths(tree).items()}
    return tree_from_paths({p: x for p, x in shards.items() if x is not None})


def shard_train_state(cfg: ModelConfig, params: dict, opt_state: dict, parallel, rank: int) -> tuple[dict, dict]:
    """Rank ``rank``'s (params, opt_state) of whole trees: each param,
    ``mu`` and ``nu`` leaf's shard (:func:`shard_params`), the step count
    copied."""
    return shard_params(cfg, params, parallel, rank), {
        "mu": shard_params(cfg, opt_state["mu"], parallel, rank),
        "nu": shard_params(cfg, opt_state["nu"], parallel, rank),
        "count": opt_state["count"].clone(),
    }


def _dp_mean(groups, t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the dp group."""
    return t if groups.dp == 1 else groups.all_reduce(t, "dp") / groups.dp


def rank_grad_step(local_step, groups):
    """``local_step(params, batch) -> (loss, metrics, grads)`` of one rank,
    its loss, metrics and gradients averaged over dp (in place)."""

    def grad_step(params: dict, batch: dict):
        loss, metrics, grads = local_step(params, batch)
        for g in tree_paths(grads).values():
            g.copy_(_dp_mean(groups, g))
        metrics = {k: _dp_mean(groups, v) for k, v in metrics.items()}
        return _dp_mean(groups, loss), metrics, grads

    return grad_step


def make_grad_fn(
    cfg: ModelConfig, microbatches: int = 1, remat: str = "full", grad_accum: str = "explicit", aux_weight: float = 0.01,
    groups=None,
):
    """Returns ``grad_step(params, batch) -> (loss, metrics, grads)``: the
    forward/backward half of the step. With ``microbatches > 1`` the batch
    is cut into equal slices along dim 0 and the loss is the mean of
    theirs. ``grad_accum="explicit"`` (the default) takes each slice's
    gradients apart, sums them in float32 and divides by their number;
    ``"scan_loss"`` differentiates the mean of the slices' losses in one
    autograd pass (no metrics), as the JAX package's scan does. The JAX
    scan rematerialises each slice's loss in the backward pass; here every
    slice's saved activations (each period's input under ``remat="full"``)
    stay until that one pass.

    The loss carries ``aux_weight`` times the MoE aux loss of a model with
    MoE layers (0 for a pipeline world's). On the card an SSM mixer's gradient goes through the SSD backward
    kernel; an enc-dec model's batch carries ``frames``. ``groups``: one
    rank's step over its shards and dp rows (the module docstring) of a
    world without pipeline stages; the loss and gradients returned are the
    dp means."""
    _choice("grad_accum", grad_accum, GRAD_ACCUMS)
    if groups is not None:
        check_rank_model(cfg, groups.parallel)
        if groups.pp > 1:
            raise ValueError(f"{groups.parallel.describe()}: a world with pipeline stages steps through "
                             "distribution/pipeline.py")

    def grads_of(paths: dict, batch: dict):
        return value_and_grad(lambda tree: M.loss_fn(cfg, tree, batch, remat, aux_weight, groups), paths)

    def scan_loss(tree: dict, micro: list[dict]):
        total = sum(M.loss_fn(cfg, tree, m, remat, aux_weight, groups)[0] for m in micro)
        return total / len(micro), {}

    def local_step(params: dict, batch: dict):
        paths = tree_paths(params)
        if microbatches <= 1:
            loss, metrics, grads = grads_of(paths, batch)
            return loss, metrics, tree_from_paths(grads)
        micro = _micro(batch, microbatches)
        if grad_accum == "scan_loss":
            loss, _, grads = value_and_grad(lambda tree: scan_loss(tree, micro), paths)
            return loss, {}, tree_from_paths(grads)
        g_sum, loss_sum = None, None
        for m in micro:
            loss, _, grads = grads_of(paths, m)
            if g_sum is None:
                g_sum = {p: g.to(torch.float32) for p, g in grads.items()}
                loss_sum = loss
            else:
                for p, g in grads.items():
                    g_sum[p].add_(g.to(torch.float32))
                loss_sum = loss_sum + loss
        grads = {p: g / microbatches for p, g in g_sum.items()}
        return loss_sum / microbatches, {}, tree_from_paths(grads)

    return local_step if groups is None else rank_grad_step(local_step, groups)


def make_update_fn(opt_cfg: AdamWConfig, compression: str = "none", groups=None, split=None):
    """Returns ``update(grads, opt_state, params, fence=None) -> (params,
    opt_state, metrics)``: the optimizer half of the step, in place. Under
    ``compression="int8_ef"`` the gradients first take the int8 round trip
    with error feedback (``opt_state["ef"]``, updated in place). ``groups``
    and ``split`` (:func:`split_paths`): one rank's update over its
    shards."""
    _choice("compression", compression, COMPRESSIONS)
    if groups is not None and compression != "none":
        raise ValueError(f"compression={compression!r} is not ported to per-rank worlds")

    def update(grads: dict, opt_state: dict, params: dict, fence: Optional[torch.cuda.Event] = None):
        if fence is not None:
            torch.cuda.current_stream().wait_event(fence)
        if compression == "int8_ef":
            grads, opt_state = compress_decompress_with_ef(grads, opt_state)
        return adamw_update(opt_cfg, grads, opt_state, params, groups, split)

    return update


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    microbatches: int = 1,
    remat: str = "full",
    compression: str = "none",
    grad_accum: str = "explicit",
    aux_weight: float = 0.01,
    groups=None,
):
    """Returns ``train_step(params, opt_state, batch, fence=None) ->
    (params, opt_state, metrics)``, metrics with ``loss``, ``lr`` and
    ``grad_norm``; params and opt_state are updated in place. ``groups``:
    one rank's step (the module docstring)."""
    grad_step = make_grad_fn(cfg, microbatches, remat, grad_accum, aux_weight, groups)
    split = split_paths(cfg, groups.parallel) if groups is not None else None
    return join_step(grad_step, make_update_fn(opt_cfg, compression, groups, split))


def join_step(grad_step, update):
    """``train_step(params, opt_state, batch, fence=None) -> (params,
    opt_state, metrics)``: ``grad_step`` and then ``update``, in place."""

    def train_step(params: dict, opt_state: dict, batch: dict, fence=None):
        loss, metrics, grads = grad_step(params, batch)
        params, opt_state, opt_metrics = update(grads, opt_state, params, fence)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def init_opt_state(params: dict, compression: str = "none") -> dict:
    """Zero moments and count, and under ``compression="int8_ef"`` the
    float32 zero residuals ``ef``, one a param leaf."""
    _choice("compression", compression, COMPRESSIONS)
    opt = adamw_init(params)
    if compression == "int8_ef":
        opt["ef"] = tree_from_paths(
            {p: torch.zeros(x.shape, dtype=torch.float32, device=x.device) for p, x in tree_paths(params).items()}
        )
    return opt


def init_train_state(cfg: ModelConfig, seed: int = 0, compression: str = "none", device="cuda"):
    """(params, opt_state) on ``device``: the port's seeded init (one
    generator over the full tensors, so it does not depend on a world's
    layout) and :func:`init_opt_state`."""
    _choice("compression", compression, COMPRESSIONS)
    dev = M.resolve_device(device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return params, init_opt_state(params, compression)
