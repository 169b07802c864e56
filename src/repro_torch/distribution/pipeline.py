"""Pipeline-parallel training on one card.

The counterpart of ``repro/distribution/pipeline.py``. A pp world's state
has the stacked periods of every block tensor split contiguously across
``pp`` stages (``n_periods % pp == 0``), the geometry the resource view
gives the "pp" role, so a resize into or out of pp moves whole period
slices. Its loss is the JAX pipeline's: the batch cut into ``microbatches
>= pp`` equal slices, positions from 0 in each, each period
rematerialised, the next-token cross-entropy of the last stage's outputs
summed over the microbatches and divided by their number, with no MoE aux
term (the JAX pipeline leaves it out).

One card has no stage groups, so the GPipe schedule (stage ``s`` runs
microbatch ``m`` at tick ``m + s``) only reorders work on one device: each
microbatch runs through every stage in turn, which is the dense step's
``grad_accum="scan_loss"`` with the aux term weighted 0
(``distribution/step.py``). The JAX step also runs the pipeline's bubbles
on zeros or stale buffers and applies the head to every stage's slice
before masking it away, terms of zero weight in its loss, so the loss and
the gradients are the same function.

Refused with a ``ValueError``, as the JAX pipeline cannot run them: an
enc-dec model (its step calls the blocks without the encoder's output, so
it would drop the encoder and the cross attention) and
``compression="int8_ef"`` (its step and update carry no ``ef``).

On a per-rank world (``groups``, ``distribution/groups.py``) the stages
are processes, as Megatron's are. Each rank holds its stage's periods
(``core/resource_view.py::view_of`` cuts the stacked leaves by pp; the
embedding lives on stage 0, the final norm and the head on the last) and
runs them over each microbatch of its dp rows in the GPipe order: every
microbatch's forward, then every backward in reverse. Stage 0 embeds; a
later stage receives its input from the stage before over the pp group,
and the stage's output goes to the next (:class:`_Send`, :class:`_Recv`:
autograd functions whose backward carries the gradient the other way);
the last stage applies the final norm and the head and takes the loss.
Each microbatch's backward starts from its loss (last stage) or its send
(the others), so every rank of the world makes its point-to-point calls
in one fixed order and gloo's blocking calls cannot cross. Within a stage
the periods run the tp (and ep) regions of ``models/transformer.py``. The
loss, the mean of the microbatches' losses with the aux term weighted 0,
is shared over pp; the gradients are averaged over dp.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.distribution.step import (
    _autograd_leaves,
    _micro,
    join_step,
    make_grad_fn,
    make_train_step,
    make_update_fn,
    rank_grad_step,
    split_paths,
)
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.utils.pytree import tree_from_paths, tree_paths

__all__ = ["check_pipeline", "make_pipeline_grad_fn", "make_pipeline_train_step"]


def check_pipeline(cfg: ModelConfig, parallel: ParallelConfig, microbatches: int, compression: str = "none") -> None:
    """Raise ``ValueError`` for a pipeline the JAX package cannot run or
    whose stages and microbatches do not fit."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: pipeline stages take decoder-only models (the pipelined step calls the blocks "
            "without the encoder's output, which would drop the encoder and the cross attention)"
        )
    if compression == "int8_ef":
        raise ValueError(
            f"{parallel.describe()}: compression='int8_ef' with pipeline stages (the pipelined step and its "
            "update carry no error-feedback state)"
        )
    np_ = T.n_periods(cfg)
    if np_ % parallel.pp:
        raise ValueError(f"{cfg.name}: {np_} periods are not a multiple of pp={parallel.pp}")
    if microbatches < parallel.pp:
        raise ValueError(f"microbatches={microbatches} < pp={parallel.pp}: the pipeline never fills")


class _Send(torch.autograd.Function):
    """Forward: ``x`` to stage ``peer``; returns a 0-dim handle to start the
    microbatch's backward from. Backward: ``x``'s gradient from ``peer``."""

    @staticmethod
    def forward(ctx, x, groups, peer):
        ctx.groups, ctx.peer, ctx.meta = groups, peer, (x.shape, x.dtype, x.device)
        groups.send(x.detach(), "pp", peer)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return ctx.groups.recv(*ctx.meta, "pp", ctx.peer), None, None


class _Recv(torch.autograd.Function):
    """Forward: a tensor of ``shape`` from stage ``peer`` (``anchor``, a
    leaf that requires grad, puts the call in the graph). Backward: the
    tensor's gradient to ``peer``."""

    @staticmethod
    def forward(ctx, anchor, groups, peer, shape, dtype):
        ctx.groups, ctx.peer = groups, peer
        return groups.recv(shape, dtype, anchor.device, "pp", peer)

    @staticmethod
    def backward(ctx, dy):
        ctx.groups.send(dy.contiguous(), "pp", ctx.peer)
        return None, None, None, None, None


def _rank_stage(cfg: ModelConfig, microbatches: int, groups):
    """Returns ``local_step(params, batch) -> (loss, {}, grads)``: this
    stage rank's forward and backward over its dp rows (the module
    docstring); the loss is the pipeline's on every stage."""
    s, last = groups.pp_rank, groups.pp - 1
    dtype = getattr(torch, cfg.dtype)

    def local_step(params: dict, batch: dict):
        leaves = _autograd_leaves(tree_paths(params))
        tree = tree_from_paths(leaves)
        micro = _micro(batch, microbatches)
        device = micro[0]["tokens"].device
        roots, anchors, losses = [], [], []
        for m in micro:
            tokens = m["tokens"]
            if s == 0:
                x = M.rank_embed(cfg, tree, tokens, groups)
            else:
                anchor = torch.zeros((), device=device, requires_grad=True)
                anchors.append(anchor)
                x = _Recv.apply(anchor, groups, s - 1, (*tokens.shape, cfg.d_model), dtype)
            x, _ = T.stack_forward(tree["blocks"], cfg, x, M.positions_of(tokens), causal=True, remat="full",
                                   groups=groups)
            if s == last:
                loss = M.rank_nll(cfg, tree, x, tokens, groups)
                losses.append(loss.detach())
                roots.append(loss / microbatches)
            else:
                roots.append(_Send.apply(x, groups, s + 1))
        flat = [t for v in leaves.values() for t in (v if isinstance(v, list) else [v])]
        for root in reversed(roots):
            torch.autograd.backward(root, torch.ones_like(root), inputs=flat + anchors)
        grads = {}
        for path, v in leaves.items():
            parts = [t.grad if t.grad is not None else torch.zeros_like(t) for t in (v if isinstance(v, list) else [v])]
            grads[path] = torch.stack(parts) if isinstance(v, list) else parts[0]
        loss = sum(losses) / microbatches if s == last else torch.zeros((), dtype=torch.float32, device=device)
        return groups.all_reduce(loss, "pp"), {}, tree_from_paths(grads)

    return local_step


def make_pipeline_grad_fn(cfg: ModelConfig, parallel: ParallelConfig, microbatches: int, groups=None):
    """Returns ``grad_step(params, batch) -> (loss, {}, grads)``: the
    pipeline's forward and backward, the grads-only half the split-step
    commit runs on the old world. ``groups``: one stage rank's (the module
    docstring)."""
    check_pipeline(cfg, parallel, microbatches)
    if groups is None:
        return make_grad_fn(cfg, microbatches, "full", "scan_loss", aux_weight=0.0)
    return rank_grad_step(_rank_stage(cfg, microbatches, groups), groups)


def make_pipeline_train_step(
    cfg: ModelConfig, parallel: ParallelConfig, opt_cfg: AdamWConfig, microbatches: int, compression: str = "none",
    groups=None,
):
    """Returns ``train_step(params, opt_state, batch, fence=None) ->
    (params, opt_state, metrics)``: :func:`make_pipeline_grad_fn` and the
    AdamW update, in place."""
    check_pipeline(cfg, parallel, microbatches, compression)
    if groups is None:
        return make_train_step(cfg, opt_cfg, microbatches, "full", compression, "scan_loss", aux_weight=0.0)
    return join_step(make_pipeline_grad_fn(cfg, parallel, microbatches, groups),
                     make_update_fn(opt_cfg, compression, groups, split_paths(cfg, parallel)))
