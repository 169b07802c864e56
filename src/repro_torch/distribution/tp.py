"""Tensor-parallel regions of the per-rank step: the Megatron-style pairs
of autograd functions over a world's tp group (``distribution/groups.py``
or ``core/mock_groups.py``), or over its ep group for the expert MLP
(``models/moe.py``: every rank of an ep group routes the same rows and runs
its own experts' products).

- :func:`copy_to` enters a region: the identity forward, an all-reduce of
  the gradient backward (each rank's branch adds its part of it);
- :func:`reduce_from` leaves one: an all-reduce forward, the identity
  backward;
- :func:`gather_from` gathers a tp-split tensor whole: an all-gather
  forward, a reduce-scatter of the gradient backward (the norm scales the
  planner splits on ``embed``, the k and v projections where the planner's
  view cuts a kv head);
- :func:`gather_whole` gathers a tp-split tensor that every rank then
  uses whole and alike (the router's logits): an all-gather forward, and
  backward this rank's part of a gradient that is already whole;
- :func:`embed` and :func:`nll` are the vocab-parallel embedding and
  cross-entropy: the embedding masks the tokens outside this rank's rows
  and all-reduces, and the loss all-reduces the max, the sum of
  exponentials and the target's logit, so the full logits are never
  formed.

Over a group of one rank every function is the identity on its input.
"""

from __future__ import annotations

import torch


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, group):
        ctx.groups, ctx.group = groups, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.groups.all_reduce(dy, ctx.group), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, group):
        return groups.all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return groups.all_gather(x, "tp", dim)

    @staticmethod
    def backward(ctx, dy):
        return ctx.groups.reduce_scatter(dy, "tp", ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim, ctx.part = groups, dim, x.shape[dim]
        return groups.all_gather(x, "tp", dim)

    @staticmethod
    def backward(ctx, dy):
        lo = ctx.groups.tp_rank * ctx.part
        return dy.narrow(ctx.dim, lo, ctx.part).contiguous(), None, None


def copy_to(x: torch.Tensor, groups, group: str = "tp") -> torch.Tensor:
    return x if groups.size(group) == 1 else _CopyTo.apply(x, groups, group)


def reduce_from(x: torch.Tensor, groups, group: str = "tp") -> torch.Tensor:
    return x if groups.size(group) == 1 else _ReduceFrom.apply(x, groups, group)


def gather_from(x: torch.Tensor, groups, dim: int = -1) -> torch.Tensor:
    return x if groups.tp == 1 else _GatherFrom.apply(x, groups, dim)


def gather_whole(x: torch.Tensor, groups, dim: int = -1) -> torch.Tensor:
    return x if groups.tp == 1 else _GatherWhole.apply(x, groups, dim)


def embed(tok: torch.Tensor, tokens: torch.Tensor, lo: int, dtype, groups) -> torch.Tensor:
    """This rank's rows ``[lo, lo + rows)`` of the embedding table looked
    up, the tokens outside them masked to zero, summed over tp: each token's
    row, as ``tok[tokens]`` of the whole table, cast to ``dtype``."""
    rows = tok.shape[0]
    local = tokens - lo
    inside = (local >= 0) & (local < rows)
    x = tok[local.clamp(0, rows - 1)] * inside[..., None].to(tok.dtype)
    return reduce_from(x.to(dtype), groups)


def nll(logits: torch.Tensor, targets: torch.Tensor, lo: int, groups) -> torch.Tensor:
    """Mean cross-entropy of float32 ``logits`` (..., rows), this rank's
    vocabulary rows ``[lo, lo + rows)``, against ``targets`` (...)."""
    rows = logits.shape[-1]
    m = groups.all_reduce(logits.detach().amax(dim=-1), "tp", "max")
    z = logits - m[..., None]
    sum_exp = reduce_from(z.exp().sum(dim=-1), groups)
    local = targets - lo
    inside = (local >= 0) & (local < rows)
    tgt = torch.take_along_dim(z, local.clamp(0, rows - 1)[..., None], dim=-1)[..., 0]
    tgt = reduce_from(torch.where(inside, tgt, torch.zeros_like(tgt)), groups)
    return (torch.log(sum_exp) - tgt).mean()
