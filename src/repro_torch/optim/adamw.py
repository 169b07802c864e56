"""AdamW + cosine schedule + global-norm clipping over torch tensors.

The counterpart of ``repro/optim/adamw.py``, with the same decoupled weight
decay, bias correction, schedule and clip, step for step in float32. The
state tree keeps the reference's paths (``mu/<param path>``,
``nu/<param path>``, ``count``): the reshard planner names tensors by them.

One deliberate difference: :func:`adamw_update` updates ``params``, ``mu``
and ``nu`` **in place** and scales ``grads`` in place. The JAX update
returns new arrays and the step donates the old ones; in eager PyTorch a
functional update would hold a second copy of the world's state during every
step (about 24 GB more at qwen3-1.7b's full width, on a card that holds two
worlds during a resize). The schedule, the norm and the bias corrections are
computed as 0-dim float32 tensors on the state's device, so no step waits
for the host.

On one rank of a per-rank world (``groups``, ``distribution/groups.py``)
the update runs on the rank's shards in place, as it does on whole
tensors; only the clip's norm is the world's, each element counted once
across dp, pp, ep and tp: the squares of the leaves cut over ep or tp
(``split``) are summed over those groups, a leaf whole on every rank of a
group is counted once, and the stages' sums are added over pp (a stage
holds its own periods, and the embedding and the head exist on one stage
each), so the clip scale is the one-process run's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils.pytree import tree_map_with_path, tree_paths


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: dict) -> dict:
    """Zero moments in float32 beside each parameter, and an int32 step
    count on the parameters' device."""
    zeros = lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = next(iter(tree_paths(params).values())).device
    return {
        "mu": tree_map_with_path(zeros, params),
        "nu": tree_map_with_path(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def optimizer_logical_axes(param_axes: dict) -> dict:
    """Optimizer state axes mirror the param axes; count is replicated."""
    return {"mu": param_axes, "nu": param_axes, "count": ()}


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then a cosine down to ``min_lr_ratio``; float32,
    on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * scale


def global_norm(tree: dict, groups=None, split=None) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, summed leaf by
    leaf in path order. With ``groups``, ``split`` maps the paths of the
    leaves cut over ep or tp to those groups (``distribution/step.py::
    split_paths``): the sums of the leaves cut over tp (and over ep and tp)
    are all-reduced over tp, then those cut over ep over ep, then the whole
    sum over pp."""
    paths = tree_paths(tree)
    device = next(iter(paths.values())).device
    sq = {(): _f32(0.0, device), ("tp",): _f32(0.0, device), ("ep",): _f32(0.0, device),
          ("ep", "tp"): _f32(0.0, device)}
    for path, g in paths.items():
        key = split.get(path, ()) if groups is not None and split else ()
        sq[key] = sq[key] + torch.sum(torch.square(g.to(torch.float32)))
    total = sq[()]
    if groups is not None:
        tp = groups.all_reduce(torch.stack([sq[("tp",)], sq[("ep", "tp")]]), "tp")
        ep = groups.all_reduce(torch.stack([sq[("ep",)], tp[1]]), "ep")
        total = groups.all_reduce(total + tp[0] + ep[0] + ep[1], "pp")
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, opt_state: dict, params: dict, groups=None, split=None):
    """One AdamW step, in place. Returns (params, opt_state, metrics): the
    same tensors that came in, updated. ``groups`` and ``split`` as in
    :func:`global_norm`."""
    count = opt_state["count"].add_(1)
    lr = cosine_lr(cfg, count)

    gnorm = global_norm(grads, groups, split)
    clip_scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    countf = count.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, count.device), countf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, count.device), countf)

    p_leaves = tree_paths(params)
    mu, nu = tree_paths(opt_state["mu"]), tree_paths(opt_state["nu"])
    for path, g in tree_paths(grads).items():
        p, m, v = p_leaves[path], mu[path], nu[path]
        g = g.to(torch.float32).mul_(clip_scale)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        mh = m / b1c
        vh = v / b2c
        pf = p.to(torch.float32)
        step = mh.div_(vh.sqrt_().add_(cfg.eps)).add_(cfg.weight_decay * pf)
        p.copy_(pf.sub_(step.mul_(lr)))  # p - lr*step, in place for fp32 params
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
