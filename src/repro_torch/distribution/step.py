"""Train-step builders: gradients (with microbatch accumulation), the
optimizer update, and the two joined.

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

Not ported: int8 gradient compression with error feedback
(``compression="int8_ef"``, ROADMAP queue 1 item 5), pipeline stages and
the sharded ``jit_*`` wrappers (process groups wait for multi-card worlds,
queue 1 item 13).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.utils.pytree import tree_from_paths, tree_paths

__all__ = ["init_train_state", "make_grad_fn", "make_train_step", "make_update_fn"]


def _check_compression(compression: str) -> None:
    if compression != "none":
        raise NotImplementedError(
            f"compression={compression!r}: int8 gradient compression with error feedback is not "
            "ported yet (ROADMAP queue 1 item 5)"
        )


def _autograd_leaves(paths: dict) -> dict:
    """The leaves autograd differentiates, aliasing the params' storage: a
    stacked block parameter (``blocks/...``, periods on dim 0) becomes one
    leaf per period. Through views of one stacked leaf, autograd would
    zero-fill a copy of the whole stack for every period's gradient and add
    them up, moving the stack's bytes once per period."""
    out = {}
    for path, x in paths.items():
        base = x.detach()
        if path.startswith("blocks/"):
            out[path] = [base[i].requires_grad_(True) for i in range(base.shape[0])]
        else:
            out[path] = base.requires_grad_(True)
    return out


def make_grad_fn(cfg: ModelConfig, microbatches: int = 1, remat: str = "full"):
    """Returns ``grad_step(params, batch) -> (loss, metrics, grads)``: the
    forward/backward half of the step. With ``microbatches > 1`` the batch
    is cut into equal slices along dim 0, the float32 gradients summed and
    divided by their number, and so is the loss (the JAX package's
    "explicit" accumulation)."""

    def grads_of(paths: dict, batch: dict):
        leaves = _autograd_leaves(paths)
        loss, metrics = M.loss_fn(cfg, tree_from_paths(leaves), batch, remat=remat)
        flat = [t for v in leaves.values() for t in (v if isinstance(v, list) else [v])]
        grads = list(torch.autograd.grad(loss, flat))
        out, i = {}, 0
        for path, v in leaves.items():
            n = len(v) if isinstance(v, list) else 1
            out[path] = torch.stack(grads[i : i + n]) if isinstance(v, list) else grads[i]
            grads[i : i + n] = [None] * n  # let each period's gradient go once stacked
            i += n
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, out

    def grad_step(params: dict, batch: dict):
        paths = tree_paths(params)
        if microbatches <= 1:
            loss, metrics, grads = grads_of(paths, batch)
            return loss, metrics, tree_from_paths(grads)
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} is not a multiple of microbatches={microbatches}")
        mb = b // microbatches
        g_sum, loss_sum = None, None
        for i in range(microbatches):
            micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
            loss, _, grads = grads_of(paths, micro)
            if g_sum is None:
                g_sum = {p: g.to(torch.float32) for p, g in grads.items()}
                loss_sum = loss
            else:
                for p, g in grads.items():
                    g_sum[p].add_(g.to(torch.float32))
                loss_sum = loss_sum + loss
        grads = {p: g / microbatches for p, g in g_sum.items()}
        return loss_sum / microbatches, {}, tree_from_paths(grads)

    return grad_step


def make_update_fn(opt_cfg: AdamWConfig, compression: str = "none"):
    """Returns ``update(grads, opt_state, params, fence=None) -> (params,
    opt_state, metrics)``: the optimizer half of the step, in place."""
    _check_compression(compression)

    def update(grads: dict, opt_state: dict, params: dict, fence: Optional[torch.cuda.Event] = None):
        if fence is not None:
            torch.cuda.current_stream().wait_event(fence)
        return adamw_update(opt_cfg, grads, opt_state, params)

    return update


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    microbatches: int = 1,
    remat: str = "full",
    compression: str = "none",
):
    """Returns ``train_step(params, opt_state, batch, fence=None) ->
    (params, opt_state, metrics)``, metrics with ``loss``, ``lr`` and
    ``grad_norm``; params and opt_state are updated in place."""
    grad_step = make_grad_fn(cfg, microbatches, remat)
    update = make_update_fn(opt_cfg, compression)

    def train_step(params: dict, opt_state: dict, batch: dict, fence=None):
        loss, metrics, grads = grad_step(params, batch)
        params, opt_state, opt_metrics = update(grads, opt_state, params, fence)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, compression: str = "none", device="cuda"):
    """(params, opt_state) on ``device``: the port's seeded init (one
    generator over the full tensors, so it does not depend on a world's
    layout) and zero moments."""
    _check_compression(compression)
    dev = M.resolve_device(device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return params, adamw_init(params)
