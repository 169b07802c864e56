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
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.distribution.step import make_grad_fn, make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig

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


def make_pipeline_grad_fn(cfg: ModelConfig, parallel: ParallelConfig, microbatches: int):
    """Returns ``grad_step(params, batch) -> (loss, {}, grads)``: the
    pipeline's forward and backward, the grads-only half the split-step
    commit runs on the old world."""
    check_pipeline(cfg, parallel, microbatches)
    return make_grad_fn(cfg, microbatches, "full", "scan_loss", aux_weight=0.0)


def make_pipeline_train_step(
    cfg: ModelConfig, parallel: ParallelConfig, opt_cfg: AdamWConfig, microbatches: int, compression: str = "none"
):
    """Returns ``train_step(params, opt_state, batch, fence=None) ->
    (params, opt_state, metrics)``: :func:`make_pipeline_grad_fn` and the
    AdamW update, in place."""
    check_pipeline(cfg, parallel, microbatches, compression)
    return make_train_step(cfg, opt_cfg, microbatches, "full", compression, "scan_loss", aux_weight=0.0)
