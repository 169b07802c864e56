"""Mock process groups (paper §4.5): a cold rank's set-up without its
world's communicators.

The paper intercepts a world's NCCL collectives, so that a cold rank can
finish its heavy local set-up (model construction, compilation,
autotuning) alone while the hot ranks keep training. The JAX package
traces and lowers the target world's step against an ``AbstractMesh``
(``repro/core/mock_groups.py``). Eager PyTorch has nothing to lower; its
counterpart is one execution of the rank's own step on the meta device
(``roofline/counting.py``, the kernels' meta routes in ``kernels/meta.py``)
under :class:`MockGroups`: the rank's collectives, as
``distribution/groups.py::RankGroups`` gives them, that communicate
nothing, return outputs of the right shape, dtype and device, and record
each call ``(op, group, bytes)``. No process group is created and no
device is touched.

    res = mock_warmup(lambda groups: make_train_step(cfg, opt, groups=groups),
                      ParallelConfig(dp=2, tp=2), rank=0, meta_args=(params, opt_state, batch))

``core/shadow.py::build_rank_world`` runs it for the rank in a per-rank
world's Prepare.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.distribution.groups import Collectives

__all__ = ["MockGroups", "MockWarmupResult", "mock_warmup"]


class MockGroups(Collectives):
    """``RankGroups``' interface for rank ``rank`` of ``parallel`` (dp, pp,
    ep and tp groups), communicating nothing: all-reduce returns its
    input's copy, all-gather and reduce-scatter fresh tensors of their
    outputs' shapes, a send goes nowhere and a receive returns a fresh
    tensor of the shape asked for."""

    def __init__(self, parallel: ParallelConfig, rank: int):
        self._setup(parallel, rank)

    def _all_reduce(self, t, group, op):
        return t

    def _all_gather(self, t, group, dim):
        shape = list(t.shape)
        shape[dim] *= self.size(group)
        return t.new_empty(shape)

    def _reduce_scatter(self, t, group, dim):
        shape = list(t.shape)
        shape[dim] //= self.size(group)
        return t.new_empty(shape)

    def _send(self, t, group, peer):
        pass

    def _recv(self, out, group, peer):
        return out


@dataclass
class MockWarmupResult:
    warm_seconds: float  # host time of the execution on meta
    aten_ops: int  # the aten ops it ran: the measure of the program (the JAX package's HLO bytes)
    collectives: list = field(default_factory=list)  # (op, group, bytes) a call, in order
    outputs: object = None  # what the step returned, on meta


def mock_warmup(step_fn: Callable, parallel: ParallelConfig, rank: int, meta_args: tuple) -> MockWarmupResult:
    """Run rank ``rank``'s step of ``parallel`` once on the meta device
    under :class:`MockGroups`: ``step_fn(groups)`` builds the step, which
    is then called on ``meta_args`` (the rank's shards and batch as meta
    tensors). Refuses an argument that is not on meta."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.roofline.counting import count

    leaves = [t for t in tree_flatten(meta_args)[0] if isinstance(t, torch.Tensor)]
    bad = [str(t.device) for t in leaves if t.device.type != "meta"]
    if bad:
        raise ValueError(f"mock_warmup takes meta tensors only, got {sorted(set(bad))}")
    groups = MockGroups(parallel, rank)
    t0 = time.perf_counter()
    step = step_fn(groups)
    out, counted = count(step, *meta_args)
    return MockWarmupResult(
        warm_seconds=time.perf_counter() - t0, aten_ops=counted.ops, collectives=list(groups.collectives),
        outputs=out,
    )
