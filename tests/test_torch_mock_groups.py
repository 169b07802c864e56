"""The mock process groups (``core/mock_groups.py``), held as
``tests/test_distribution.py::test_mock_warmup_abstract_mesh`` holds the
JAX package's: reduced qwen3-1.7b's train step on dp2tp2 warmed for a
rank with no device and no communicator. Eager PyTorch has nothing to
lower, so the warm-up executes the rank's step once on the meta device:
its seconds are positive and it runs more than 1000 aten ops (the JAX test
asks for more than 1000 bytes of HLO), every output stays on meta, and no
process group is created. The collectives it records, op by op with their
bytes, are those a real gloo world of 4 CPU rank processes counts through
``RankGroups`` for the same step on every rank."""

from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.mock_groups import MockGroups, mock_warmup
from repro_torch.core.shadow import rank_meta_args
from repro_torch.distribution.step import make_train_step
from repro_torch.launch.ranks import run_ranks
from repro_torch.optim import AdamWConfig

torch.set_num_threads(2)

WORLD = ParallelConfig(dp=2, tp=2)
BATCH, SEQ = 4, 16


def _cfg():
    return get_config("qwen3-1.7b").reduced()


def _step(groups):
    return make_train_step(_cfg(), AdamWConfig(), groups=groups)


def _rank_program(rank: int) -> list:
    """One real train step of ``rank`` on its shards: the collectives its
    ``RankGroups`` recorded."""
    from repro_torch.distribution.groups import RankPool, make_world_groups
    from repro_torch.distribution.step import init_train_state, shard_train_state

    cfg = _cfg()
    g = make_world_groups(RankPool(), [WORLD])[WORLD]
    params, opt = init_train_state(cfg, device="cpu")
    params, opt = shard_train_state(cfg, params, opt, WORLD, rank)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH // WORLD.dp, SEQ), generator=torch.Generator().manual_seed(0))
    _step(g)(params, opt, {"tokens": tokens})
    return list(g.collectives)


def test_mock_warmup_runs_the_rank_step_on_meta():
    res = mock_warmup(_step, WORLD, 0, rank_meta_args(_cfg(), WORLD, 0, BATCH, SEQ))
    assert res.warm_seconds > 0
    assert res.aten_ops > 1000
    outs = [t for t in tree_flatten(res.outputs)[0] if isinstance(t, torch.Tensor)]
    assert outs and all(t.device.type == "meta" for t in outs)
    assert not dist.is_initialized()
    assert res.collectives and {g for _, g, _ in res.collectives} == {"dp", "tp"}


def test_mock_warmup_refuses_device_tensors():
    params, opt, batch = rank_meta_args(_cfg(), WORLD, 0, BATCH, SEQ)
    batch = {"tokens": torch.zeros((2, SEQ), dtype=torch.long)}
    with pytest.raises(ValueError):
        mock_warmup(_step, WORLD, 0, (params, opt, batch))


@pytest.mark.parametrize("dim", [0, -1])
def test_mock_collectives_keep_shapes_and_record(dim):
    g = MockGroups(ParallelConfig(dp=2, tp=4), 5)
    assert (g.dp_rank, g.tp_rank, g.member) == (1, 1, True)
    x = torch.empty((8, 12), device="meta")
    assert g.all_reduce(x, "dp").shape == x.shape
    gathered = g.all_gather(x, "tp", dim)
    assert gathered.shape[dim] == 4 * x.shape[dim] and gathered.device.type == "meta"
    assert g.reduce_scatter(x, "tp", dim).shape[dim] == x.shape[dim] // 4
    assert [op for op, _, _ in g.collectives] == ["all_reduce_sum", "all_gather", "reduce_scatter"]
    assert all(n == 8 * 12 * 4 for _, _, n in g.collectives)
    one = MockGroups(ParallelConfig(dp=2, tp=1), 1)
    assert one.all_gather(x, "tp", dim) is x and one.collectives == []


def test_mock_groups_refuse_pp_and_ep():
    """pp and ep mock groups: refused only below a degree of 1; a stage
    rank's sends and receives over pp and an ep rank's all-reduces are
    recorded with their bytes, and a receive returns a tensor of the shape
    asked for."""
    with pytest.raises(ValueError):
        MockGroups(ParallelConfig(pp=0), 0)
    g = MockGroups(ParallelConfig(dp=2, pp=2, ep=2, tp=2), 13)
    assert (g.dp_rank, g.pp_rank, g.ep_rank, g.tp_rank) == (1, 1, 0, 1)
    x = torch.empty((2, 8, 4), device="meta")
    g.send(x, "pp", 0)
    got = g.recv((2, 8, 4), torch.float32, "meta", "pp", 0)
    assert got.shape == x.shape and got.device.type == "meta"
    assert g.all_reduce(x, "ep").shape == x.shape
    assert g.collectives == [("send", "pp", 256), ("recv", "pp", 256), ("all_reduce_sum", "ep", 256)]


def test_mock_collectives_equal_a_real_worlds():
    real = run_ranks(_rank_program, WORLD.world_size, timeout=300)
    for rank in range(WORLD.world_size):
        mock = mock_warmup(_step, WORLD, rank, rank_meta_args(_cfg(), WORLD, rank, BATCH, SEQ))
        assert mock.collectives == real[rank], rank
    assert not dist.is_initialized()
