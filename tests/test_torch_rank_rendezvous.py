"""The rank pool's rendezvous (``launch/ranks.py``): worlds started at once
on one host meet each at its own ``file://`` store, so none can take
another's port. Two worlds of 4 CPU rank processes started from two
threads both return, each rank's all-reduce over its own world only."""

from __future__ import annotations

import threading

import pytest

from repro_torch.launch.ranks import run_ranks


def _sum_of_ranks(rank: int, offset: int) -> tuple:
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(rank + offset)])
    dist.all_reduce(t)
    return rank, dist.get_world_size(), float(t)


def test_two_worlds_at_once_both_return():
    results, errors = {}, []

    def start(offset: int) -> None:
        try:
            results[offset] = run_ranks(_sum_of_ranks, 4, offset, timeout=240)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=start, args=(offset,)) for offset in (0, 100)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for offset in (0, 100):
        assert results[offset] == [(r, 4, float(6 + 4 * offset)) for r in range(4)]


@pytest.mark.parametrize("nproc", [1, 3])
def test_results_come_in_rank_order(nproc):
    assert run_ranks(_sum_of_ranks, nproc, 0, timeout=120) == [
        (r, nproc, float(nproc * (nproc - 1) // 2)) for r in range(nproc)]
