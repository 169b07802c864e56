"""The plain-Python modules the port keeps as copies of the JAX package's
(errors, events, records, wire, chunking, the world pool and the shadow
builder), each fed the same input as its original, with the same result."""

from __future__ import annotations

import dataclasses
import threading

import pytest

from repro import configs as jax_configs
from repro.core import errors as JE
from repro.core import events as JEV
from repro.core import records as JRC
from repro.core import world_pool as JWP
from repro.core.intersection import TransferTask as JaxTask
from repro.reshard import chunking as JCH
from repro.reshard import wire as JW
from repro_torch import configs
from repro_torch.core import errors as E
from repro_torch.core import events as EV
from repro_torch.core import records as RC
from repro_torch.core import shadow as SH
from repro_torch.core import world_pool as WP
from repro_torch.core.intersection import TransferTask
from repro_torch.reshard import chunking as CH
from repro_torch.reshard import wire as W


def _task(cls, collection="params", kind="remote", bounds=((0, 64), (0, 32))):
    shape = [hi - lo for lo, hi in bounds]
    return cls(
        tensor=f"{collection}/w", collection=collection, src_rank=0, dst_rank=1, bounds=bounds,
        src_offset=(0,) * len(bounds), dst_offset=(0,) * len(bounds),
        nbytes=4 * (shape[0] * shape[1] if shape else 1), layer=0, kind=kind,
    )


def test_errors_are_the_same_hierarchy():
    for name in ("RecoveryError", "ProtocolError", "TraceError"):
        ours, theirs = getattr(E, name), getattr(JE, name)
        assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in theirs.__mro__]


def test_events_sort_and_deadlines_equal_jax():
    times = [5.0, 1.0, 3.0, 1.0, float("inf")]
    ours = [EV.ResizeEvent(t, configs.ParallelConfig(dp=i + 1), warning_s=2.0) for i, t in enumerate(times)]
    ours.append(EV.FailStopEvent(2.0, lost_ranks=(1,)))
    theirs = [JEV.ResizeEvent(t, jax_configs.ParallelConfig(dp=i + 1), warning_s=2.0) for i, t in enumerate(times)]
    theirs.append(JEV.FailStopEvent(2.0, lost_ranks=(1,)))
    key = lambda e: (e.kind, e.time_s, getattr(e, "deadline_s", None), getattr(getattr(e, "target", None), "dp", None))  # noqa: E731
    assert [key(e) for e in EV.sort_trace(ours)] == [key(e) for e in JEV.sort_trace(theirs)]


@pytest.mark.parametrize("rec", [{}, {"skipped_bytes": 8}, {"resident_cells": 2}, {"skipped_bytes": 8, "resident_cells": 1}])
def test_reuse_identity_equals_jax(rec):
    assert RC.reuse_identity_ok(rec) == JRC.reuse_identity_ok(rec)
    ours = dataclasses.asdict(RC.ReuseRecordMixin(**rec))
    assert ours == dataclasses.asdict(JRC.ReuseRecordMixin(**rec))


@pytest.mark.parametrize("policy", [None, dict(), dict(moments="fp8_e4m3", params="int8"), dict(moments="none")])
@pytest.mark.parametrize("collection,kind", [("params", "remote"), ("mu", "remote"), ("nu", "local"), ("step", "remote")])
def test_wire_bytes_equal_jax(policy, collection, kind):
    ours = None if policy is None else W.WirePolicy(**policy)
    theirs = None if policy is None else JW.WirePolicy(**policy)
    assert W.wire_nbytes(ours, _task(TransferTask, collection, kind)) == JW.wire_nbytes(
        theirs, _task(JaxTask, collection, kind)
    )


@pytest.mark.parametrize("budget", [1, 128, 4 * 32 * 16, 4 * 32 * 17 + 5, 1 << 20])
@pytest.mark.parametrize("policy", [None, dict()])
def test_chunking_equals_jax(budget, policy):
    assert CH.row_batches(3, 70, 12, budget) == JCH.row_batches(3, 70, 12, budget)
    for collection in ("params", "mu"):
        ours = CH.chunk_task(_task(TransferTask, collection), budget, None if policy is None else W.WirePolicy(**policy))
        theirs = JCH.chunk_task(_task(JaxTask, collection), budget, None if policy is None else JW.WirePolicy(**policy))
        assert [dataclasses.astuple(c) for c in ours] == [dataclasses.astuple(c) for c in theirs]


class _Handle:
    def __init__(self):
        self.released = False

    def release(self):
        self.released = True


def test_world_pool_equals_jax():
    """The same puts, takes, duplicate puts and evictions give the same
    stats, keys and releases."""
    pools = (WP.WorldPool(capacity=2), JWP.WorldPool(capacity=2))
    seen = []
    for pool in pools:
        h = [_Handle() for _ in range(5)]
        pool.put("a", h[0])
        pool.put("b", h[1])
        pool.put("a", h[2])  # duplicate: the incoming handle is released
        got = pool.take("b")
        pool.put("c", h[3])
        pool.put("d", h[4])  # evicts the LRU entry
        miss = pool.take("zz")
        n = pool.invalidate(lambda k, _: k == "d")
        seen.append((pool.stats.to_dict(), pool.keys(), [x.released for x in h], got is h[1], miss, n))
    assert seen[0] == seen[1]


def test_shadow_builder_builds_and_deposits_abandoned_worlds():
    gate = threading.Event()
    world = SH.WorldHandle(configs.ParallelConfig(), ["cpu"], step_fn=lambda: None)

    def build():
        gate.wait(10)
        return world

    deposited = []
    builder = SH.ShadowBuilder(build, gen_id=3, on_discard=deposited.append).start()
    assert not builder.ready
    builder.abandon()
    gate.set()
    assert builder.result(10) is world and world.gen_id == 3
    builder._thread.join(10)
    assert deposited == [world] and "prepare_total_s" in world.timings
    assert str(world.device) == "cpu"
    world.release()
    assert world.released and world.step_fn is None
