"""The port's elastic serving: the continuous-batching bookkeeping (copies
of the JAX package's slots module, held to its tests), and a generation
that crosses two live resizes mid-generation, token for token equal to the
port's own uninterrupted run and to the JAX package's uninterrupted
ServeSession from the same weights."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as JM
from repro.serve import cache_view as JC
from repro.serve import LiveServeController as JaxController
from repro.serve import ServeSession as JaxSession
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch import configs
from repro_torch.core.events import ResizeEvent
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.controller import LiveServeController
from repro_torch.serve.loop import ServeSession
from repro_torch.serve.slots import RequestQueue, SlotAllocator, plan_admission

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# Slot allocator and admission (tests/test_serve_elastic.py's sequences)
# ---------------------------------------------------------------------------


def test_slot_allocator_first_fill_is_ordered():
    s = SlotAllocator(4)
    assert [s.alloc() for _ in range(4)] == [0, 1, 2, 3]
    assert s.alloc() is None
    assert s.free_count == 0 and len(s.in_use) == 4


def test_slot_allocator_reuses_most_recently_freed_first():
    s = SlotAllocator(4)
    for _ in range(3):
        s.alloc()
    s.free(1)
    s.free(0)
    assert s.alloc() == 0
    assert s.alloc() == 1
    assert s.alloc() == 3
    assert s.free_count == 0


def test_slot_allocator_counts_evictions_separately():
    s = SlotAllocator(2)
    a, b = s.alloc(), s.alloc()
    s.free(a)
    assert s.evictions == 0
    s.evict(b)
    assert s.evictions == 1
    assert s.free_count == 2


def test_admission_is_fifo_across_waves():
    q = RequestQueue()
    slots = SlotAllocator(2)
    reqs = [q.submit(np.zeros(4, np.int32), max_new_tokens=3) for _ in range(5)]
    wave1 = plan_admission(q, slots)
    assert [r.rid for r in wave1] == [reqs[0].rid, reqs[1].rid]
    assert [r.slot for r in wave1] == [0, 1]
    assert len(q) == 3
    slots.free(wave1[1].slot)
    slots.free(wave1[0].slot)
    wave2 = plan_admission(q, slots)
    assert [r.rid for r in wave2] == [reqs[2].rid, reqs[3].rid]
    assert [r.slot for r in wave2] == [0, 1]
    assert len(q) == 1
    assert plan_admission(q, slots) == []
    assert len(q) == 1


def test_admission_partial_wave_when_queue_short():
    q = RequestQueue()
    slots = SlotAllocator(4)
    q.submit(np.zeros(4, np.int32), max_new_tokens=1)
    wave = plan_admission(q, slots)
    assert len(wave) == 1 and wave[0].slot == 0
    assert slots.free_count == 3


# ---------------------------------------------------------------------------
# End to end: tests/test_serve_elastic.py's scenario on the port
# ---------------------------------------------------------------------------

N_SLOTS, PLEN, GEN, MAX_SEQ = 4, 16, 10, 32
TRACE = [((1, 2), 3.0), ((1, 1), 6.0)]


def _pc(dp, tp):
    return configs.ParallelConfig(dp=dp, pp=1, tp=tp, ep=1)


def _jpc(dp, tp):
    return jax_configs.ParallelConfig(dp=dp, pp=1, tp=tp, ep=1)


@pytest.fixture(scope="module")
def runs():
    """The port's uninterrupted and resized sessions and the JAX package's
    uninterrupted one, all from the JAX package's seed-0 weights."""
    cfg = configs.get_config("qwen3-1.7b").reduced()
    jcfg = jax_configs.get_config("qwen3-1.7b").reduced()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PLEN) for _ in range(6)]
    jparams = jax_tree_paths(JM.init_params(jcfg, jax.random.key(0)))

    def port_run(trace):
        params = params_from_jax(jparams, cfg, "cpu")
        ctrl = LiveServeController(cfg, _pc(2, 2), N_SLOTS, PLEN, MAX_SEQ, sync_prepare=True,
                                   device="cpu", params=params)
        sess = ServeSession(ctrl, step_time_s=1.0)
        for p in prompts:
            sess.submit(p, GEN)
        results, metrics = sess.run([ResizeEvent(time_s=t, target=_pc(*pc)) for pc, t in trace])
        recs, pool = list(ctrl.records), ctrl.world_pool
        ctrl.shutdown()
        return results, metrics, recs, pool

    jctrl = JaxController(jcfg, _jpc(1, 1), N_SLOTS, PLEN, MAX_SEQ, sync_prepare=True, seed=0)
    jsess = JaxSession(jctrl, step_time_s=1.0)
    for p in prompts:
        jsess.submit(p, GEN)
    jax_results, _ = jsess.run([])
    jctrl.shutdown()
    return {"plain": port_run([]), "resized": port_run(TRACE), "jax": jax_results, "jcfg": jcfg}


def test_uninterrupted_port_session_equals_the_jax_session(runs):
    results, metrics, recs, _ = runs["plain"]
    assert metrics.dropped == 0 and len(results) == 6 and metrics.waves == 2
    assert not recs
    assert results == runs["jax"]


def test_generation_survives_resizes_token_for_token(runs):
    results, metrics, _, _ = runs["resized"]
    assert metrics.dropped == 0 and len(results) == 6
    assert results == runs["plain"][0]
    assert results == runs["jax"]


def test_resize_records_match_the_jax_scenario(runs):
    _, metrics, recs, pool = runs["resized"]
    assert metrics.commits == 2 and len(recs) == 2
    r1, r2 = recs
    assert r1.outcome == r2.outcome == "committed"
    assert r1.cut_step > 0  # mid-generation, not at a wave boundary
    # tp-preserving: the live cache adopted in place, nothing executed
    assert r1.cache_resident_layers > 0 and r1.reused_layers > 0
    assert r1.executed_bytes == 0 and r1.plan_network_bytes == 0
    # tp-changing: bytes stream through the engine
    assert r2.executed_bytes > 0 and r2.plan_network_bytes > 0
    assert r2.cache_resident_layers == 0
    assert pool.stats.puts >= 3, pool.stats
    # each record's planned network bytes are the JAX planner's
    jspecs = JC.serve_state_specs(runs["jcfg"], N_SLOTS, MAX_SEQ, cache_dtype="float32")
    for rec, (a, b) in zip(recs, [((2, 2), (1, 2)), ((1, 2), (1, 1))]):
        want = JC.serve_plan(runs["jcfg"], jspecs, _jpc(*a), _jpc(*b))
        assert rec.plan_network_bytes == want.network_bytes
        assert rec.plan_local_bytes == want.local_bytes
        assert rec.skipped_bytes == want.resident_bytes


def test_controller_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiveServeController(cfg, _pc(1, 1), 2, 8, 16)
