"""The rest of ``LiveRController``'s lifecycle in the port, against the JAX
package's controller, on the CPU at the reduced size (qwen3-1.7b, seq 32,
batch 8, the same weights through ``params_from_jax``):

- the warm world pool: an A -> B -> A round trip whose return leg is a warm
  hit and whose params are bitwise those of the same run without a pool
  (``tests/test_world_pool.py``); prefetch then resize (joining the
  speculative build), the prefetch dedupe, a cancelled shadow deposited
  without its buffers, a retired world served back warm, and a poisoned
  warm world falling back to a cold build;
- the mid-stream retarget (``tests/test_scheduler.py``): the commit lands
  at the step of a direct resize from the same trigger step, reuses the
  superseded session's layers, adopts its carries without a copy, and
  delivers the JAX byte oracle's state of the cut;
- the deadline escalation: ``fell_back``, the pre-copy accounting kept,
  None when nothing is ready;
- the alias rule of ``OverlapSession.adopt`` at the session level, on the
  lossless wire and under ``WirePolicy()``;
- no second set of destination tensors at a retarget or an escalation,
  nor at a retarget or cancel that comes while the first Prepare is still
  building or allocating;
- the bookkeeping of the three scenarios, run by the JAX controller in a
  subprocess with 8 host devices: the same records and commit steps, and
  losses within ``RESHAPE_PARITY_TOL``.

On one device every move is lossless and the kernels are the same, so each
scenario's losses and params are bitwise those of a run never resized."""

from __future__ import annotations

import inspect
import json
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from conftest import RESHAPE_PARITY_TOL, run_with_devices
from repro.configs import get_config as jax_get_config
from repro.configs.base import ParallelConfig as JaxP
from repro.core.reshard import plan_state_transfer as jax_plan_state_transfer
from repro.core.resource_view import view_of
from repro.core.streaming import allocate_destination, execute_plan, materialize_rank
from repro_torch import configs
from repro_torch.core import controller as C
from repro_torch.core.controller import LiveRController
from repro_torch.core.reshard import named_state_leaves, plan_state_transfer
from repro_torch.core.world_pool import WorldPool
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.reshard import OverlapSession, WirePolicy, tune_operating_point
from repro_torch.reshard import executors as EX
from repro_torch.reshard.overlap import shares_storage
from repro_torch.utils.pytree import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

CPU = torch.device("cpu")
OPT = dict(learning_rate=1e-3, warmup_steps=5)
P = configs.ParallelConfig


# ---------------------------------------------------------------------------
# The scenarios: the controller's API only, so that the JAX subprocess runs
# the same functions (their source is sent to it). ``hook(point, ctrl)``
# lets a port test look in at named points.
# ---------------------------------------------------------------------------


def _rec(r):
    return [r.outcome, r.src, r.dst, r.warm_hit, r.prepare_source, r.reused_layers]


def scenario_warm_round_trip(make, P, pooled=True, hook=lambda point, c: None):
    A, B = P(dp=2, tp=2), P(dp=2, tp=4)
    c = make(pool_capacity=2 if pooled else None)
    hook("start", c)
    losses, steps = c.train_steps(2), []
    for target in (B, A):
        c.request_resize(target)
        c.wait_shadow_ready()
        losses += c.train_steps(1)  # the stop-copy commit at the boundary
        steps.append(c.step)
        losses += c.train_steps(2)
    return c, {"records": [_rec(r) for r in c.records], "steps": steps, "losses": losses}


def scenario_prefetch(make, P, hook=lambda point, c: None):
    import time

    A, T, Bp = P(dp=2, tp=2), P(dp=1, tp=4), P(dp=1, tp=2)
    c = make(pool_capacity=3)
    losses = c.train_steps(1)
    hook("prefetch", c)
    out = {"prefetch": [c.prefetch_world(T), c.prefetch_world(T)]}  # the second: already building
    hook("prefetched", c)
    c._spec_builders[c.pool_key(T)].result(120)
    c.request_resize(T)  # joins the speculative build (no boundary has harvested it)
    c.wait_shadow_ready()
    losses += c.train_steps(1)
    out["retired_pooled"] = c.world_pool.contains(c.pool_key(A))
    c.request_resize(A)  # the retired world, warm
    c.wait_shadow_ready()
    losses += c.train_steps(1)
    c.request_resize(Bp)
    c.wait_shadow_ready()
    c.cancel_resize()  # the abandoned shadow goes to the pool
    t0 = time.time()
    while not c.world_pool.contains(c.pool_key(Bp)) and time.time() - t0 < 60:
        time.sleep(0.02)
    out["deposited"] = c.world_pool.contains(c.pool_key(Bp))
    hook("deposited", c)
    c.request_resize(Bp)
    c.wait_shadow_ready()
    losses += c.train_steps(2)
    key = c.pool_key(A)  # retired warm by the Bp commit
    warm = c.world_pool.take(key)
    c.world_pool.put(key, warm)  # keep a reference to it

    def poisoned(*args, **kwargs):
        raise RuntimeError("poisoned warm world")

    c._refresh_pooled = poisoned
    c.request_resize(A)
    c.wait_shadow_ready()  # must not raise: a cold build takes over
    losses += c.train_steps(1)
    out["poisoned_released"] = warm.released
    out.update(records=[_rec(r) for r in c.records], steps=[c.step], losses=losses)
    return c, out


def scenario_retarget(make, P, hook=lambda point, c: None):
    SRC, T1, T2 = P(dp=2, tp=2), P(dp=2, tp=4), P(dp=1, tp=4)
    c = make(pool_capacity=2, overlap="stream", stream_k=1)
    losses = c.train_steps(2)
    c.prefetch_world(T2)
    c._spec_builders[c.pool_key(T2)].result(120)
    c.request_resize(T1)
    c.wait_shadow_ready()
    losses += c.train_steps(1)  # the boundary harvests T2; T1's session streams one round
    hook("before_retarget", c)
    c.retarget_resize(T2)
    c.wait_shadow_ready()
    guard = 0
    while not any(r.outcome == "committed" for r in c.records):
        hook("step", c)
        losses += c.train_steps(1)
        guard += 1
        assert guard < 50, "the retargeted resize never committed"
    steps = [c.step]
    c.request_resize(SRC)  # the retired source world, warm
    c.wait_shadow_ready()
    losses += c.train_steps(1)  # its session starts and streams one round
    hook("before_escalate", c)
    rec = c.escalate_commit()
    steps.append(c.step)
    hook("escalated", c)
    out = {"escalated": [rec.outcome, rec.mode, rec.precopy_bytes > 0, rec.executed_bytes > 0]}
    losses += c.train_steps(2)
    out["idle_escalate"] = c.escalate_commit() is None
    out.update(records=[_rec(r) for r in c.records], steps=steps, losses=losses)
    return c, out


SCENARIOS = (scenario_warm_round_trip, scenario_prefetch, scenario_retarget)

_JAX_DRIVER = """
import json, time
import numpy as np
from repro.configs import get_config
from repro.configs.base import ParallelConfig as P
from repro.core.controller import LiveRController
from repro.core.world_pool import WorldPool
from repro.optim import AdamWConfig
from repro.utils.pytree import tree_paths

cfg = get_config("qwen3-1.7b").reduced()

def make(pool_capacity=None, **kw):
    return LiveRController(cfg, P(dp=2, tp=2), AdamWConfig(learning_rate=1e-3, warmup_steps=5), seq_len=32,
                           global_batch=8, seed=0, sync_compile=True,
                           world_pool=WorldPool(capacity=pool_capacity) if pool_capacity else None, **kw)

def save_weights(point, c):
    if point == "start":  # every controller starts from seed 0's weights
        np.savez(WEIGHTS, **dict(tree_paths(c.gathered_params())))

out = {}
for fn in (scenario_warm_round_trip, scenario_prefetch, scenario_retarget):
    t0 = time.time()
    _, out[fn.__name__] = fn(make, P, hook=save_weights if fn is scenario_warm_round_trip else lambda point, c: None)
    out[fn.__name__]["seconds"] = time.time() - t0
print("JAX_SCENARIOS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The three scenarios on the JAX controller (8 host devices, dp2tp2
    start), and its initial weights for the port."""
    weights = tmp_path_factory.mktemp("lifecycle") / "weights.npz"
    code = "\n".join([f"WEIGHTS = {str(weights)!r}", _rec_source(), *(inspect.getsource(f) for f in SCENARIOS),
                      _JAX_DRIVER])
    out = run_with_devices(code, n_devices=8)
    line = next(l for l in out.splitlines() if l.startswith("JAX_SCENARIOS "))
    with np.load(weights) as z:
        flat = {k: z[k] for k in z.files}
    return json.loads(line[len("JAX_SCENARIOS "):]), params_from_jax(flat, configs.get_config("qwen3-1.7b").reduced(), "cpu")


def _rec_source() -> str:
    return inspect.getsource(_rec)


def _maker(params):
    cfg = configs.get_config("qwen3-1.7b").reduced()

    def make(pool_capacity=None, **kw):
        return LiveRController(cfg, P(dp=2, tp=2), AdamWConfig(**OPT), seq_len=32, global_batch=8, device="cpu",
                               params=params, world_pool=WorldPool(capacity=pool_capacity) if pool_capacity else None,
                               **kw)

    return make


@pytest.fixture(scope="module")
def control(jax_run):
    """The port's run never resized, from the same weights: its losses and
    its params after each step."""
    _, params = jax_run
    c = _maker(params)()
    losses, snapshots = [], []
    for _ in range(16):
        losses += c.train_steps(1)
        snapshots.append(tree_paths(c.gathered_params()))
    return losses, snapshots


def _assert_params_equal(ctrl, snapshot):
    _assert_params_equal_at(tree_paths(ctrl.gathered_params()), snapshot)


def _assert_matches_jax(jax_out, out):
    assert out["records"] == jax_out["records"]
    assert out["steps"] == jax_out["steps"]
    assert len(out["losses"]) == len(jax_out["losses"])
    np.testing.assert_allclose(out["losses"], jax_out["losses"], atol=RESHAPE_PARITY_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the warm world pool
# ---------------------------------------------------------------------------


def test_warm_round_trip_hits_the_pool_and_is_bitwise_the_unpooled_run(jax_run, control):
    jax_out, params = jax_run
    make = _maker(params)
    warm, out = scenario_warm_round_trip(make, P)
    cold, cold_out = scenario_warm_round_trip(make, P, pooled=False)
    _assert_matches_jax(jax_out["scenario_warm_round_trip"], out)
    assert [r[3] for r in out["records"]] == [False, True]  # the return leg is a warm hit
    assert [r[4] for r in out["records"]] == ["cold", "pool"]
    assert not any(r[3] for r in cold_out["records"])
    assert warm.world_pool.stats.hits == 1 and warm.world_pool.stats.puts >= 2
    # the warm Prepare built nothing: it planned and allocated
    r_cold, r_warm = warm.records
    assert 0 < r_warm.prepare_s and 0 < r_cold.prepare_s
    _assert_params_equal(warm, tree_paths(cold.gathered_params()))
    losses, snapshots = control
    assert out["losses"] == cold_out["losses"] == losses[: len(out["losses"])]
    _assert_params_equal(warm, snapshots[warm.step - 1])


def test_prefetch_join_deposit_and_poisoned_refresh(jax_run, control):
    jax_out, params = jax_run
    seen = {}
    gate = threading.Event()

    def hook(point, c):
        # the speculative build waits until both prefetch calls returned:
        # a build on the CPU can end in between, and the second call would
        # then harvest it into the pool (the JAX one compiles for seconds)
        if point == "prefetch":
            build = c._build_world
            c._build_world = lambda target: (gate.wait(60), build(target))[1]
        if point == "prefetched":
            gate.set()
            del c._build_world
        if point == "deposited":
            handle = c.world_pool.peek(c.pool_key(P(dp=1, tp=2)))
            seen["deposited"] = (handle.buffers, handle.plan_bundle, handle.released, handle.step_fn is not None)

    c, out = scenario_prefetch(_maker(params), P, hook)
    _assert_matches_jax(jax_out["scenario_prefetch"], out)
    assert out["prefetch"] == [True, False]
    assert out["retired_pooled"] and out["deposited"] and out["poisoned_released"]
    # a pooled world keeps its functions and no tensor
    assert seen["deposited"] == ({}, None, False, True)
    assert [r[4] for r in out["records"]] == ["speculative_join", "pool", "pool", "cold"]
    assert [r[0] for r in out["records"]] == ["committed"] * 4
    assert not c.prefetch_world(c.world.parallel)  # never the active world
    losses, snapshots = control
    assert out["losses"] == losses[: len(out["losses"])]
    _assert_params_equal(c, snapshots[c.step - 1])


# ---------------------------------------------------------------------------
# retarget and escalation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def retarget_run(jax_run):
    """The retarget scenario on the port, looked into: the adoption, the
    retarget's Prepare and every destination the executors allocated, the
    cut and the state delivered at the retargeted commit."""
    _, params = jax_run
    seen = {"adopt": [], "prepare": [], "fresh": [], "cut": None, "delivered": None}
    orig_adopt, orig_buffers, orig_carry, orig_rebuild = (
        OverlapSession.adopt, C.state_buffers, EX.LiveExecutor._dst_carry, C.rebuild_state)
    ctrl = {}

    def adopt(self, carries, streamed_at, live):
        n = orig_adopt(self, carries, streamed_at, live)
        seen["adopt"].append((dict(carries), {k: self.executor.dst.get(k) for k in carries}, list(live.values()), n))
        seen["adopt_executor"] = self.executor
        return n

    def buffers(specs, plan, device, reuse=None):
        out = orig_buffers(specs, plan, device, reuse=reuse)
        seen["prepare"].append((dict(reuse) if reuse is not None else None, dict(out)))
        return out

    def carry(self, name):
        if name not in self.dst and name not in self.dst_buffers:
            seen["fresh"].append((seen.get("phase"), self, name))
        return orig_carry(self, name)

    def rebuild(named, params_like, opt_like, extras):
        if seen["delivered"] is None:
            seen["delivered"] = {k: v.detach().clone().numpy() for k, v in named.items()}
        return orig_rebuild(named, params_like, opt_like, extras)

    def hook(point, c):
        ctrl["c"] = c
        seen["phase"] = point
        if point == "step" and c._commit_armed and seen["cut"] is None:
            named, _ = named_state_leaves(c.params, c.opt_state)
            seen["cut"] = {k: v.detach().clone().numpy() for k, v in named.items()}
        if point == "before_retarget":
            seen["old_dst"] = dict(c._session.executor.dst)
            seen["streamed_at"] = dict(c._session.streamed_at)
        if point == "before_escalate":
            seen["session_precopy"] = c._session.report.precopy_bytes
        if point == "escalated":
            seen["escalated_params"] = tree_paths(c.gathered_params())

    OverlapSession.adopt, C.state_buffers, EX.LiveExecutor._dst_carry, C.rebuild_state = adopt, buffers, carry, rebuild
    try:
        c, out = scenario_retarget(_maker(params), P, hook)
    finally:
        OverlapSession.adopt, C.state_buffers, EX.LiveExecutor._dst_carry, C.rebuild_state = (
            orig_adopt, orig_buffers, orig_carry, orig_rebuild)
    return c, out, seen


def test_retarget_and_escalation_match_the_jax_controller(jax_run, retarget_run):
    jax_out, _ = jax_run
    _, out, _ = retarget_run
    _assert_matches_jax(jax_out["scenario_retarget"], out)
    assert out["escalated"] == jax_out["scenario_retarget"]["escalated"]
    assert [r[0] for r in out["records"]] == ["retargeted", "committed", "fell_back"]
    assert out["records"][1][4] == "pool" and out["records"][2][3]  # T2 prefetched, the source warm


def test_retarget_commits_at_the_direct_step_and_is_bitwise_the_unresized_run(jax_run, retarget_run, control):
    _, params = jax_run
    c, out, seen = retarget_run
    rec = next(r for r in c.records if r.outcome == "committed")
    assert rec.reused_layers >= 1  # the stream did not restart
    direct = _maker(params)(overlap="stream", stream_k=1)
    direct.train_steps(2)
    direct.request_resize(P(dp=1, tp=4))
    direct.wait_shadow_ready()
    while not direct.records:
        direct.train_steps(1)
        assert direct.step < 50
    assert direct.step == out["steps"][0]
    losses, snapshots = control
    _assert_params_equal(direct, snapshots[direct.step - 1])
    assert out["losses"] == losses[: len(out["losses"])]
    _assert_params_equal(c, snapshots[c.step - 1])


def test_retarget_adopts_the_carries_without_a_copy(retarget_run):
    c, out, seen = retarget_run
    [(carries, dst, live, n)] = seen["adopt"]
    assert n >= 1 and carries
    # the superseded session aliased no live tensor (it moved every tensor),
    # so every carry was handed on and adopted as the same object
    assert carries.keys() == seen["old_dst"].keys()
    for name, carry in carries.items():
        assert carry is seen["old_dst"][name] and dst[name] is carry, name
        assert not shares_storage(carry, live), name
    # the retarget's Prepare took every reusable tensor and allocated none
    reused = [(reuse, got) for reuse, got in seen["prepare"] if reuse is not None]
    assert len(reused) == 1
    reuse, got = reused[0]
    assert carries.keys() <= reuse.keys()
    assert all(got[n] is reuse[n] for n in got), "the retarget's Prepare allocated a second tensor"
    # nor did the successor session's executor or the escalation's stop-copy
    assert [f[2] for f in seen["fresh"] if f[1] is seen["adopt_executor"] or f[0] == "before_escalate"] == []


def test_retarget_delivers_the_jax_byte_oracle_of_the_cut(retarget_run):
    _, _, seen = retarget_run
    cut, delivered = seen["cut"], seen["delivered"]
    assert cut and delivered
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    SRC, T2 = JaxP(dp=2, tp=2), JaxP(dp=1, tp=4)
    specs, plan = jax_plan_state_transfer(jcfg, SRC, T2)
    src = {r: materialize_rank(specs, SRC, r, cut) for r in range(SRC.world_size)}
    dst = {r: allocate_destination(specs, T2, r) for r in range(T2.world_size)}
    execute_plan(plan, src, dst, staging_bytes=1 << 20)
    assert delivered.keys() == {s.name for s in specs}
    for s in specs:
        glob = np.zeros(s.shape, np.dtype(s.dtype))
        for r in range(T2.world_size):
            v = view_of(s, T2, r)
            glob[tuple(slice(lo, hi) for lo, hi in v.bounds)] = dst[r].shards[s.name]
        np.testing.assert_array_equal(delivered[s.name], glob, err_msg=s.name)


def test_escalation_falls_back_keeps_the_precopy_and_is_bitwise(retarget_run, control):
    c, out, seen = retarget_run
    rec = c.records[-1]
    assert rec.outcome == "fell_back" and rec.mode == "live" and rec.dst == "dp2xpp1xtp2"
    assert rec.precopy_bytes == seen["session_precopy"] > 0 and rec.executed_bytes > 0
    assert rec.reused_layers >= rec.resident_layers
    assert out["idle_escalate"]
    assert not c.reconfig_pending and c.world.parallel == P(dp=2, tp=2)
    losses, snapshots = control
    # the escalated commit moved the cut at its step exactly, and training
    # went on from it as if never resized
    _assert_params_equal_at(seen["escalated_params"], snapshots[out["steps"][1] - 1])
    _assert_params_equal(c, snapshots[c.step - 1])
    assert out["losses"] == losses[: len(out["losses"])]


def _assert_params_equal_at(got, want):
    assert got.keys() == want.keys()
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


@pytest.mark.parametrize("verb", ["retarget", "cancel"])
@pytest.mark.parametrize("held_in", ["alloc", "build"])
def test_a_prepare_superseded_mid_build_leaves_one_destination_set(jax_run, control, monkeypatch, verb, held_in):
    """A retarget (or a cancel and a new request) while the first Prepare is
    still building its world (``build``) or allocating its destination
    tensors (``alloc``): the superseded build allocates nothing once it
    sees that, and the new Prepare allocates only after it has ended and
    dropped what it held, so no two sets are ever live together."""
    _, params = jax_run
    T1, T2 = P(dp=2, tp=4), P(dp=1, tp=4)
    entered, gate = threading.Event(), threading.Event()
    allocated, live_before = [], []  # weakrefs to every tensor allocated; per call, how many were alive
    orig = C.state_buffers

    def buffers(specs, plan, device, reuse=None):
        live_before.append(sum(r() is not None for r in allocated))
        out = orig(specs, plan, device, reuse=reuse)
        allocated.extend(weakref.ref(t) for t in out.values())
        if held_in == "alloc" and len(live_before) == 1:
            entered.set()
            gate.wait(60)  # the first set stays in flight until the test lets it go
        return out

    monkeypatch.setattr(C, "state_buffers", buffers)
    c = _maker(params)(pool_capacity=2, overlap="stream", stream_k=1)
    losses = c.train_steps(2)
    if held_in == "build":
        build = c._build_world

        def held(target):
            if target == T1:
                entered.set()
                gate.wait(60)
            return build(target)

        c._build_world = held
    c.request_resize(T1)
    assert entered.wait(60)
    first = c._builder
    if verb == "retarget":
        c.retarget_resize(T2)
    else:
        c.cancel_resize()
        c.request_resize(T2)
    time.sleep(1.0)  # on the CPU the new Prepare plans well within this
    assert not c._builder.ready and first.running, "the new Prepare did not wait for the superseded build"
    assert len(live_before) == (1 if held_in == "alloc" else 0)
    gate.set()
    c.wait_shadow_ready(60)
    assert not first.running
    # the new set was allocated with nothing of the first alive, and the
    # superseded build allocated only if it was already doing so
    assert live_before == ([0, 0] if held_in == "alloc" else [0])
    assert all(r() is None for r in allocated[: len(allocated) - len(c._builder.result().buffers)])
    pooled = c.world_pool.peek(c.pool_key(T1))
    assert pooled is not None and pooled.buffers == {} and pooled.plan_bundle is None
    while not any(r.outcome == "committed" for r in c.records):
        losses += c.train_steps(1)
        assert c.step < 16, "the resize never committed"
    want = ["retargeted", "committed"] if verb == "retarget" else ["committed"]
    assert [r.outcome for r in c.records] == want
    assert c.records[-1].dst == T2.describe() and c.records[-1].prepare_source == "cold"
    control_losses, snapshots = control
    assert losses == control_losses[: len(losses)]
    _assert_params_equal(c, snapshots[c.step - 1])


def test_verbs_of_an_idle_controller(jax_run):
    _, params = jax_run
    c = _maker(params)(pool_capacity=2, overlap="stream", stream_k=1)
    assert c.escalate_commit() is None  # nothing in flight
    c.retarget_resize(P(dp=1, tp=4))  # nothing to supersede: a plain request
    assert c.reconfig_pending and not [r for r in c.records if r.outcome == "retargeted"]
    c.wait_shadow_ready(60)
    c.cancel_resize()
    assert not c.prefetch_world(P(dp=2, tp=2))  # the active world
    assert not _maker(params)().prefetch_world(P(dp=1, tp=4))  # no pool


# ---------------------------------------------------------------------------
# the alias rule, at the session level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", [None, WirePolicy()], ids=["lossless", "int8_moments"])
def test_adopt_refuses_a_carry_that_aliases_a_live_tensor(policy):
    """A session on dp2tp2 -> dp1tp4 adopts the q/k norms by aliasing the
    live tensors (every cell resident). A successor on dp2tp2 -> dp2tp4,
    which moves them, must not adopt those carries, or its scatters (and
    under ``WirePolicy()`` its int8 dequant scatters) would write into the
    live state. A view of a live tensor is refused too; the layers they
    touch re-stream."""
    cfg = configs.get_config("qwen3-1.7b").reduced()
    SRC, T1, T2 = P(dp=2, tp=2), P(dp=2, tp=4), P(dp=1, tp=4)
    specs, plan2 = plan_state_transfer(cfg, SRC, T2)
    _, plan1 = plan_state_transfer(cfg, SRC, T1)
    rng = np.random.default_rng(0)
    live = {s.name: torch.from_numpy(rng.normal(size=s.shape).astype(np.float32)) for s in specs}
    frozen = {n: t.clone() for n, t in live.items()}
    old = OverlapSession(specs, plan2, {}, [CPU] * 4, [CPU] * 4, 1 << 20, stream_k=2, wire_policy=policy)
    while not old.done_precopy:
        old.stream_next(live, step=0)
    aliased = {n for n, t in old.executor.dst.items() if t is live[n]}
    assert aliased and all("q_norm" in n or "k_norm" in n for n in aliased)
    carries = dict(old.executor.dst)
    view_name = "params/embed/tok"
    carries[view_name] = live[view_name][:]  # a view: same storage
    new = OverlapSession(specs, plan1, {}, [CPU] * 4, [CPU] * 8, 1 << 20, stream_k=2, wire_policy=policy)
    n = new.adopt(carries, dict(old.streamed_at), live)
    for name in aliased | {view_name}:
        assert new.executor.dst.get(name) is not carries[name], name
    for name in carries.keys() - aliased - {view_name}:
        assert new.executor.dst[name] is carries[name], name
    # every block layer touches the norms, and layer -1 the embedding
    assert n == 0 and new.pending == new.engine.layers()
    moved = {n: v * 0.5 + 1.0 for n, v in live.items()}
    while not new.done_precopy:
        new.stream_next(moved, step=1)
    new.resync(moved, step=2)
    for name, t in live.items():
        assert torch.equal(t, frozen[name]), f"{name}: the successor wrote into the live state"
    assert not any(shares_storage(new.executor.dst[k], list(live.values())) for k in aliased | {view_name})


def test_an_operating_point_shapes_one_reconfiguration(jax_run, control):
    """``request_resize(operating_point=)`` sets that reconfiguration's
    ``stream_k`` and staging budget and is recorded with it; the next one
    runs on the constructor's again."""
    _, params = jax_run
    c = _maker(params)(overlap="stream", stream_k=4)
    c.train_steps(1)
    op = tune_operating_point(1 << 20, 5, 0.0, 1e6)
    assert op.source == "measured" and op.stream_k != 4
    c.request_resize(P(dp=1, tp=4), operating_point=op)
    c.wait_shadow_ready(60)
    c.train_steps(1)
    assert c._session.stream_k == op.stream_k and c._session.executor.staging_bytes == op.staging_bytes
    while len(c.records) < 1:
        c.train_steps(1)
    assert c.records[0].operating_point == op.to_dict()
    c.request_resize(P(dp=2, tp=2))
    c.wait_shadow_ready(60)
    c.train_steps(1)
    assert c._session.stream_k == 4
    while len(c.records) < 2:
        c.train_steps(1)
    assert c.records[1].operating_point is None
    losses, snapshots = control
    _assert_params_equal(c, snapshots[c.step - 1])
