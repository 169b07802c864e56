"""The lifecycle of ``LiveRController`` on per-rank worlds
(``core/rank_controller.py``), in one gloo world of 4 CPU rank processes,
against the JAX controller and against per-rank controls.

Reduced qwen3-1.7b (seq 32, batch 8, f32), its weights the JAX package's
seed-0 init through ``models.convert.params_from_jax``; every world fits
in 4 ranks. Three scenarios, run by the controller's API only, so that the
JAX controller runs the same functions in a subprocess with 8 host
devices:

- a warm round trip dp2tp2 -> dp1tp4 -> dp2tp2 by stop-copy, whose return
  leg hits the pool on every rank;
- a prefetch of dp1tp4 joined at the resize, and the retired world served
  back from the pool;
- from dp1tp4, a stream to dp2tp2 (one layer a round) retargeted after its
  first round to dp1tp2, served by a prefetch and adopting the streamed
  carries where a rank's view is unchanged (the same tensors, no copy, no
  second set); then a stream back to dp1tp4 escalated to a stop-copy
  after one round (``fell_back``, the pre-copy kept).

The records and commit steps equal the JAX controller's and the losses
are within ``RESHAPE_PARITY_TOL`` of its; the params are bitwise those of
a per-rank control that takes the same worlds' steps at the same steps and
carries the state by plain copies.

The control plane: ``ElasticScheduler`` -> ``WireEndpoint`` ->
``RankEndpoint`` on rank 0, every rank's ``ControllerEndpoint`` handling
the broadcast frames, over a trace on fixed steps (a stream to dp4tp1, its
retarget to dp1tp4 a step later, a fail-stop of ranks 0 and 1 into dp1tp2
from donors 2 and 3). Every rank handles the same frames; rank 0's command
frames equal those the JAX scheduler sends for the same trace to
``tests/test_torch_control_plane.py``'s stand-in controller, set to commit
where the ranks committed; and the run is bitwise the same commands made
directly on the ranks.

The ranks run port code only; the JAX package is imported by the test
process and its subprocess."""

from __future__ import annotations

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

from conftest import RESHAPE_PARITY_TOL, run_with_devices
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig as P
from repro_torch.core.resource_view import build_tensor_specs
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.utils.pytree import tree_from_paths, tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

CFG = get_config("qwen3-1.7b").reduced()
OPT = AdamWConfig(learning_rate=1e-3, warmup_steps=5)
SEQ, BATCH, NPROC = 32, 8, 4
WORLDS = [P(dp=2, tp=2), P(dp=1, tp=4), P(dp=1, tp=2), P(dp=4, tp=1)]


# ---------------------------------------------------------------------------
# The scenarios: the controller's API only (their source is sent to the JAX
# subprocess). ``make(start, pool_capacity, **kw)``; ``hook(point, ctrl)``
# lets a rank look in at named points.
# ---------------------------------------------------------------------------


def _rec(r):
    return [r.outcome, r.src, r.dst, r.warm_hit, r.prepare_source, r.reused_layers]


def scenario_round_trip(make, P, hook=lambda point, c: None):
    A, B = P(dp=2, tp=2), P(dp=1, tp=4)
    c = make(A, pool_capacity=2)
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
    A, T = P(dp=2, tp=2), P(dp=1, tp=4)
    c = make(A, pool_capacity=2)
    losses = c.train_steps(1)
    started = c.prefetch_world(T)
    c._spec_builders[c.pool_key(T)].result(120)  # ended; no boundary has harvested it
    c.request_resize(T)  # joins the speculative build
    c.wait_shadow_ready()
    losses += c.train_steps(1)
    steps = [c.step]
    retired = c.world_pool.contains(c.pool_key(A))
    c.request_resize(A)  # the retired world, warm
    c.wait_shadow_ready()
    losses += c.train_steps(1)
    steps.append(c.step)
    losses += c.train_steps(1)
    return c, {"records": [_rec(r) for r in c.records], "steps": steps, "losses": losses,
               "prefetch": [started, retired]}


def scenario_retarget(make, P, hook=lambda point, c: None):
    SRC, T1, T2 = P(dp=1, tp=4), P(dp=2, tp=2), P(dp=1, tp=2)
    c = make(SRC, pool_capacity=2, overlap="stream", stream_k=1)
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
    out = {"escalated": [rec.outcome, rec.mode, rec.precopy_bytes > 0, rec.executed_bytes > 0]}
    losses += c.train_steps(2)
    out["idle_escalate"] = c.escalate_commit() is None
    out.update(records=[_rec(r) for r in c.records], steps=steps, losses=losses)
    return c, out


SCENARIOS = (scenario_round_trip, scenario_prefetch, scenario_retarget)

_JAX_DRIVER = """
import json
import numpy as np
from repro.configs import get_config
from repro.configs.base import ParallelConfig as P
from repro.core.controller import LiveRController
from repro.core.world_pool import WorldPool
from repro.optim import AdamWConfig
from repro.utils.pytree import tree_paths

cfg = get_config("qwen3-1.7b").reduced()

def make(start, pool_capacity=None, **kw):
    return LiveRController(cfg, start, AdamWConfig(learning_rate=1e-3, warmup_steps=5), seq_len=32, global_batch=8,
                           seed=0, sync_compile=True,
                           world_pool=WorldPool(capacity=pool_capacity) if pool_capacity else None, **kw)

def save_weights(point, c):
    if point == "start":
        np.savez(WEIGHTS, **dict(tree_paths(c.gathered_params())))

out = {}
for fn in (scenario_round_trip, scenario_prefetch, scenario_retarget):
    _, out[fn.__name__] = fn(make, P, hook=save_weights if fn is scenario_round_trip else lambda point, c: None)
print("JAX_SCENARIOS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The scenarios on the JAX controller (8 host devices) and its seed-0
    weights for the ranks."""
    weights = tmp_path_factory.mktemp("rank_lifecycle") / "weights.npz"
    code = "\n".join([f"WEIGHTS = {str(weights)!r}", inspect.getsource(_rec),
                      *(inspect.getsource(f) for f in SCENARIOS), _JAX_DRIVER])
    out = run_with_devices(code, n_devices=8)
    line = next(l for l in out.splitlines() if l.startswith("JAX_SCENARIOS "))
    with np.load(weights) as z:
        flat = {k: z[k] for k in z.files}
    return json.loads(line[len("JAX_SCENARIOS "):]), params_from_jax(flat, CFG, "cpu")


# ---------------------------------------------------------------------------
# On the ranks
# ---------------------------------------------------------------------------


def _by_hand(pool, rank: int, specs, named: dict, a, b) -> dict:
    """``named`` (this rank's shards on ``a``) on ``b``: every tensor
    assembled on rank 0, broadcast, and cut by ``shard_of``. Plain tensor
    copies, no plan."""
    import torch.distributed as dist

    from repro_torch.core.rank_controller import gather_each
    from repro_torch.core.resource_view import shard_of

    out = {}
    for spec, whole in gather_each(pool, named, a, specs, "cpu"):
        if whole is None:
            whole = torch.empty(spec.shape, dtype=getattr(torch, spec.dtype))
        dist.broadcast(whole, 0)
        if rank < b.world_size and (shard := shard_of(whole, spec, b, rank)) is not None:
            out[spec.name] = shard.clone()
    return out


def _carry(pool, rank: int, specs, params, opt, a, b):
    """(params, opt_state) on ``a`` carried to ``b`` by :func:`_by_hand`,
    the step count the pool's agreed (MAX) one."""
    from repro_torch.core.reshard import named_state_leaves

    named = named_state_leaves(params, opt)[0] if params is not None else {}
    count = int(pool.agree(int(opt["count"]) if opt is not None else 0, "max"))
    moved = _by_hand(pool, rank, specs, named, a, b)
    if rank >= b.world_size:
        return None, None
    paths = [n[len("params/"):] for n in moved if n.startswith("params/")]
    opt = {c: tree_from_paths({p: moved[f"{c}/{p}"] for p in paths}) for c in ("mu", "nu")}
    opt["count"] = torch.tensor(count, dtype=torch.int32)
    return tree_from_paths({p: moved[f"params/{p}"] for p in paths}), opt


def world_control(pool, rank: int, params0, start, commits: list, steps: int) -> dict:
    """A per-rank control: the worlds of a run at the same steps, the state
    carried by :func:`_by_hand`. ``commits``: (kind, step, destination),
    ``"split"`` a split-step commit in step ``step`` (gradients on the old
    world, the update on the new), ``"stop"`` a stop-copy at the boundary
    after ``step`` steps. Returns the losses and, on rank 0, the params."""
    from repro_torch.core.rank_controller import gather_each
    from repro_torch.core.reshard import named_state_leaves
    from repro_torch.core.shadow import rank_step_fns
    from repro_torch.data import SyntheticLM
    from repro_torch.distribution.groups import make_world_groups
    from repro_torch.distribution.step import init_opt_state, shard_params

    specs = build_tensor_specs(CFG, include_optimizer=True, zero_sharding=False)
    p_specs = [s for s in specs if s.collection == "params"]
    worlds = {start, *(d for _, _, d in commits)}
    groups = make_world_groups(pool, worlds)
    fns = {p: rank_step_fns(CFG, p, OPT, 1, groups[p]) for p in worlds if groups[p].member}
    data = SyntheticLM(CFG.vocab_size, SEQ, BATCH, 0)
    world, params, opt = start, None, None
    if groups[start].member:
        params = shard_params(CFG, params0, start, rank)
        opt = init_opt_state(params)
    split = {s: d for k, s, d in commits if k == "split"}
    stop = {s: d for k, s, d in commits if k == "stop"}
    losses = []
    for i in range(steps):
        if i in stop:
            params, opt = _carry(pool, rank, specs, params, opt, world, stop[i])
            world = stop[i]
        g = groups[world]
        batch = {"tokens": torch.from_numpy(data.shard_at(i, g.dp_rank, g.dp)).long()} if g.member else None
        if i in split:
            dst = split[i]
            loss, grads = float("nan"), {}
            if g.member:
                loss, _, grads = fns[world][1](params, batch)
                grads = {f"params/{p}": x for p, x in tree_paths(grads).items()}
            moved = _by_hand(pool, rank, p_specs, grads, world, dst)
            params, opt = _carry(pool, rank, specs, params, opt, world, dst)
            world = dst
            if groups[dst].member:
                params, opt, _ = fns[dst][2](tree_from_paths({n[7:]: x for n, x in moved.items()}), opt, params)
            losses.append(float(loss) if g.member else float("nan"))
        else:
            metrics = fns[world][0](params, opt, batch)[2] if g.member else {}
            losses.append(float(metrics["loss"]) if g.member else float("nan"))
    named = named_state_leaves(params, opt)[0] if params is not None else {}
    out = {}
    for spec, whole in gather_each(pool, named, world, p_specs, "cpu"):
        if whole is not None:
            out[spec.name[len("params/"):]] = whole.numpy()
    return {"losses": losses, "params": out if rank == 0 else None}


class _Seen:
    """What a rank saw of a scenario: each commit's kind and step, the
    destination shards each Prepare took and allocated, the fresh carries
    executors allocated, the adoption."""

    def __init__(self):
        self.commits, self.prepare, self.fresh, self.adopt = [], [], [], []
        self.phase = None


def _instrumented(seen: _Seen):
    """Patch the rank controller's allocations and adoption to record into
    ``seen``; returns the undo."""
    from repro_torch.core import rank_controller as RC
    from repro_torch.reshard import OverlapSession
    from repro_torch.reshard import executors as EX

    orig = (RC.rank_state_buffers, EX.RankExecutor._dst_carry, OverlapSession.adopt, RC.RankController._state_from)

    def buffers(specs, plan, parallel, rank, device, reuse=None):
        out = orig[0](specs, plan, parallel, rank, device, reuse=reuse)
        seen.prepare.append((dict(reuse) if reuse is not None else None, dict(out)))
        return out

    def carry(self, name):
        if name not in self.dst and name not in self.dst_buffers:
            seen.fresh.append((seen.phase, id(self), name))
        return orig[1](self, name)

    def adopt(self, carries, streamed_at, live):
        n = orig[2](self, carries, streamed_at, live)
        seen.adopt_executor = id(self.executor)
        seen.adopt.append(({k: self.executor.dst.get(k) is v for k, v in carries.items()},
                           sorted(carries), n, [self.executor.dst.get(k) for k in carries], list(carries.values())))
        return n

    def state_from(self, moved, count, new_world):
        split = self._session is not None and self._commit_armed
        seen.commits.append(("split" if split else "stop", self.step, new_world.parallel))
        return orig[3](self, moved, count, new_world)

    RC.rank_state_buffers, EX.RankExecutor._dst_carry, OverlapSession.adopt, RC.RankController._state_from = (
        buffers, carry, adopt, state_from)

    def undo():
        RC.rank_state_buffers, EX.RankExecutor._dst_carry, OverlapSession.adopt, RC.RankController._state_from = orig

    return undo


# the control plane's trace, in steps of the clock: a stream to dp4tp1, its
# retarget to dp1tp4 a step later, a stream back to dp2tp2, a fail-stop of
# ranks 0 and 1 into dp1tp2 (donors 2 and 3)
CLOCK = 1000.0
TRACE = [(2, "resize", dict(dp=4)), (3, "resize", dict(dp=1, tp=4)), (12, "resize", dict(dp=2, tp=2)),
         (20, "fail_stop", dict(dp=1, tp=2))]
LOST = (0, 1)


def _trace(K):
    return [K.ResizeEvent(s * CLOCK, K.P(**t), float("inf")) if kind == "resize" else
            K.FailStopEvent(s * CLOCK, lost_ranks=LOST, target=K.P(**t)) for s, kind, t in TRACE]


def _estimate(K):
    """One estimate for every target, in both packages: every rung fits."""
    return K.elastic.ReconfigEstimate(prepare_s=0.001, precopy_s=0.001, stream_pause_s=0.001,
                                      stop_copy_pause_s=0.001, plan_bytes=1 << 20, rounds=5, step_s=0.1,
                                      peer_ok=True, peer_bytes=1 << 20)


def _scheduler_part(pool, rank: int, params, make) -> dict:
    """The control plane on the ranks (the module docstring), then the same
    commands made directly; each run's params on rank 0."""
    from types import SimpleNamespace

    from repro_torch.core.events import FailStopEvent, ResizeEvent
    from repro_torch.elastic import ControllerEndpoint, ElasticScheduler, RankEndpoint, WireEndpoint
    from repro_torch.elastic import protocol as pr
    from repro_torch.reshard import OperatingPoint
    import repro_torch.elastic as elastic

    K = SimpleNamespace(P=P, ResizeEvent=ResizeEvent, FailStopEvent=FailStopEvent, elastic=elastic)
    est = _estimate(K)

    class Stub:
        def estimate(self, target):
            return est

    class StepClock(RankEndpoint):
        """A clock of ``CLOCK`` trace seconds a train step, and every
        command frame rank 0 sent."""

        def __init__(self, inner, pool):
            super().__init__(inner, pool)
            self.steps, self.sent = 0, []

        def handle(self, cmd):
            self.sent.append(pr.dumps(cmd))
            resp = super().handle(cmd)
            if isinstance(resp, pr.StepResult):
                self.steps += resp.steps
                resp = pr.StepResult(steps=resp.steps, clock_s=self.steps * CLOCK)
            return resp

    a = make(P(dp=2, tp=2), pool_capacity=2, overlap="stream", stream_k=1)
    ep = StepClock(ControllerEndpoint(a, estimator=Stub()), pool)
    out = {}
    if rank == 0:
        rep = ElasticScheduler(WireEndpoint(ep), sync_prepare=True, tail_steps=2).run(_trace(K))
        ep.close()
        out["outcomes"] = [(o.decision, o.outcome) for o in rep.outcomes]
        out["sent"] = ep.sent
        ops = json.dumps([o.operating_point for o in rep.outcomes]).encode()
    else:
        ep.serve()
        ops = None
    ops = [o and OperatingPoint(**o) for o in json.loads(pool.broadcast_bytes(ops).decode())]
    out.update(frames=ep.frames, digest=ep.digest, step=a.step, world=a.world.parallel,
               records=[(r.mode, r.outcome, r.src, r.dst, r.donors) for r in a.records])
    out["params"] = a.gathered_params()
    del a

    # the same commands, directly
    b = make(P(dp=2, tp=2), pool_capacity=2, overlap="stream", stream_k=1)
    commits = []
    for i, (step, kind, t) in enumerate(TRACE):
        b.train_steps(step - b.step)
        if kind == "fail_stop":
            b.lose_state(frozenset(LOST))
            b.fail_stop_recover(P(**t), devices_failed=True, lost_ranks=LOST)
            break
        verb = b.retarget_resize if b.reconfig_pending else b.request_resize
        verb(P(**t), overlap="stream", operating_point=ops[i])
        b.wait_shadow_ready()
        if i == 1 or i == 2:  # these two commit before the next event: when?
            before = len(b.records)
            while len(b.records) == before:
                b.train_steps(1)
            commits.append(b.step - step)
    b.train_steps(2)
    out["direct"] = dict(step=b.step, world=b.world.parallel, params=b.gathered_params(), commits=commits,
                         records=[(r.mode, r.outcome, r.src, r.dst, r.donors) for r in b.records])
    return out


def _rank_program(rank: int, flat: dict) -> dict:
    from repro_torch.core.rank_controller import RankController
    from repro_torch.core.world_pool import WorldPool
    from repro_torch.distribution.groups import RankPool

    pool = RankPool()
    params = params_from_jax(flat, CFG, "cpu")

    def make(start, pool_capacity=None, **kw):
        return RankController(CFG, start, OPT, SEQ, BATCH, pool, worlds=WORLDS, device="cpu", params=params,
                              world_pool=WorldPool(capacity=pool_capacity) if pool_capacity else None, **kw)

    out = {}
    for fn in SCENARIOS:
        seen = _Seen()
        hooks = {}

        def hook(point, c, seen=seen, hooks=hooks):
            seen.phase = point
            if point == "before_retarget":
                hooks["old_dst"] = dict(c._session.executor.dst)
            if point == "before_escalate":
                hooks["session_precopy"] = c._session.report.precopy_bytes

        undo = _instrumented(seen)
        try:
            c, res = fn(make, P, hook)
        finally:
            undo()
        start = {"scenario_retarget": P(dp=1, tp=4)}.get(fn.__name__, P(dp=2, tp=2))
        adopt = []
        for same, names, n, dst, carries in seen.adopt:
            old = hooks.get("old_dst", {})
            adopt.append({"same": same, "names": names, "n": n,
                          "from_old": all(any(t is o for o in old.values()) for t in carries)})
        res.update(
            params=c.gathered_params(), pool_hits=c.world_pool.stats.hits, commits=seen.commits,
            # the successor session's and the escalation's stop-copy's (not the split step's gradients')
            fresh=[f[2] for f in seen.fresh if f[1] == getattr(seen, "adopt_executor", None) or f[0] == "before_escalate"],
            prepare=[(sorted(r) if r is not None else None, sorted(o), all(o[k] is r[k] for k in o)
                      if r is not None else None) for r, o in seen.prepare],
            adopt=adopt, session_precopy=hooks.get("session_precopy"),
            records_full=[dataclasses.asdict(r) for r in c.records])
        del c
        res["control"] = world_control(pool, rank, params, start, res["commits"], len(res["losses"]))
        out[fn.__name__] = res
    out["scheduler"] = _scheduler_part(pool, rank, params, make)
    out["prewarm"] = _prewarm_part(make)
    return out


def _prewarm_part(make) -> dict:
    """The two transfer prewarms on the ranks: ``prewarm_transfer`` plans
    (current world -> a pooled world) once, on a thread, and the recovery
    of that pair takes its plan; ``prewarm_failover_ahead`` plans (incoming
    world -> a pooled world that does not grow) during a resize."""
    from repro_torch.elastic.redundancy import survivors_for

    A, T = P(dp=2, tp=2), P(dp=1, tp=2)
    c = make(A, pool_capacity=3)
    out = {"no_pool": c.prewarm_transfer(T)}
    c.train_steps(1)
    c.prefetch_world(T)
    c._spec_builders[c.pool_key(T)].result(120)
    c.train_steps(1)  # the boundary harvests it
    out["first"], out["again"] = c.prewarm_transfer(T), c.prewarm_transfer(T)
    c._prewarm_thread.join(120)
    key = (A, T, survivors_for(A, (), target=T))
    out["planned"] = key in c._prewarmed_plans
    rec = c.fail_stop_recover(T)
    out.update(taken=key not in c._prewarmed_plans, source=rec.prepare_source, mode=rec.mode)
    c = make(A, pool_capacity=3)
    c.prefetch_world(T)
    c._spec_builders[c.pool_key(T)].result(120)
    c.train_steps(1)
    out["idle_ahead"] = c.prewarm_failover_ahead()  # no resize in flight
    c.request_resize(P(dp=1, tp=4))
    out["ahead"] = c.prewarm_failover_ahead()
    c._prewarm_thread.join(120)
    out["pairs"] = sorted((a.describe(), b.describe()) for a, b in c._prewarmed_pairs)
    c.wait_shadow_ready()
    c.train_steps(1)
    out["committed"] = [r.outcome for r in c.records]
    return out


@pytest.fixture(scope="module")
def ranks(jax_run):
    _, params = jax_run
    flat = {p: x.numpy() for p, x in tree_paths(params).items()}
    return run_ranks(_rank_program, NPROC, flat, timeout=600)


def _assert_params_equal(got, want):
    got, want = tree_paths(got), tree_paths(want)
    assert got.keys() == want.keys()
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


@pytest.mark.parametrize("name", [f.__name__ for f in SCENARIOS])
def test_records_steps_and_losses_match_the_jax_controller(jax_run, ranks, name):
    jax_out, _ = jax_run
    want = jax_out[name]
    for r in ranks:
        got = r[name]
        assert got["records"] == want["records"]
        assert got["steps"] == want["steps"]
    # rank 0 is in every world (a rank outside the world reads NaN)
    losses = ranks[0][name]["losses"]
    np.testing.assert_allclose(losses, want["losses"], atol=RESHAPE_PARITY_TOL, rtol=0)
    for r in ranks:
        assert [x for x in r[name]["losses"] if x == x] == [x for x, y in zip(losses, r[name]["losses"]) if y == y]


@pytest.mark.parametrize("name", [f.__name__ for f in SCENARIOS])
def test_params_are_bitwise_a_per_rank_control(ranks, name):
    r0 = ranks[0][name]
    assert r0["control"]["losses"] == r0["losses"]
    _assert_params_equal(r0["params"], r0["control"]["params"])


def test_warm_round_trip_hits_the_pool_on_every_rank(ranks):
    for r in ranks:
        got = r["scenario_round_trip"]
        assert [rec[4] for rec in got["records"]] == ["cold", "pool"] and got["pool_hits"] == 1
        assert [k for k, _, _ in got["commits"]] == ["stop", "stop"]


def test_prefetch_is_joined_at_the_resize(ranks):
    for r in ranks:
        got = r["scenario_prefetch"]
        assert got["prefetch"] == [True, True]
        assert [rec[4] for rec in got["records"]] == ["speculative_join", "pool"]


def test_retarget_adopts_the_carries_without_a_copy(ranks):
    for rank, r in enumerate(ranks):
        got = r["scenario_retarget"]
        [adopt] = got["adopt"][:1]
        assert adopt["n"] >= 1 and adopt["from_old"]
        if rank < 2:  # ranks 0 and 1 keep their dp2tp2 view in dp1tp2: every carry handed on is adopted
            assert adopt["names"] and all(adopt["same"].values()), adopt
        else:  # ranks 2 and 3 leave the world: nothing to adopt
            assert not adopt["names"]
        assert got["records"][1][5] == adopt["n"]


def test_no_second_set_of_destination_tensors_on_any_rank(ranks):
    for r in ranks:
        got = r["scenario_retarget"]
        # the retarget's Prepare took every tensor it needed from the hand-on
        handed = [p for p in got["prepare"] if p[0] is not None]
        assert len(handed) == 1
        reuse, took, all_reused = handed[0]
        assert all_reused and set(took) <= set(reuse)
        # neither the successor session nor the escalation's stop-copy allocated
        assert got["fresh"] == []


def test_escalation_falls_back_with_the_precopy_kept(ranks):
    for r in ranks:
        got = r["scenario_retarget"]
        assert got["escalated"] == ["fell_back", "live", True, True] and got["idle_escalate"]
        rec = got["records_full"][-1]
        assert rec["precopy_bytes"] == got["session_precopy"] > 0
        assert [k for k, _, _ in got["commits"]] == ["split", "stop"]


def test_every_rank_handles_the_schedulers_frames(ranks):
    s0 = ranks[0]["scheduler"]
    assert s0["outcomes"] == [("stream", "retargeted"), ("stream", "committed"), ("stream", "committed"),
                              ("peer_recover", "committed")]
    for r in ranks:
        s = r["scheduler"]
        assert (s["frames"], s["digest"]) == (s0["frames"], s0["digest"]) and s["frames"] == len(s0["sent"])
        assert s["records"] == s0["records"] and s["world"] == P(dp=1, tp=2)
    assert s0["records"][-1] == ("peer_recover", "committed", "dp2xpp1xtp2", "dp1xpp1xtp2", 2)


def test_scheduler_run_is_bitwise_the_direct_commands(ranks):
    s0 = ranks[0]["scheduler"]
    d = s0["direct"]
    assert (d["step"], d["world"], d["records"]) == (s0["step"], s0["world"], s0["records"])
    _assert_params_equal(s0["params"], d["params"])


def test_scheduler_frames_equal_the_jax_schedulers_on_the_stand_in(ranks, monkeypatch):
    """The JAX scheduler over the control-plane test's stand-in controller
    (JAX types), set to commit each resize after as many steps as the ranks
    took: the same command frames, byte for byte."""
    import test_torch_control_plane as CP

    s0 = ranks[0]["scheduler"]
    K = CP.JAX
    clock = CP.FakeTime()
    monkeypatch.setattr(K.scheduler, "time", clock)

    class StandIn(CP.FakeController):
        # the first request is retargeted before it commits
        plan = [10_000, *s0["direct"]["commits"]]

        def request_resize(self, target, overlap=None, operating_point=None):
            self.steps_to_commit = self.plan.pop(0)
            return super().request_resize(target, overlap, operating_point)

    ctrl = StandIn(K, clock, peer_ok=True)
    ctrl.world.parallel = K.P(dp=2, tp=2)
    sent = []

    class StepClock(K.endpoint.Endpoint):
        steps = 0

        def __init__(self, inner):
            self.inner, self.kind = inner, inner.kind

        def handle(self, cmd):
            sent.append(K.protocol.dumps(cmd))
            resp = self.inner.handle(cmd)
            if isinstance(resp, K.protocol.StepResult):
                self.steps += resp.steps
                resp = K.protocol.StepResult(steps=resp.steps, clock_s=self.steps * CLOCK)
            return resp

    ep = StepClock(K.elastic.ControllerEndpoint(ctrl, estimator=CP.StubEstimator(_estimate(K))))
    K.elastic.ElasticScheduler(K.elastic.WireEndpoint(ep), sync_prepare=True, tail_steps=2).run(_trace(K))
    assert sent == s0["sent"]


def test_prewarms_plan_the_pair_on_every_rank(ranks):
    for r in ranks:
        got = r["prewarm"]
        assert not got["no_pool"] and got["first"] and not got["again"]
        assert got["planned"] and got["taken"] and (got["source"], got["mode"]) == ("pool", "peer_recover")
        assert got["idle_ahead"] == 0 and got["ahead"] == 1
        assert got["pairs"] == [("dp1xpp1xtp4", "dp1xpp1xtp2")] and got["committed"] == ["committed"]
