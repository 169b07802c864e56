"""The port's simulator (``repro_torch.sim``), roofline module
(``repro_torch.roofline``) and fleet arbitration (``repro_torch.fleet``,
``SimEndpoint``) against the JAX package's, on the CPU: the cases of
``tests/test_sim.py`` and ``tests/test_fleet.py`` run through the port, and
each value held equal to the JAX function's on the same inputs.

The JAX package's roofline terms read a TPU v5e's constants, the port's an
H100's (``launch/mesh.py``): ``RooflineReport`` is compared with the JAX
module given the port's constants. The analytic curves read a cluster
model, not those constants, and are compared as they are. Schedulers run on
a fake wall clock that never moves, so the trace clock is the simulator's
alone in both packages."""

from __future__ import annotations

import dataclasses
import math

import pytest

import repro.elastic as jax_elastic
import repro.elastic.protocol as jax_protocol
import repro.elastic.scheduler as jax_scheduler
import repro.fleet as jax_fleet
import repro.roofline.analysis as jax_roofline
import repro.sim.cluster as jax_cluster
import repro.sim.des as jax_des
import repro.sim.liver_sim as jax_liver
import repro.sim.volatility as jax_volatility
from repro.configs.base import ParallelConfig as JaxP
from repro.core.events import FailStopEvent as JaxFailStop
from repro.core.events import ResizeEvent as JaxResize
from repro_torch.configs.base import ParallelConfig as P
from repro_torch.core.events import FailStopEvent, ResizeEvent
from repro_torch.elastic import ElasticScheduler, SimEndpoint, WireEndpoint
from repro_torch.elastic import protocol as p
from repro_torch.elastic import scheduler as port_scheduler
from repro_torch.fleet import (
    FairSharePolicy,
    FleetArbiter,
    FleetJob,
    JobView,
    MarginalThroughputPolicy,
    StaticPolicy,
    make_policy,
)
from repro_torch.launch import mesh as TM
from repro_torch.roofline import analysis as roofline
from repro_torch.sim import cluster, des, liver_sim, volatility
from repro_torch.sim.cluster import PAPER_TESTBED, TPU_V5E_POD, model_state_bytes
from repro_torch.sim.des import Simulator
from repro_torch.sim.liver_sim import SystemKind, reconfig_downtime, volatility_run
from repro_torch.sim.volatility import REGIMES, make_trace, paper_24h_trace

CLUSTERS = {"paper": (PAPER_TESTBED, jax_cluster.PAPER_TESTBED), "v5e": (TPU_V5E_POD, jax_cluster.TPU_V5E_POD)}


class StillClock:
    """A wall clock that never moves."""

    @staticmethod
    def perf_counter() -> float:
        return 0.0


@pytest.fixture
def still_clock(monkeypatch):
    for mod in (port_scheduler, jax_scheduler):
        monkeypatch.setattr(mod, "time", StillClock)


# ---------------------------------------------------------------------------
# The DES engine (tests/test_sim.py)
# ---------------------------------------------------------------------------


def _des_log(S) -> list:
    sim = S.Simulator()
    log = []
    sim.schedule(2.0, log.append, "b")
    sim.schedule(1.0, log.append, "a")
    sim.schedule(2.0, log.append, "c")

    def proc():
        yield 0.5
        log.append("p1")
        yield 1.0
        log.append("p2")

    sim.process(proc())
    for i in range(100):
        sim.schedule(5.0, log.append, ("tie", i))
    sim.schedule(5.0, lambda: log.append("lambda"))
    sim.schedule(5.0, log.append, {"payload": 3})
    sim.run(until=3.0)
    log.append(sim.now)
    sim.schedule(1.0, log.append, "late")  # a delay: at 4.0
    sim.run()
    log.append(sim.now)
    return log


def test_des_equals_jax():
    log = _des_log(des)
    assert log == _des_log(jax_des)
    assert log[:5] == ["p1", "a", "p2", "b", "c"] and log[5] == 3.0 and log[6] == "late"
    assert log[7:107] == [("tie", i) for i in range(100)] and log[107:] == ["lambda", {"payload": 3}, 5.0]


def test_des_ordering_and_determinism():
    sim = Simulator()
    log = []
    sim.schedule(2.0, log.append, "b")
    sim.schedule(1.0, log.append, "a")
    sim.schedule(2.0, log.append, "c")

    def proc():
        yield 0.5
        log.append("p1")
        yield 1.0
        log.append("p2")

    sim.process(proc())
    sim.run()
    assert log == ["p1", "a", "p2", "b", "c"] and sim.now == 2.0


def test_des_run_until_does_not_advance_past_deadline():
    sim = Simulator()
    log = []
    sim.schedule(1.0, log.append, "a")
    sim.schedule(10.0, log.append, "late")
    sim.run(until=5.0)
    assert log == ["a"] and sim.now == 5.0
    sim.run()
    assert log == ["a", "late"] and sim.now == 10.0


# ---------------------------------------------------------------------------
# The cluster models and the reconfiguration systems (tests/test_sim.py)
# ---------------------------------------------------------------------------


def test_cluster_models_are_the_reference_copies():
    for mine, theirs in CLUSTERS.values():
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        for world in (1, 2, 7, 32, 1024):
            assert mine.dist_init_s(world) == theirs.dist_init_s(world)
            assert mine.prepare_s(world) == theirs.prepare_s(world)
            assert mine.transfer_s(3e10, world) == theirs.transfer_s(3e10, world)
            assert mine.ckpt_load_s(3e10, world) == theirs.ckpt_load_s(3e10, world)
            assert mine.step_time_s(14e9, world) == theirs.step_time_s(14e9, world)
    for params in (1.7e9, 70e9):
        for opt in (False, True):
            assert model_state_bytes(params, opt) == jax_cluster.model_state_bytes(params, opt)


@pytest.mark.parametrize("kind", list(SystemKind))
@pytest.mark.parametrize("cl", sorted(CLUSTERS))
def test_reconfig_downtime_equals_jax(kind, cl):
    mine, theirs = CLUSTERS[cl]
    jkind = jax_liver.SystemKind(kind.value)
    for params, before, after, frac, bw in ((20e9, 32, 32, 1.0, None), (1.7e9, 8, 4, 0.5, None),
                                            (14e9, 32, 16, 1.0, 0.25), (70e9, 1024, 1024, 1.0, 2.0)):
        got = reconfig_downtime(kind, mine, params, before, after, move_fraction=frac, storage_bw_override=bw)
        want = jax_liver.reconfig_downtime(jkind, theirs, params, before, after, move_fraction=frac,
                                           storage_bw_override=bw)
        assert got.phases == want.phases


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_volatility_run_equals_jax(regime):
    tr = make_trace(8 * 3600, REGIMES[regime], seed=2)
    assert tr == jax_volatility.make_trace(8 * 3600, jax_volatility.REGIMES[regime], seed=2)
    g = {}
    for kind in SystemKind:
        got = volatility_run(kind, PAPER_TESTBED, 14e9, tr, 8 * 3600, 32)
        want = jax_liver.volatility_run(jax_liver.SystemKind(kind.value), jax_cluster.PAPER_TESTBED, 14e9, tr,
                                        8 * 3600, 32)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        g[kind] = got.goodput
    assert g[SystemKind.LIVER] > 0.985
    assert g[SystemKind.LIVER] > g[SystemKind.UCP] >= g[SystemKind.MEGATRON_CKPT]


def test_traces_equal_jax():
    assert paper_24h_trace() == jax_volatility.paper_24h_trace() != []
    for seed in (0, 3):
        assert make_trace(24 * 3600, 600, (4, 8, 16), seed) == jax_volatility.make_trace(24 * 3600, 600, (4, 8, 16),
                                                                                        seed)


def test_table1_breakdown_parity():
    d = reconfig_downtime(SystemKind.MEGATRON_CKPT, PAPER_TESTBED, 20e9, 32, 32)
    assert d.phases["ckpt_load"] == pytest.approx(54.6, abs=1.5)
    init = d.phases["proc_spawn"] + d.phases["cuda_init"] + d.phases["dist_init"]
    assert init == pytest.approx(70.1, abs=2.0)
    assert d.total == pytest.approx(127.1, abs=3.0)


def test_fig6a_speedup_band():
    for params in (1.7e9, 7e9, 14e9, 20e9, 30e9):
        mk = reconfig_downtime(SystemKind.MEGATRON_CKPT, PAPER_TESTBED, params, 32, 32)
        lv = reconfig_downtime(SystemKind.LIVER, PAPER_TESTBED, params, 32, 32)
        assert 13.0 <= mk.total / lv.total <= 24.0, params
        assert lv.total < 8.5 and lv.phases["switch"] < 0.5


def test_fig6b_storage_sensitivity():
    slow = reconfig_downtime(SystemKind.MEGATRON_CKPT, PAPER_TESTBED, 14e9, 32, 32, storage_bw_override=0.25)
    fast = reconfig_downtime(SystemKind.MEGATRON_CKPT, PAPER_TESTBED, 14e9, 32, 32, storage_bw_override=2.0)
    assert slow.phases["ckpt_load"] > 100
    assert slow.phases["ckpt_load"] / fast.phases["ckpt_load"] == pytest.approx(8.0, rel=0.01)
    assert slow.total / fast.total > 2.2
    lv = [reconfig_downtime(SystemKind.LIVER, PAPER_TESTBED, 14e9, 32, 32, storage_bw_override=bw).total
          for bw in (0.25, 2.0)]
    assert lv[0] == pytest.approx(lv[1])


def test_fig8_wasted_gpu_hours():
    tr = paper_24h_trace()
    r_m = volatility_run(SystemKind.MEGATRON_CKPT, PAPER_TESTBED, 14e9, tr, 24 * 3600, 32)
    r_l = volatility_run(SystemKind.LIVER, PAPER_TESTBED, 14e9, tr, 24 * 3600, 32)
    assert r_m.wasted_gpu_hours > 70 and r_l.wasted_gpu_hours < 8
    assert r_m.reconfig_pause_s / max(r_l.reconfig_pause_s, 1e-9) > 10


def test_downtime_monotone_and_fig11_extrapolation():
    prev = 0.0
    for params in (1e9, 5e9, 20e9, 70e9):
        t = reconfig_downtime(SystemKind.LIVER, PAPER_TESTBED, params, 32, 32).total
        assert t >= prev
        prev = t
    mk = reconfig_downtime(SystemKind.MEGATRON_CKPT, PAPER_TESTBED, 70e9, 1024, 1024)
    lv = reconfig_downtime(SystemKind.LIVER, PAPER_TESTBED, 70e9, 1024, 1024)
    assert 300 < mk.total < 900 and lv.total < 15 and mk.total / lv.total > 30


# ---------------------------------------------------------------------------
# The roofline module
# ---------------------------------------------------------------------------

HLO = """\
HloModule jit_step, entry_computation_layout={(f32[512,1024]{1,0})->f32[512,1024]{1,0}}
  %all-reduce.42 = f32[512,1024]{1,0} all-reduce(f32[512,1024]{1,0} %p0), replica_groups={{0,1}}, to_apply=%add
  %all-gather.3 = bf16[8,128]{1,0} all-gather(bf16[4,128]{1,0} %p1), dimensions={0}
  %all-gather-start.9 = bf16[64]{0} all-gather-start(bf16[32]{0} %p5), dimensions={0}
  %reduce-scatter.7 = f32[128]{0} reduce-scatter(f32[512]{0} %p2), dimensions={0}, to_apply=%add
  %all-to-all.1 = (f32[8,128]{1,0}, f32[8,128]{1,0}) all-to-all(f32[8,128]{1,0} %a, f32[8,128]{1,0} %b)
  %collective-permute-start.2 = s8[16,4]{1,0} collective-permute-start(s8[16,4]{1,0} %p3)
  %fusion.1 = f32[512,1024]{1,0} fusion(f32[512,1024]{1,0} %all-reduce.42), kind=kLoop
  %custom = u4[8]{0} all-reduce(u4[8]{0} %p4)
"""


def test_collective_bytes_from_hlo_equal_jax():
    got = roofline.collective_bytes_from_hlo(HLO)
    assert got == jax_roofline.collective_bytes_from_hlo(HLO)
    # reduce-scatter: the parser reads the shapes from the op's first
    # occurrence on, the instruction's name, so the result counts beside
    # the operand, as in the JAX package
    assert got == {"all-gather": 8 * 128 * 2 + 64 * 2, "all-reduce": 2 * 512 * 1024 * 4,
                   "reduce-scatter": 128 * 4 + 512 * 4, "all-to-all": 2 * 8 * 128 * 4, "collective-permute": 16 * 4}
    assert roofline.collective_bytes_from_hlo("") == jax_roofline.collective_bytes_from_hlo("")


def test_roofline_report_on_the_h100_constants(monkeypatch):
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.ICI_BW) == (
        TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.ICI_BW)
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(jax_roofline, name, getattr(TM, name))
    for flops, nbytes, model_flops, chips in ((1e15, 1e12, 8e14, 4), (1e12, 5e12, 9e11, 1), (0.0, 0.0, 0.0, 8)):
        cost = {"flops": flops, "bytes accessed": nbytes}
        got = roofline.roofline_terms("qwen3-1.7b", "4x1024", "dp2tp2", chips, cost, HLO, model_flops)
        want = jax_roofline.roofline_terms("qwen3-1.7b", "4x1024", "dp2tp2", chips, cost, HLO, model_flops)
        assert got.to_dict() == want.to_dict()
    rep = roofline.RooflineReport("a", "s", "m", 1, 989e12, 0.0, 0, model_flops=989e12)
    assert rep.compute_s == 1.0 and rep.bottleneck == "compute" and rep.roofline_fraction == 1.0


def test_analytic_curves_equal_jax():
    for cl in CLUSTERS.values():
        for params in (0.4e9, 1.4e9, 7e9):
            for world in range(0, 65):
                assert roofline.analytic_step_time(params, world, cl[0]) == jax_roofline.analytic_step_time(
                    params, world, cl[1])
                assert roofline.analytic_throughput(params, world, cl[0], 256) == jax_roofline.analytic_throughput(
                    params, world, cl[1], 256)
                for delta in (0, 1, 4):
                    assert roofline.marginal_throughput(params, world, cl[0], 256, delta) == (
                        jax_roofline.marginal_throughput(params, world, cl[1], 256, delta))


def test_analytic_throughput_monotone_and_concave():
    for params in (0.4e9, 1.4e9, 7e9):
        t = [roofline.analytic_throughput(params, w, PAPER_TESTBED, 256) for w in range(1, 65)]
        gains = [b - a for a, b in zip(t, t[1:])]
        assert all(g > 0 for g in gains)
        assert all(g2 < g1 + 1e-9 for g1, g2 in zip(gains, gains[1:]))
    got = roofline.analytic_step_time(1.4e9, 32, PAPER_TESTBED, ref_world=32)
    assert got == pytest.approx(PAPER_TESTBED.step_time_s(1.4e9, 32, ref_world=32), rel=1e-9)


# ---------------------------------------------------------------------------
# Policies (tests/test_fleet.py)
# ---------------------------------------------------------------------------


def _views(JV, spec):
    return [JV(name=n, current=2, feasible=(2, 4, 8, 16), weight=1.0,
               throughput=lambda w, s=scale: s * math.log1p(w)) for n, scale in spec]


@pytest.mark.parametrize("policy", ["static", "fair_share", "marginal"])
def test_policies_equal_jax(policy):
    for spec in ((("big", 10.0), ("small", 1.0)), (("a", 1.0), ("b", 1.0)), (("a", 1.0), ("b", 2.0), ("c", 3.0))):
        mine, theirs = make_policy(policy), jax_fleet.make_policy(policy)
        for cap in (6, 7, 10, 12, 16, 20, 32, 48, 100, 16):
            views, jviews = _views(JobView, spec), _views(jax_fleet.JobView, spec)
            assert mine.allocate(views, cap) == theirs.allocate(jviews, cap)
        with pytest.raises(ValueError):
            mine.allocate(_views(JobView, spec), 2 * len(spec) - 1)


def test_marginal_policy_fills_highest_gain_first():
    alloc = MarginalThroughputPolicy().allocate(_views(JobView, (("big", 10.0), ("small", 1.0))), 20)
    assert alloc == {"big": 16, "small": 4}
    assert MarginalThroughputPolicy().allocate(_views(JobView, (("a", 1.0), ("b", 1.0))), 12) == {"a": 8, "b": 4}


def test_static_and_fair_share():
    views = _views(JobView, (("a", 1.0), ("b", 1.0)))
    pol = StaticPolicy()
    first = pol.allocate(views, 16)
    assert first == {"a": 8, "b": 8} and pol.allocate(views, 32) == first
    assert sum(pol.allocate(views, 10).values()) <= 10
    views = _views(JobView, (("big", 10.0), ("small", 1.0)))
    pol = FairSharePolicy()
    assert pol.allocate(views, 16) == {"big": 8, "small": 8} and pol.allocate(views, 32) == {"big": 16, "small": 16}
    assert [make_policy(n).name for n in ("marginal", "static", "fair_share")] == ["marginal", "static", "fair_share"]
    with pytest.raises(ValueError):
        make_policy("nope")


# ---------------------------------------------------------------------------
# SimEndpoint over the wire (tests/test_fleet.py)
# ---------------------------------------------------------------------------


def _sim_conversation(pkg_p, ep, cmds) -> list:
    out = []
    for cmd in cmds:
        out.append(pkg_p.dumps(ep.handle(cmd)))
    return out


def _commands(pr, Par) -> list:
    return [pr.TrainSteps(n=10), pr.QueryStatus(), pr.QueryLedger(), pr.QueryEstimate(target=Par(dp=8)),
            pr.RequestResize(target=Par(dp=8), overlap="stream"), pr.QueryStatus(), pr.TrainSteps(n=2000),
            pr.QueryStatus(), pr.QueryRecords(since=0), pr.QueryLedger(), pr.RequestResize(target=Par(dp=2)),
            pr.RetargetResize(target=Par(dp=4), overlap="stop_copy"), pr.TrainSteps(n=1), pr.EscalateCommit(),
            pr.CheckpointNow(), pr.QueryEstimate(target=Par(dp=2)),
            pr.FailStopRecover(target=Par(dp=2), devices_failed=True, lost_ranks=(2, 3)),
            pr.QuerySurvivorTarget(lost_ranks=(1,)), pr.RequestResize(target=Par(dp=4)), pr.WaitShadowReady(),
            pr.CancelResize(), pr.PrefetchTick(), pr.PrefetchWorld(target=Par(dp=1)), pr.TrainSteps(n=3),
            pr.QueryRecords(since=1), pr.QueryLedger()]


def test_sim_endpoint_conversation_equals_jax():
    ep = WireEndpoint(SimEndpoint("job", params=1.4e9, global_batch=256, parallel=P(dp=4)))
    jep = jax_elastic.WireEndpoint(jax_elastic.SimEndpoint("job", params=1.4e9, global_batch=256, parallel=JaxP(dp=4)))
    got = _sim_conversation(p, ep, _commands(p, P))
    assert got == _sim_conversation(jax_protocol, jep, _commands(jax_protocol, JaxP))
    assert ep.commands == jep.commands and ep.bytes_tx == jep.bytes_tx and ep.bytes_rx == jep.bytes_rx


def _sim_ep(**kw):
    kw.setdefault("params", 1.4e9)
    kw.setdefault("global_batch", 256)
    kw.setdefault("parallel", P(dp=4))
    return WireEndpoint(SimEndpoint("job", **kw))


def test_sim_endpoint_trains_on_virtual_clock():
    ep = _sim_ep()
    r = ep.handle(p.TrainSteps(n=10))
    assert isinstance(r, p.StepResult) and r.steps == 10 and r.clock_s > 0
    status = ep.handle(p.QueryStatus())
    assert (status.kind, status.step, status.world_size) == ("sim", 10, 4)
    ledger = ep.handle(p.QueryLedger())
    assert ledger.steps == 10 and ledger.samples == 10 * 256 and ledger.goodput == pytest.approx(1.0)


def test_sim_endpoint_resize_commits_with_pause():
    ep = _sim_ep()
    ep.handle(p.TrainSteps(n=5))
    r = ep.handle(p.RequestResize(target=P(dp=8), overlap="stream"))
    assert isinstance(r, p.ResizeStarted) and r.gen_id == 1 and ep.handle(p.QueryStatus()).reconfig_pending
    ep.handle(p.TrainSteps(n=2000))
    status = ep.handle(p.QueryStatus())
    assert not status.reconfig_pending and status.world_size == 8
    recs = ep.handle(p.QueryRecords(since=0))
    assert recs.total == 1
    rec = recs.records[0]
    assert rec.outcome == "committed" and rec.mode == "live_overlap" and rec.total_pause_s > 0
    assert 0 < ep.handle(p.QueryLedger()).goodput < 1


def test_sim_endpoint_failstop_and_estimates():
    ep = _sim_ep()
    ep.handle(p.TrainSteps(n=5))
    est = ep.handle(p.QueryEstimate(target=P(dp=2))).estimate
    assert est.step_s > 0 and est.stop_copy_pause_s > 0 and est.measured_bw > 0
    r = ep.handle(p.FailStopRecover(target=P(dp=2), devices_failed=True, lost_ranks=(2, 3)))
    assert isinstance(r, p.RecoverResult)
    assert r.record.mode == "peer_recover" and r.record.outcome == "committed"
    assert ep.handle(p.QueryStatus()).world_size == 2
    tgt = ep.handle(p.QuerySurvivorTarget(lost_ranks=(1,))).target
    assert tgt is not None and tgt.world_size == 1


def test_scheduler_drives_sim_endpoint_end_to_end(still_clock):
    def run(sched, ep, Res, Par):
        rep = sched(ep, tail_steps=2).run([Res(time_s=30.0, target=Par(dp=8), warning_s=1e9),
                                           Res(time_s=4000.0, target=Par(dp=2), warning_s=1e9)])
        d = rep.to_dict()
        del d["wall_s"]
        return rep, d

    ep = _sim_ep()
    rep, got = run(ElasticScheduler, ep, ResizeEvent, P)
    jep = jax_elastic.WireEndpoint(jax_elastic.SimEndpoint("job", params=1.4e9, global_batch=256, parallel=JaxP(dp=4)))
    assert got == run(jax_elastic.ElasticScheduler, jep, JaxResize, JaxP)[1]
    assert rep.aborted == 0 and [o.outcome for o in rep.outcomes] == ["committed", "committed"]
    assert ep.handle(p.QueryStatus()).world_size == 2
    assert rep.goodput is None or 0 < rep.goodput <= 1


# ---------------------------------------------------------------------------
# The arbiter end to end (tests/test_fleet.py)
# ---------------------------------------------------------------------------

TRACE = [(600.0, 24, "resize", 120.0), (1200.0, 40, "resize", 120.0), (1800.0, 16, "fail_stop", 0.0),
         (2400.0, 32, "resize", 120.0)]


def _fleet(policy_name, jax: bool = False):
    Sim, Sep, Wep, Job, Arb, mk, Par = (
        (jax_des.Simulator, jax_elastic.SimEndpoint, jax_elastic.WireEndpoint, jax_fleet.FleetJob,
         jax_fleet.FleetArbiter, jax_fleet.make_policy, JaxP) if jax else
        (Simulator, SimEndpoint, WireEndpoint, FleetJob, FleetArbiter, make_policy, P))
    sim = Sim()
    jobs = []
    for i, params in enumerate((0.4e9, 1.4e9, 7e9)):
        ep = Wep(Sep(f"job{i}", params=params, global_batch=256, parallel=Par(dp=4), sim=sim))
        jobs.append(Job(name=f"job{i}", endpoint=ep, params=params, global_batch=256,
                        feasible_worlds=(1, 2, 3, 4, 6, 8, 12, 16, 24)))
    return Arb(jobs, mk(policy_name), sim=sim)


@pytest.mark.parametrize("policy", ["static", "fair_share", "marginal"])
def test_arbiter_report_equals_jax(policy):
    rep = _fleet(policy).run(TRACE, duration_s=3600.0, initial_capacity=32)
    want = _fleet(policy, jax=True).run(TRACE, duration_s=3600.0, initial_capacity=32)
    assert rep.to_dict() == want.to_dict()
    assert rep.arbitrated_events >= 3 and rep.total_samples > 0
    assert 0 < rep.cluster_goodput <= 1.0 and rep.ideal_samples >= rep.total_samples


def test_arbiter_runs_fleet_and_marginal_wins():
    g = {name: _fleet(name).run(TRACE, duration_s=3600.0, initial_capacity=32).cluster_goodput
         for name in ("static", "fair_share", "marginal")}
    assert g["marginal"] > g["static"] and g["marginal"] > g["fair_share"]


def test_arbiter_failstop_rows_force_recovery():
    rep = _fleet("marginal").run(TRACE, duration_s=3600.0, initial_capacity=32)
    forced = [e for e in rep.events if e.kind == "fail_stop" and e.world_after < e.world_before]
    assert forced and all(e.decision == "peer_recover" for e in forced)


def test_plan_assignments_equal_jax():
    plans = _fleet("marginal").plan_assignments(TRACE, initial_capacity=32)
    jplans = _fleet("marginal", jax=True).plan_assignments(TRACE, initial_capacity=32)
    assert set(plans) == {"job0", "job1", "job2"} == set(jplans)
    for name in plans:
        assert [p.dumps(e) for e in plans[name]] == [jax_protocol.dumps(e) for e in jplans[name]]
    evs = [e for lst in plans.values() for e in lst]
    assert evs and all(isinstance(e, (ResizeEvent, FailStopEvent)) and e.target is not None for e in evs)
    assert any(isinstance(e, FailStopEvent) for e in evs)
    assert not any(isinstance(e, (JaxResize, JaxFailStop)) for e in evs)


def test_modules_are_the_port_copies():
    for mod in (cluster, des, liver_sim, volatility, roofline):
        assert mod.__name__.startswith("repro_torch.")
