"""The port's elastic control plane (``repro_torch.elastic``: the wire
protocol, the endpoints, the deadline scheduler and the trace reader)
against the JAX package's, on the CPU.

- the protocol: the golden transcript byte for byte (read, never written),
  the cases of ``tests/test_protocol.py``, and every golden message
  crossing between the two packages in both directions;
- the scheduler against the JAX scheduler on the same stand-in controller
  (a copy of ``tests/test_scheduler.py``'s), for each of that file's cases
  with a stand-in: the same ``ScheduleReport`` less its wall time and the
  same sequence of messages on the wire. Both schedulers run on one fake
  clock that moves only when the stand-in trains, so their trace clocks
  agree to the bit;
- the JAX scheduler driving the port's real controller through a bridge
  that ``dumps`` with one package and ``loads`` with the other;
- the endpoints: ``DeadlineEstimator`` on both packages from the same
  record history (the port's cold seed falls back to 20 s: its world build
  records no ``mesh_s``, ``lower_s`` or ``compile_s``),
  ``PrefetchPolicy.candidates`` for equal rank pools, ``ServeEndpoint``;
- the port's real controller on the CPU (reduced qwen3): a scheduler-driven
  resize, and a stream, a retarget, a duplicate and a fail-stop, bitwise
  equal to the direct calls at the same steps;
- the trace reader (``events_from_trace``) and ``spot_trace`` against the
  JAX package's, the search on the same constants.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import json
import math
import pathlib
from types import SimpleNamespace

import pytest
import torch

import repro.configs as jax_configs
import repro.core.controller as jax_controller
import repro.core.downtime as jax_downtime
import repro.core.errors as jax_errors
import repro.core.events as jax_events
import repro.elastic as jax_elastic
import repro.elastic.endpoint as jax_endpoint
import repro.elastic.protocol as jax_protocol
import repro.elastic.scheduler as jax_scheduler
import repro.reshard.wire as jax_wire
import repro.sim.volatility as jax_volatility
from repro.core import topology_search as JT
from repro.models import model as JM
from repro_torch import configs as port_configs
from repro_torch import elastic as port_elastic
from repro_torch.core import controller as port_controller
from repro_torch.core import downtime as port_downtime
from repro_torch.core import errors as port_errors
from repro_torch.core import events as port_events
from repro_torch.core.controller import LiveRController
from repro_torch.core.reshard import named_state_leaves
from repro_torch.elastic import endpoint as port_endpoint
from repro_torch.elastic import protocol as p
from repro_torch.elastic import scheduler as port_scheduler
from repro_torch.launch import mesh as TM
from repro_torch.models import model as TMOD
from repro_torch.optim import AdamWConfig
from repro_torch.reshard import OperatingPoint
from repro_torch.reshard import wire as port_wire
from repro_torch.sim import volatility as port_volatility

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "protocol_v1.jsonl"


def _package(cfgs, controller, downtime, errors, events, elastic, endpoint, protocol, scheduler, wire):
    return SimpleNamespace(
        P=cfgs.ParallelConfig, get_config=cfgs.get_config, ReconfigRecord=controller.ReconfigRecord,
        GoodputLedger=downtime.GoodputLedger, RecoveryError=errors.RecoveryError,
        ResizeEvent=events.ResizeEvent, FailStopEvent=events.FailStopEvent, elastic=elastic,
        endpoint=endpoint, protocol=protocol, scheduler=scheduler, WirePolicy=wire.WirePolicy,
    )


JAX = _package(jax_configs, jax_controller, jax_downtime, jax_errors, jax_events, jax_elastic, jax_endpoint,
               jax_protocol, jax_scheduler, jax_wire)
PORT = _package(port_configs, port_controller, port_downtime, port_errors, port_events, port_elastic,
                port_endpoint, p, port_scheduler, port_wire)


@pytest.fixture
def same_constants(monkeypatch):
    """The JAX topology search on the port's constants, and both packages'
    parameter counts computed once a config."""
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES", "ICI_BW"):
        monkeypatch.setattr(JT, name, getattr(TM, name))
    defaults = JT.search.__defaults__  # (current, transition_weight, hbm_bytes, max_pp)
    monkeypatch.setattr(JT.search, "__defaults__", defaults[:2] + (TM.HBM_BYTES,) + defaults[3:])
    monkeypatch.setattr(JM, "analytic_param_count", functools.lru_cache(JM.analytic_param_count))
    monkeypatch.setattr(TMOD, "analytic_param_count", functools.lru_cache(TMOD.analytic_param_count))


# ---------------------------------------------------------------------------
# The protocol (tests/test_protocol.py through the port)
# ---------------------------------------------------------------------------


def test_port_golden_messages_encode_the_golden_file():
    want = GOLDEN.read_text().splitlines()
    assert [p.dumps(m) for m in p.golden_messages()] == want
    for line in want:
        assert p.dumps(p.loads(line)) == line
    assert p.PROTOCOL_VERSION == jax_protocol.PROTOCOL_VERSION == 1
    assert sorted(p._REGISTRY) == sorted(jax_protocol._REGISTRY)
    assert sorted(p._TYPE_OF.values()) == sorted(jax_protocol._TYPE_OF.values())


@pytest.mark.parametrize("i", range(len(p.golden_messages())))
def test_golden_message_crosses_between_packages(i):
    mine, theirs = p.golden_messages()[i], jax_protocol.golden_messages()[i]
    text = jax_protocol.dumps(theirs)
    assert p.dumps(mine) == text
    got = p.loads(text)  # JAX -> port
    assert got == mine and type(got) is type(mine)
    assert p.dumps(got) == text
    back = jax_protocol.loads(p.dumps(mine))  # port -> JAX
    assert back == theirs and type(back) is type(theirs)
    assert jax_protocol.dumps(back) == text


def test_every_message_round_trips_bit_identically():
    for msg in p.golden_messages():
        wire = p.dumps(msg)
        back = p.loads(wire)
        assert back == msg and type(back) is type(msg)
        assert p.dumps(back) == wire


def test_golden_corpus_covers_every_registered_type():
    covered = {type(m) for m in p.golden_messages()}
    assert set(p._REGISTRY.values()) - covered == set()


def test_envelope_carries_version_and_type():
    obj = p.encode(p.QueryStatus())
    assert (obj["v"], obj["type"]) == (p.PROTOCOL_VERSION, "query_status")
    assert p.dumps(p.QueryStatus()) == json.dumps(obj, sort_keys=True, separators=(",", ":"))


def test_non_finite_floats_survive_json():
    est = p.ReconfigEstimate(prepare_s=1.0, precopy_s=float("inf"), stream_pause_s=0.5, stop_copy_pause_s=1.5,
                             plan_bytes=1 << 20, rounds=3, step_s=0.1)
    msg = p.EstimateResponse(estimate=est)
    assert p.loads(p.dumps(msg)).estimate.precopy_s == float("inf")
    assert "Infinity" not in p.dumps(msg) and "NaN" not in p.dumps(msg)


def test_parallel_config_round_trips_as_axis_dict():
    msg = p.RequestResize(target=PORT.P(dp=2, pp=2, tp=4))
    obj = p.encode(msg)
    assert obj["target"] == {"dp": 2, "ep": 1, "pp": 2, "tp": 4}
    back = p.decode(obj)
    assert back.target == PORT.P(dp=2, pp=2, tp=4) and isinstance(back.target, PORT.P)


def test_versioning_rule():
    obj = p.encode(p.QueryStatus())
    obj["v"] = p.PROTOCOL_VERSION + 1
    with pytest.raises(port_errors.ProtocolError):
        p.decode(obj)
    obj = p.encode(p.TrainSteps(n=7))
    obj["some_future_field"] = {"nested": True}
    assert p.decode(obj) == p.TrainSteps(n=7)
    for bad in ({"v": 1, "type": "no_such_verb"}, {"v": 1}, {"v": 1, "type": "request_resize"}):
        with pytest.raises(port_errors.ProtocolError):
            p.decode(bad)
    with pytest.raises(port_errors.ProtocolError):
        p.loads("not json at all {{{")
    obj = p.encode(p.StepResult(steps=3))
    del obj["clock_s"]
    assert p.decode(obj) == p.StepResult(steps=3, clock_s=-1.0)


def test_record_view_from_the_port_record():
    rec = PORT.ReconfigRecord(gen_id=3, src="dp2", dst="dp4", mode="live_overlap", outcome="committed",
                              total_pause_s=0.25, reused_layers=5)
    view = p.RecordView.from_record(rec)
    assert (view.gen_id, view.src, view.dst, view.outcome, view.reused_layers) == (3, "dp2", "dp4", "committed", 5)
    assert view.total_pause_s == pytest.approx(0.25)
    assert p.loads(p.dumps(p.RecordsResponse(records=(view,), total=1))).records[0] == view
    jrec = JAX.ReconfigRecord(gen_id=3, src="dp2", dst="dp4", mode="live_overlap", outcome="committed",
                              total_pause_s=0.25, reused_layers=5)
    jview = jax_protocol.RecordView.from_record(jrec)
    assert p.dumps(p.RecordsResponse(records=(view,))) == jax_protocol.dumps(jax_protocol.RecordsResponse(records=(jview,)))


# ---------------------------------------------------------------------------
# ServeEndpoint (tests/test_protocol.py's case; and over the port's real
# serving controller)
# ---------------------------------------------------------------------------


class FakeServeController:
    """Duck-typed LiveServeController surface the adapter touches."""

    def __init__(self, K):
        self.gen_id = 0
        self.records = []
        self.active = SimpleNamespace(parallel=K.P(dp=2, tp=2))
        self._pending = None

    def request_resize(self, target):
        self._pending = target

    def _discard_pending(self):
        self._pending = None

    @property
    def resize_pending(self):
        return self._pending is not None


def _serve_conversation(K):
    ctrl = FakeServeController(K)
    ep = K.elastic.WireEndpoint(K.elastic.ServeEndpoint(ctrl))
    assert ep.kind == "serve"
    pr = K.protocol
    out = []

    def send(cmd):
        resp = ep.handle(cmd)
        out.append(pr.dumps(resp))
        return resp

    r = send(pr.RequestResize(target=K.P(dp=4)))
    assert isinstance(r, pr.ResizeStarted) and r.gen_id == 1
    status = send(pr.QueryStatus())
    assert status.kind == "serve" and status.reconfig_pending and status.world_size == 4
    assert isinstance(send(pr.RetargetResize(target=K.P(dp=8))), pr.ResizeStarted)
    assert ctrl._pending == K.P(dp=8)
    assert send(pr.CancelResize()).ok
    assert not send(pr.QueryStatus()).reconfig_pending
    recs = send(pr.QueryRecords(since=0))
    assert recs.total == 0 and recs.records == ()
    err = send(pr.TrainSteps(n=1))
    assert isinstance(err, pr.ErrorResponse) and err.kind == "unsupported"
    return out


def test_serve_endpoint_answers_resize_subset_over_the_wire():
    assert _serve_conversation(PORT) == _serve_conversation(JAX)


def test_serve_endpoint_over_the_port_serving_controller():
    from repro_torch.serve.controller import LiveServeController

    cfg = port_configs.get_config("qwen3-1.7b").reduced()
    ctrl = LiveServeController(cfg, PORT.P(dp=2, tp=2), 4, 16, 32, sync_prepare=True, device="cpu")
    ep = port_elastic.WireEndpoint(port_elastic.ServeEndpoint(ctrl))
    status = ep.handle(p.QueryStatus())
    assert (status.parallel, status.world_size, status.reconfig_pending, status.kind) == (
        PORT.P(dp=2, tp=2), 4, False, "serve")
    assert ep.handle(p.RequestResize(target=PORT.P(dp=1, tp=2))) == p.ResizeStarted(gen_id=1)
    assert ep.handle(p.QueryStatus()).reconfig_pending and ctrl.resize_pending
    assert ep.handle(p.CancelResize()).ok and not ctrl.resize_pending
    assert ep.handle(p.QueryRecords(since=0)) == p.RecordsResponse(records=(), total=0)
    assert ep.handle(p.QueryEstimate(target=PORT.P(dp=1))).kind == "unsupported"
    ctrl.shutdown()


# ---------------------------------------------------------------------------
# The scheduler against the JAX scheduler on the same stand-in controller
# ---------------------------------------------------------------------------


class FakeTime:
    """A wall clock that moves only when the stand-in trains."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


class StubEstimator:
    def __init__(self, est):
        self.est = est

    def estimate(self, target):
        return self.est


class FakeController:
    """tests/test_scheduler.py's duck-typed LiveRController, over one
    package's types and a :class:`FakeTime`: a resize commits after a fixed
    number of train steps."""

    def __init__(self, K, clock, steps_to_commit=3, ckpt_dir=None, step_sleep=0.0, peer_ok=False):
        self.K, self.clock = K, clock
        self.records: list = []
        self.iteration_times: list[float] = []
        self.ledger = K.GoodputLedger()
        self.step = 0
        self.ckpt_dir = ckpt_dir
        self.peer_ok = peer_ok
        self.stream_k = 4
        self.world = SimpleNamespace(parallel=K.P(dp=2), timings={})
        self.steps_to_commit = steps_to_commit
        self.step_sleep = step_sleep
        self._gen = 0
        self._inflight = None  # (gen, target, mode, countdown)

    def train_steps(self, n):
        for _ in range(n):
            t = self.clock.perf_counter()
            self.clock.sleep(self.step_sleep or 1e-4)
            self.step += 1
            self.iteration_times.append(self.step_sleep or 1e-4)
            self.ledger.record(t, self.clock.perf_counter(), "train", self.world.parallel.world_size)
            if self._inflight is not None:
                gen, target, mode, left = self._inflight
                left -= 1
                if left <= 0:
                    self._commit(gen, target, mode, "committed")
                else:
                    self._inflight = (gen, target, mode, left)
        return [0.0] * n

    def _commit(self, gen, target, mode, outcome):
        self.records.append(self.K.ReconfigRecord(
            gen_id=gen, src=self.world.parallel.describe(), dst=target.describe(), outcome=outcome,
            mode="live_overlap" if mode == "stream" else "live"))
        self.world = SimpleNamespace(parallel=target, timings={})
        self._inflight = None

    def request_resize(self, target, overlap=None, operating_point=None):
        assert self._inflight is None
        self._gen += 1
        self.last_operating_point = operating_point
        self._inflight = (self._gen, target, overlap, self.steps_to_commit)
        return self._gen

    def retarget_resize(self, target, overlap=None, operating_point=None):
        gen, old_target, mode, _ = self._inflight
        self.records.append(self.K.ReconfigRecord(
            gen_id=gen, src=self.world.parallel.describe(), dst=old_target.describe(), outcome="retargeted"))
        self._inflight = None
        return self.request_resize(target, overlap=overlap, operating_point=operating_point)

    def cancel_resize(self, outcome=None):
        if outcome is not None and self._inflight is not None:
            gen, target, mode, _ = self._inflight
            self.records.append(self.K.ReconfigRecord(
                gen_id=gen, src=self.world.parallel.describe(), dst=target.describe(), outcome=outcome))
        self._inflight = None

    def escalate_commit(self):
        if self._inflight is None:
            return None
        gen, target, mode, _ = self._inflight
        self._commit(gen, target, "stop_copy", "fell_back")
        return self.records[-1]

    def wait_shadow_ready(self, timeout=None):
        pass

    def checkpoint_now(self):
        pass

    def peer_coverage(self, target, lost_ranks=(), devices_failed=True):
        return self.peer_ok, (1 << 20 if self.peer_ok else 0)

    def fail_stop_recover(self, target, devices_failed=True, lost_ranks=()):
        self.last_devices_failed = devices_failed
        self.last_lost_ranks = tuple(lost_ranks)
        if self.peer_ok:
            mode, outcome = "peer_recover", "committed"
        elif self.ckpt_dir:
            mode, outcome = "fallback", "fell_back"
        else:
            raise self.K.RecoveryError("no peers, no parity, no ckpt_dir")
        rec = self.K.ReconfigRecord(gen_id=-1, src=self.world.parallel.describe(), dst=target.describe(),
                                    mode=mode, outcome=outcome, total_pause_s=0.01)
        self.records.append(rec)
        self.world = SimpleNamespace(parallel=target, timings={})
        self._inflight = None
        return rec


def _est(K, prepare=10.0, precopy=5.0, pause=2.0, **kw):
    return K.elastic.ReconfigEstimate(prepare_s=prepare, precopy_s=precopy, stream_pause_s=pause,
                                      stop_copy_pause_s=pause, plan_bytes=1 << 20, rounds=5, step_s=0.1, **kw)


def _recorder(K):
    class Recorder(K.endpoint.Endpoint):
        """Keeps the wire text of every command and response."""

        def __init__(self, inner):
            self.inner, self.kind, self.wire = inner, inner.kind, []

        def handle(self, cmd):
            resp = self.inner.handle(cmd)
            self.wire += [K.protocol.dumps(cmd), K.protocol.dumps(resp)]
            return resp

    return Recorder


def _run(K, ctrl, events, **kw):
    kw.setdefault("estimator", StubEstimator(_est(K, prepare=0.001, precopy=0.001, pause=0.001)))
    kw.setdefault("tail_steps", 1)
    ep = _recorder(K)(K.elastic.WireEndpoint(K.elastic.ControllerEndpoint(ctrl)))
    return K.elastic.ElasticScheduler(ep, **kw).run(events), ep.wire


# tests/test_scheduler.py's cases with a stand-in controller, each a function
# of one package and its fake clock: (report, wire text, stand-in)


def case_traffic_is_pure_protocol(K, clock):
    ctrl = FakeController(K, clock, steps_to_commit=3)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=K.P(dp=4), warning_s=1e9)])
    assert rep.outcomes[0].outcome == "committed" and wire
    src = inspect.getsource(K.scheduler)
    for forbidden in ("self.controller", ".train_steps(", ".request_resize(", ".retarget_resize(",
                      ".escalate_commit(", ".fail_stop_recover(", ".world.parallel"):
        assert forbidden not in src, forbidden
    return rep, wire, ctrl


def case_coalesce_and_retarget_bookkeeping(K, clock):
    ctrl = FakeController(K, clock, steps_to_commit=3)
    A, B = K.P(dp=4), K.P(dp=8)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=A, warning_s=1e9),
                               K.ResizeEvent(time_s=0.0, target=B, warning_s=1e9),
                               K.ResizeEvent(time_s=0.0, target=B, warning_s=1e9)])
    assert [o.outcome for o in rep.outcomes] == ["retargeted", "committed", "coalesced"]
    assert rep.aborted == 0 and ctrl.world.parallel == B
    assert [r.outcome for r in ctrl.records] == ["retargeted", "committed"]
    return rep, wire, ctrl


def case_resize_back_to_current_cancels_inflight(K, clock):
    ctrl = FakeController(K, clock, steps_to_commit=50)
    cur = ctrl.world.parallel
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=K.P(dp=4), warning_s=1e9),
                               K.ResizeEvent(time_s=0.0, target=cur, warning_s=1e9)])
    assert [o.outcome for o in rep.outcomes] == ["retargeted", "committed"]
    assert rep.outcomes[1].decision == "cancel"
    assert ctrl.world.parallel == cur and ctrl._inflight is None
    return rep, wire, ctrl


def case_checkpoint_rung_aborts_without_ckpt_dir(K, clock):
    ctrl = FakeController(K, clock)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=K.P(dp=4), warning_s=0.0)])
    assert (rep.outcomes[0].decision, rep.outcomes[0].outcome, rep.aborted) == ("checkpoint", "aborted", 1)
    return rep, wire, ctrl


def case_checkpoint_rung_restores_when_durable(K, clock):
    ctrl = FakeController(K, clock, ckpt_dir="ckpt")
    target = K.P(dp=4)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=target, warning_s=0.0)])
    o = rep.outcomes[0]
    assert (o.decision, o.outcome, o.mode) == ("checkpoint", "fell_back", "fallback")
    assert ctrl.world.parallel == target and ctrl.last_devices_failed is False
    return rep, wire, ctrl


def case_zero_window_resize_uses_peer_rung_when_covered(K, clock):
    ctrl = FakeController(K, clock, peer_ok=True)
    target = K.P(dp=1)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=target, warning_s=0.0)],
                     estimator=StubEstimator(_est(K, peer_ok=True)))
    o = rep.outcomes[0]
    assert (o.decision, o.outcome, o.mode) == ("peer_recover", "committed", "peer_recover")
    assert ctrl.world.parallel == target and ctrl.last_devices_failed is False
    assert ctrl.last_lost_ranks == (1,)
    return rep, wire, ctrl


def case_failstop_routes_to_peer_recovery_when_covered(K, clock):
    ctrl = FakeController(K, clock, steps_to_commit=50, peer_ok=True)
    target = K.P(dp=1)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=K.P(dp=4), warning_s=1e9),
                               K.FailStopEvent(time_s=0.0, target=target, lost_ranks=(1,))])
    assert [o.outcome for o in rep.outcomes] == ["retargeted", "committed"]
    assert rep.outcomes[1].decision == "peer_recover"
    assert ctrl.world.parallel == target and ctrl._inflight is None
    assert ctrl.last_devices_failed is True and ctrl.last_lost_ranks == (1,)
    return rep, wire, ctrl


def case_failstop_routes_to_checkpoint_and_supersedes_pending(K, clock):
    ctrl = FakeController(K, clock, steps_to_commit=50, ckpt_dir="ckpt")
    target = K.P(dp=1)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=K.P(dp=4), warning_s=1e9),
                               K.FailStopEvent(time_s=0.0, target=target)])
    assert [o.outcome for o in rep.outcomes] == ["retargeted", "fell_back"]
    assert ctrl.world.parallel == target and ctrl._inflight is None
    assert "retargeted" in [r.outcome for r in ctrl.records] and ctrl.last_devices_failed is True
    return rep, wire, ctrl


def case_failstop_without_ckpt_cancels_inflight_and_aborts(K, clock):
    ctrl = FakeController(K, clock, steps_to_commit=50)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=K.P(dp=4), warning_s=1e9),
                               K.FailStopEvent(time_s=0.0, target=K.P(dp=1)),
                               K.ResizeEvent(time_s=0.0, target=K.P(dp=8), warning_s=1e9)])
    assert [o.outcome for o in rep.outcomes] == ["retargeted", "aborted", "committed"]
    assert ctrl.world.parallel == K.P(dp=8)
    return rep, wire, ctrl


def case_failstop_survivor_target_walks_down_to_feasible(K, clock):
    ctrl = FakeController(K, clock, ckpt_dir="ckpt")
    ctrl.cfg = K.get_config("qwen3-1.7b").reduced()
    ctrl.global_batch, ctrl.seq_len = 8, 32
    ctrl.world = SimpleNamespace(parallel=K.P(dp=2, tp=2), timings={})
    rep, wire = _run(K, ctrl, [K.FailStopEvent(time_s=0.0, lost_ranks=(3,))])
    assert rep.outcomes[0].outcome == "fell_back" and ctrl.world.parallel.world_size == 2
    return rep, wire, ctrl


def case_deadline_escalation_falls_back_to_stop_copy(K, clock):
    ctrl = FakeController(K, clock, steps_to_commit=10_000, step_sleep=0.002)
    est = K.elastic.ReconfigEstimate(prepare_s=0.001, precopy_s=0.004, stream_pause_s=0.001,
                                     stop_copy_pause_s=0.001, plan_bytes=1 << 20, rounds=4, step_s=0.002)
    rep, wire = _run(K, ctrl, [K.ResizeEvent(time_s=0.0, target=K.P(dp=4), warning_s=0.05)],
                     estimator=StubEstimator(est), tail_steps=0, max_steps=500)
    o = rep.outcomes[0]
    assert (o.decision, o.outcome) == ("stream", "fell_back") and ctrl.world.parallel == K.P(dp=4)
    return rep, wire, ctrl


CASES = [v for k, v in list(globals().items()) if k.startswith("case_")]


def _report(rep) -> dict:
    d = rep.to_dict()
    del d["wall_s"]
    return d


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_scheduler_equals_jax_on_the_stand_in(case, same_constants, monkeypatch):
    runs = {}
    for name, K in (("jax", JAX), ("port", PORT)):
        clock = FakeTime()
        monkeypatch.setattr(K.scheduler, "time", clock)
        runs[name] = case(K, clock)
    (jrep, jwire, jctrl), (rep, wire, ctrl) = runs["jax"], runs["port"]
    assert _report(rep) == _report(jrep)
    assert wire == jwire
    views = tuple(p.RecordView.from_record(r) for r in ctrl.records)
    jviews = tuple(jax_protocol.RecordView.from_record(r) for r in jctrl.records)
    assert p.dumps(p.RecordsResponse(records=views)) == jax_protocol.dumps(jax_protocol.RecordsResponse(records=jviews))


def test_choose_mode_equals_jax_on_the_lattice():
    import itertools

    for prepare, precopy, pause, peer_ok in itertools.product((0.0, 0.5, 10.0), (0.0, 5.0), (0.1, 2.0), (False, True)):
        est, jest = _est(PORT, prepare, precopy, pause, peer_ok=peer_ok), _est(JAX, prepare, precopy, pause,
                                                                                   peer_ok=peer_ok)
        for window in (0.0, 1.0, 12 * 1.25, 17 * 1.25, 17 * 1.25 - 1e-6, 30.0, 1e9, math.inf):
            for ts in (0.5, 1.0, 2.0):
                for lossless in (False, True):
                    assert port_scheduler.choose_mode(est, window, 1.25, ts, lossless) == jax_scheduler.choose_mode(
                        jest, window, 1.25, ts, lossless)


# ---------------------------------------------------------------------------
# The endpoints' helpers against the JAX package's
# ---------------------------------------------------------------------------


def _history(K) -> list:
    R = K.ReconfigRecord
    return [
        R(gen_id=1, src="a", dst="b", prepare_s=0.8, transfer_s=0.5, moved_bytes=1 << 28, wire_bytes=1 << 26),
        R(gen_id=2, src="a", dst="b", mode="live_overlap", prepare_s=0.3, transfer_s=0.1, resync_s=0.05,
          precopy_s=0.4, moved_bytes=3 << 27, wire_bytes=1 << 27, warm_hit=True, prepare_source="pool"),
        R(gen_id=3, src="a", dst="b", prepare_s=0.2, prepare_source="speculative_join", transfer_s=0.2,
          moved_bytes=1 << 27),
        R(gen_id=4, src="a", dst="b", outcome="retargeted", prepare_s=0.0),  # mid-prepare: no timing
        R(gen_id=5, src="a", dst="b", outcome="retargeted", prepare_s=1.7, transfer_s=0.3, moved_bytes=1 << 26),
        R(gen_id=6, src="a", dst="b", mode="peer_recover", prepare_s=9.0, transfer_s=1.0, moved_bytes=1 << 20),
        R(gen_id=7, src="a", dst="b", outcome="fell_back", prepare_s=1.1, transfer_s=0.6, precopy_s=0.2,
          moved_bytes=1 << 29),
    ]


def _estimator_stand_in(K, records, timings, wire_policy=None):
    return SimpleNamespace(
        records=records, iteration_times=[0.31, 0.52, 0.44, 0.47], world=SimpleNamespace(
            parallel=K.P(dp=2, tp=2), timings=timings), cfg=K.get_config("qwen3-1.7b").reduced(),
        source_policy="nearest", stream_k=4, wire_policy=wire_policy)


@pytest.mark.parametrize("history", [0, 1, 3, 7])
@pytest.mark.parametrize("timings", ["warm_s", "compile"])
@pytest.mark.parametrize("wire", [False, True])
def test_deadline_estimator_equals_jax(history, timings, wire):
    t = {"warm_s": 1.5} if timings == "warm_s" else {"mesh_s": 0.5, "lower_s": 2.0, "compile_s": 3.5}
    got = {}
    for name, K in (("jax", JAX), ("port", PORT)):
        ctrl = _estimator_stand_in(K, _history(K)[:history], dict(t), K.WirePolicy() if wire else None)
        est = K.elastic.DeadlineEstimator(ctrl)
        got[name] = [dataclasses.asdict(est.estimate(K.P(**tgt))) for tgt in (dict(dp=1, tp=4), dict(dp=2, tp=1))]
        got[name].append((est.prepare_estimate(False), est.prepare_estimate(True), est.measured_bandwidth()))
    assert got["port"] == got["jax"]
    if history == 0:
        # the cold seed: the JAX formula over mesh/lower/compile; the port's
        # build records only warm_s, so it falls back to default_prepare_s
        assert got["port"][-1][0] == got["port"][0]["prepare_s"] == (20.0 if timings == "warm_s" else 6.0)


def _port_controller(**kw):
    cfg = port_configs.get_config("qwen3-1.7b").reduced()
    kw.setdefault("seed", 0)
    return LiveRController(cfg, kw.pop("parallel", PORT.P(dp=2, tp=2)), AdamWConfig(learning_rate=1e-3, warmup_steps=5),
                           seq_len=32, global_batch=8, device="cpu", **kw)


def test_port_cold_prepare_estimate_falls_back_to_the_default():
    ctrl = _port_controller()
    assert not {"mesh_s", "lower_s", "compile_s"} & set(ctrl.world.timings) and "warm_s" in ctrl.world.timings
    est = port_elastic.DeadlineEstimator(ctrl)
    assert est.prepare_estimate() == est.default_prepare_s == 20.0
    e = est.estimate(PORT.P(dp=1, tp=4))
    assert e.prepare_s == 20.0 and not e.warm and e.measured_bw == 0.0
    assert e.peer_ok  # a world of 4: no rank of dp2tp2 is lost
    assert est.estimate(PORT.P(dp=1, tp=2)).peer_ok  # ranks 0, 1 survive: one whole replica
    assert not est.estimate(PORT.P(dp=1, tp=1)).peer_ok  # rank 0 alone holds half of each tensor
    # a record gives the estimator its history
    ctrl.request_resize(PORT.P(dp=1, tp=4), overlap="stop_copy")
    ctrl.wait_shadow_ready()
    ctrl.train_steps(2)
    assert ctrl.records[-1].outcome == "committed"
    assert est.prepare_estimate() == pytest.approx(ctrl.records[-1].prepare_s)


def test_port_controller_rank_pool():
    ctrl = _port_controller()
    assert ctrl.devices == [torch.device("cpu")] * port_controller.DEFAULT_RANK_POOL == [torch.device("cpu")] * 8
    assert _port_controller(devices=["cpu"] * 4).devices == [torch.device("cpu")] * 4
    for bad in ([], ["cpu", "meta"], ["meta"] * 8):
        with pytest.raises(ValueError, match="every rank of the pool"):
            _port_controller(devices=bad)
    # a world larger than the pool still maps its ranks to the one device
    small = _port_controller(devices=["cpu"] * 2)
    assert small.world.devices == [torch.device("cpu")] * 4


@pytest.mark.parametrize("n_devices", [4, 8, 16])
@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-2.7b"])
def test_prefetch_candidates_equal_jax(name, n_devices, same_constants):
    got = {}
    for key, K in (("jax", JAX), ("port", PORT)):
        out = []
        for cur in (K.P(dp=2, tp=2), K.P(dp=1, tp=4), K.P(dp=4)):
            ctrl = SimpleNamespace(cfg=K.get_config(name), world=SimpleNamespace(parallel=cur),
                                   devices=[0] * n_devices, global_batch=32, seq_len=1024)
            out.append([c.describe() for c in K.elastic.PrefetchPolicy(ctrl, k=2, max_pp=1).candidates()])
        got[key] = out
    assert got["port"] == got["jax"]


def test_prefetch_candidates_of_the_port_controller(same_constants):
    ctrl = _port_controller(devices=["cpu"] * 4)
    jstand = SimpleNamespace(cfg=JAX.get_config("qwen3-1.7b").reduced(), world=SimpleNamespace(
        parallel=JAX.P(dp=2, tp=2)), devices=[0] * 4, global_batch=8, seq_len=32)
    want = [c.describe() for c in jax_elastic.PrefetchPolicy(jstand, k=2).candidates()]
    assert [c.describe() for c in port_elastic.PrefetchPolicy(ctrl, k=2).candidates()] == want
    assert want


# ---------------------------------------------------------------------------
# The port's real controller under the scheduler, on the CPU
# ---------------------------------------------------------------------------

STEP_S = 1000.0  # a trace second per step far above any wall time a command takes


def _step_clock(K):
    class StepClock(K.endpoint.Endpoint):
        """Reports a clock of ``STEP_S`` a train step, so that events land on
        fixed steps whatever the wall clock does."""

        def __init__(self, inner):
            self.inner, self.kind, self.steps = inner, inner.kind, 0

        @property
        def prefetch(self):
            return getattr(self.inner, "prefetch", None)

        def handle(self, cmd):
            resp = self.inner.handle(cmd)
            if isinstance(resp, K.protocol.StepResult):
                self.steps += resp.steps
                resp = K.protocol.StepResult(steps=resp.steps, clock_s=self.steps * STEP_S)
            return resp

    return StepClock


def _state(ctrl) -> dict:
    named, extras = named_state_leaves(ctrl.params, ctrl.opt_state)
    return {**{k: v.clone() for k, v in named.items()}, "count": extras["count"].clone()}


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step
    assert a.train_steps(2) == b.train_steps(2)


def test_scheduler_resize_bitwise_equal_to_direct():
    target = PORT.P(dp=1, tp=4)
    a = _port_controller()
    rep = port_elastic.ElasticScheduler(a, sync_prepare=True, mode_override="stop_copy", tail_steps=3).run(
        [PORT.ResizeEvent(time_s=0.0, target=target, warning_s=1e9)])
    assert rep.aborted == 0 and rep.outcomes[0].outcome == "committed"
    b = _port_controller()
    b.request_resize(target)
    b.wait_shadow_ready()
    b.train_steps(1 + 3)
    assert b.records[0].outcome == "committed"
    _assert_same_state(a, b)


def _stream_retarget_failstop_trace(K, k):
    T1, T2 = K.P(dp=2, tp=4), K.P(dp=1, tp=4)
    return [K.ResizeEvent(k * STEP_S, T1, math.inf), K.ResizeEvent((k + 1) * STEP_S, T2, math.inf),
            K.ResizeEvent((k + 1) * STEP_S, T2, math.inf), K.FailStopEvent((k + 2) * STEP_S, lost_ranks=(2, 3))]


def test_scheduler_stream_retarget_failstop_bitwise_equal_to_direct():
    """A streamed resize, a retarget one step later that adopts the streamed
    layers, its duplicate, and a fail-stop of ranks 2 and 3 (target from
    ``QuerySurvivorTarget``, recovered from the surviving replica) one step
    after that: the scheduler's run equals the same calls made directly at
    the same steps, bitwise."""
    k = 2
    a = _port_controller(overlap="stream", stream_k=1)
    ep = _step_clock(PORT)(port_elastic.WireEndpoint(port_elastic.ControllerEndpoint(a)))
    rep = port_elastic.ElasticScheduler(ep, sync_prepare=True, tail_steps=2).run(_stream_retarget_failstop_trace(PORT, k))
    assert [(o.decision, o.outcome) for o in rep.outcomes] == [
        ("stream", "retargeted"), ("stream", "retargeted"), ("coalesce", "coalesced"), ("peer_recover", "committed")]
    assert [(r.mode, r.outcome) for r in a.records] == [
        ("live_overlap", "retargeted"), ("live_overlap", "retargeted"), ("peer_recover", "committed")]
    assert a.records[1].reused_layers >= 1 and a.records[2].donors >= 1
    target = a.world.parallel
    assert rep.outcomes[3].target == target.describe() and target.world_size == 2
    ops = [OperatingPoint(**o.operating_point) for o in rep.outcomes[:2]]

    b = _port_controller(overlap="stream", stream_k=1)
    for _ in range(k):
        b.train_steps(1)
    b.request_resize(PORT.P(dp=2, tp=4), overlap="stream", operating_point=ops[0])
    b.wait_shadow_ready()
    b.train_steps(1)
    b.retarget_resize(PORT.P(dp=1, tp=4), overlap="stream", operating_point=ops[1])
    b.wait_shadow_ready()
    b.train_steps(1)
    b.cancel_resize(outcome="retargeted")
    b.fail_stop_recover(target, devices_failed=True, lost_ranks=(2, 3))
    b.train_steps(2)
    assert [(r.mode, r.outcome, r.dst) for r in b.records] == [(r.mode, r.outcome, r.dst) for r in a.records]
    _assert_same_state(a, b)


def _bridge(jax_side: bool):
    """An endpoint of one package over an endpoint of the other: each
    command is ``dumps``-ed by the driver's package and ``loads``-ed by the
    endpoint's, and each response the other way."""
    drv, srv = (jax_protocol, p) if jax_side else (p, jax_protocol)
    base = jax_endpoint.Endpoint if jax_side else port_endpoint.Endpoint

    class Bridge(base):
        def __init__(self, inner):
            self.inner, self.kind, self.crossed = inner, inner.kind, 0

        def handle(self, cmd):
            resp = self.inner.handle(srv.loads(drv.dumps(cmd)))
            self.crossed += 1
            return drv.loads(srv.dumps(resp))

    return Bridge


def test_jax_scheduler_drives_the_port_controller_across_the_bridge():
    # the second event's operating point is tuned on the first commit's
    # measured bandwidth, a wall time: only its source is compared
    fields = ("kind", "time_s", "window_s", "target", "decision", "decision_lossless", "outcome", "gen_id", "mode",
              "reused_layers", "resident_layers", "resident_cells", "skipped_bytes")

    def trace(K):
        return [K.ResizeEvent(1 * STEP_S, K.P(dp=1, tp=4), math.inf), K.ResizeEvent(6 * STEP_S, K.P(dp=2, tp=2),
                                                                                     math.inf)]

    runs = {}
    for name, K in (("jax", JAX), ("port", PORT)):
        ctrl = _port_controller(overlap="stream", stream_k=2)
        inner = port_elastic.ControllerEndpoint(ctrl)
        ep = _bridge(True)(inner) if K is JAX else port_elastic.WireEndpoint(inner)
        rep = K.elastic.ElasticScheduler(_step_clock(K)(ep), sync_prepare=True, tail_steps=2).run(trace(K))
        runs[name] = ([{**{f: o.to_dict()[f] for f in fields}, "op_source": o.operating_point["source"]}
                       for o in rep.outcomes], ctrl, ep)
    (jout, jctrl, bridge), (out, ctrl, _) = runs["jax"], runs["port"]
    assert bridge.crossed > 0
    assert jout == out
    assert [(o["decision"], o["outcome"]) for o in out] == [("stream", "committed"), ("stream", "committed")]
    _assert_same_state(jctrl, ctrl)


# ---------------------------------------------------------------------------
# The trace reader
# ---------------------------------------------------------------------------


def test_spot_trace_equals_jax():
    for kw in (dict(world_choices=(4, 8), seed=7), dict(world_choices=(2, 4, 8), seed=3, emit_lost=True),
               dict(seed=1, failstop_every=0)):
        got = port_volatility.spot_trace(4 * 3600, 600, **kw)
        assert got == jax_volatility.spot_trace(4 * 3600, 600, **kw) and len(got) > 5


def test_events_from_trace_equals_jax(same_constants):
    rows = port_volatility.spot_trace(6 * 3600, 600, world_choices=(1, 2, 4, 8), seed=5, emit_lost=True)
    for name, batch, seq in (("qwen3-1.7b", 8, 32), ("qwen3-1.7b", 32, 1024), ("mamba2-2.7b", 16, 512)):
        for max_pp in (1, 8):
            evs = port_elastic.events_from_trace(rows, port_configs.get_config(name), batch, seq, compress=60.0,
                                                 max_pp=max_pp)
            jevs = jax_elastic.events_from_trace(rows, jax_configs.get_config(name), batch, seq, compress=60.0,
                                                 max_pp=max_pp)
            assert [p.dumps(e) for e in evs] == [jax_protocol.dumps(e) for e in jevs]


def test_events_from_trace_compresses_times_and_windows(same_constants):
    cfg = port_configs.get_config("qwen3-1.7b").reduced()
    evs = port_elastic.events_from_trace([(120.0, 4, "resize", 60.0), (240.0, 8, "fail_stop", 0.0)], cfg,
                                         global_batch=8, seq_len=32, compress=60.0)
    assert evs[0].time_s == pytest.approx(2.0) and evs[0].warning_s == pytest.approx(1.0)
    assert evs[0].target.world_size == 4
    assert isinstance(evs[1], PORT.FailStopEvent) and evs[1].target.world_size == 8


def test_events_from_trace_rejects_malformed_rows():
    cfg = port_configs.get_config("qwen3-1.7b").reduced()

    def convert(rows):
        return port_elastic.events_from_trace(rows, cfg, global_batch=8, seq_len=32)

    assert len(convert([(0.0, 4, "resize", 60.0)])) == 1
    bad = [[(5.0,)], [(-1.0, 4)], [(float("nan"), 4)], [("soon", 4)], [(0.0, 0)], [(0.0, 2.5)],
           [(0.0, 4, "explode")], [(0.0, 4, "resize", -3.0)], [(0.0, 4, "resize", float("nan"))],
           [(0.0, 4, "resize", 60.0, (1,))], [(0.0, 4, "fail_stop", 0.0, 7)], [(0.0, 4, "fail_stop", 0.0, (-1,))]]
    for rows in bad:
        with pytest.raises(port_errors.TraceError):
            convert(rows)
    assert convert([(0.0, 4, "resize", float("inf"))])[0].warning_s == float("inf")
    with pytest.raises(port_errors.TraceError, match="row 1"):
        convert([(0.0, 4), (1.0, 0)])
