"""Serializable control-plane protocol (DESIGN.md §17).

Every interaction between a driver (``ElasticScheduler``, the fleet
arbiter) and a controller-like object is a typed Command answered by a
typed Response, both plain dataclasses that round-trip through JSON
bit-identically::

    encode(msg) -> dict -> json.dumps -> json.loads -> decode -> msg

The scheduler used to call ``LiveRController`` methods directly; moving
the boundary onto this wire format is what lets one driver address a
live controller, a serving controller, or a calibrated DES model
(``elastic/endpoint.py``) interchangeably — and is the prerequisite for
real multi-host deployment, where these dicts become RPC payloads.

Wire format
-----------
Each message encodes to a JSON object carrying the schema version and a
registered type tag::

    {"v": 1, "type": "request_resize", "target": {"dp": 2, ...}, ...}

Versioning rule: *additive* changes (a new message type, a new field
with a default) keep ``PROTOCOL_VERSION``; decoders ignore unknown
fields and apply defaults for missing ones, so old messages stay
readable. Any change that alters the meaning or encoding of an existing
field bumps the version, and the golden transcript
(``tests/golden/protocol_v<N>.jsonl``) is frozen per version. Decoding a
message from a *newer* major version raises :class:`ProtocolError`.

Non-JSON scalars follow repo convention: non-finite floats encode as the
strings ``"inf"`` / ``"-inf"`` / ``"nan"``. ``ParallelConfig`` encodes
as its axis dict and decodes back to the real frozen dataclass so
equality survives the wire. Tuples decode back to tuples (JSON arrays
are otherwise ambiguous), keyed off the declared field annotations.

A copy of the JAX package's ``elastic/protocol.py``: the same registry,
the same ``PROTOCOL_VERSION`` and the same wire, so that a message one
package ``dumps`` the other ``loads``, and a driver of either package can
address an endpoint of the other. The golden transcript is the JAX
package's, and the port only reads it: :func:`golden_messages` encodes to
it byte for byte. The port has no writer of it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import typing
from dataclasses import dataclass, fields
from typing import Any, Optional, Union

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.errors import ProtocolError
from repro_torch.core.events import FailStopEvent, ResizeEvent

PROTOCOL_VERSION = 1

# type tag -> message class, and the reverse (for encode)
_REGISTRY: dict[str, type] = {}
_TYPE_OF: dict[type, str] = {}


def register(type_name: str, cls: Optional[type] = None):
    """Register ``cls`` under ``type_name``. Usable as a decorator
    (``@register("ack")``) or directly for classes defined elsewhere
    (``register("resize_event", ResizeEvent)``)."""

    def _do(c: type) -> type:
        if type_name in _REGISTRY:
            raise ValueError(f"duplicate protocol type {type_name!r}")
        _REGISTRY[type_name] = c
        _TYPE_OF[c] = type_name
        return c

    return _do(cls) if cls is not None else _do


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------


def _enc(v: Any) -> Any:
    if isinstance(v, ParallelConfig):
        return {"dp": v.dp, "pp": v.pp, "tp": v.tp, "ep": v.ep}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _enc(getattr(v, f.name)) for f in fields(v)}
    if isinstance(v, (list, tuple)):
        return [_enc(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return "inf" if v > 0 else ("-inf" if v < 0 else "nan")
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    return v


def encode(msg: Any) -> dict:
    """Message dataclass -> JSON-ready dict (with version + type tag)."""
    tag = _TYPE_OF.get(type(msg))
    if tag is None:
        raise ProtocolError(f"unregistered message type {type(msg).__name__}")
    out: dict = {"v": PROTOCOL_VERSION, "type": tag}
    for f in fields(msg):
        out[f.name] = _enc(getattr(msg, f.name))
    return out


def _dec(v: Any, hint: Any) -> Any:
    origin = typing.get_origin(hint)
    if origin is Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if v is None:
            return None
        return _dec(v, args[0]) if len(args) == 1 else v
    if v is None:
        return None
    if hint is ParallelConfig:
        return ParallelConfig(**{k: int(v[k]) for k in ("dp", "pp", "tp", "ep")})
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        hints = typing.get_type_hints(hint)
        kw = {
            f.name: _dec(v[f.name], hints[f.name])
            for f in fields(hint)
            if f.name in v
        }
        return hint(**kw)
    if origin in (tuple, list):
        args = typing.get_args(hint)
        elem = args[0] if args else Any
        return tuple(_dec(x, elem) for x in v)
    if hint is float:
        if isinstance(v, str):
            return float(v)  # "inf" / "-inf" / "nan"
        return float(v)
    if hint is int:
        return int(v)
    return v


def decode(obj: dict) -> Any:
    """JSON dict -> message dataclass. Unknown fields are ignored
    (forward compatibility); missing fields take dataclass defaults."""
    if not isinstance(obj, dict) or "type" not in obj:
        raise ProtocolError(f"not a protocol message: {obj!r}")
    v = obj.get("v", 0)
    if not isinstance(v, int) or v > PROTOCOL_VERSION:
        raise ProtocolError(
            f"message version {v!r} newer than supported {PROTOCOL_VERSION}"
        )
    cls = _REGISTRY.get(obj["type"])
    if cls is None:
        raise ProtocolError(f"unknown message type {obj['type']!r}")
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in fields(cls):
        if f.name in obj:
            kw[f.name] = _dec(obj[f.name], hints[f.name])
        elif (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        ):
            raise ProtocolError(
                f"{obj['type']}: missing required field {f.name!r}"
            )
    try:
        return cls(**kw)
    except (TypeError, ValueError) as e:
        raise ProtocolError(f"{obj['type']}: {e}") from e


def dumps(msg: Any) -> str:
    """Canonical wire text: sorted keys, no whitespace — the form the
    golden transcript freezes."""
    return json.dumps(encode(msg), sort_keys=True, separators=(",", ":"))


def loads(text: str) -> Any:
    try:
        obj = json.loads(text)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"malformed wire text: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError(f"wire text must be a JSON object, got {type(obj).__name__}")
    return decode(obj)


# ---------------------------------------------------------------------------
# Shared payloads (nested in messages; not independently tagged)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReconfigEstimate:
    """Trigger-to-safe time estimates for one candidate reconfiguration.

    All in real seconds; the scheduler converts with its ``time_scale``
    before comparing to a (virtual-time) warning window.
    """

    prepare_s: float  # shadow build: mesh + lower + compile
    precopy_s: float  # streaming rounds riding iteration boundaries
    stream_pause_s: float  # commit pause of the overlapped path
    stop_copy_pause_s: float  # whole transfer inside one pause
    plan_bytes: int
    rounds: int
    step_s: float
    # prepare_s is the WARM estimate: the controller's pool holds a ready
    # world for the target, so Prepare skips lower+compile
    warm: bool = False
    # wire pricing (DESIGN.md §14): the pause estimates above are priced on
    # wire_bytes (what crosses the interconnect under the controller's
    # WirePolicy); lossless_transfer_s is what the same plan would cost
    # uncompressed, so the scheduler can report which rung the event would
    # have gotten without compression
    wire_bytes: int = 0
    layers: int = 0
    lossless_transfer_s: float = 0.0
    # peer_recover rung (DESIGN.md §15): True when the survivor set (plus
    # fresh parity) covers the state, so an in-memory donor stream can
    # replace the checkpoint round-trip; peer_pause_s prices that stream
    # (warm/cold prepare + donor bytes at measured bandwidth, lossless —
    # the recovery stream never compresses)
    peer_ok: bool = False
    peer_bytes: int = 0
    peer_pause_s: float = 0.0
    # measured transfer bandwidth behind the estimate (0.0 = no history
    # yet); carried on the wire so a remote driver can tune the rung's
    # operating point without reaching into the endpoint's estimator
    measured_bw: float = 0.0

    @property
    def stream_total_s(self) -> float:
        """Trigger -> committed via overlapped streaming."""
        return self.prepare_s + self.precopy_s + self.stream_pause_s

    @property
    def stop_copy_total_s(self) -> float:
        """Trigger -> committed via stop-copy (no boundary rounds)."""
        return self.prepare_s + self.stop_copy_pause_s

    @property
    def stream_total_lossless_s(self) -> float:
        """stream_total_s had the plan moved uncompressed."""
        return self.prepare_s + self.precopy_s + self.lossless_transfer_s

    @property
    def stop_copy_total_lossless_s(self) -> float:
        """stop_copy_total_s had the plan moved uncompressed."""
        return self.prepare_s + self.lossless_transfer_s


@dataclass(frozen=True)
class RecordView:
    """The wire projection of a ``ReconfigRecord`` / ``ServeRecord`` —
    exactly the fields the scheduler's absorb loop, the benchmarks and
    the fleet arbiter consume. Endpoints keep the full record private;
    drivers never see controller internals."""

    gen_id: int
    src: str = ""
    dst: str = ""
    mode: str = "live"
    outcome: str = "committed"
    prepare_s: float = 0.0
    total_pause_s: float = 0.0
    reused_layers: int = 0
    resident_layers: int = 0
    resident_cells: int = 0
    skipped_bytes: int = 0
    wire_bytes: int = 0
    logical_bytes: int = 0
    warm_hit: bool = False
    prepare_source: str = "cold"
    operating_point: Optional[dict] = None

    @classmethod
    def from_record(cls, rec: Any) -> "RecordView":
        op = getattr(rec, "operating_point", None)
        if op is not None and not isinstance(op, dict):
            op = op.to_dict()
        return cls(
            gen_id=int(getattr(rec, "gen_id", 0)),
            src=str(getattr(rec, "src", "")),
            dst=str(getattr(rec, "dst", "")),
            mode=str(getattr(rec, "mode", "live")),
            outcome=str(getattr(rec, "outcome", "committed")),
            prepare_s=float(getattr(rec, "prepare_s", 0.0)),
            total_pause_s=float(
                getattr(rec, "total_pause_s", getattr(rec, "pause_s", 0.0))
            ),
            reused_layers=int(getattr(rec, "reused_layers", 0)),
            resident_layers=int(getattr(rec, "resident_layers", 0)),
            resident_cells=int(getattr(rec, "resident_cells", 0)),
            skipped_bytes=int(getattr(rec, "skipped_bytes", 0)),
            wire_bytes=int(getattr(rec, "wire_bytes", 0)),
            logical_bytes=int(getattr(rec, "logical_bytes", 0)),
            warm_hit=bool(getattr(rec, "warm_hit", False)),
            prepare_source=str(getattr(rec, "prepare_source", "cold")),
            operating_point=op,
        )


# ---------------------------------------------------------------------------
# Commands (driver -> endpoint)
# ---------------------------------------------------------------------------


@register("train_steps")
@dataclass(frozen=True)
class TrainSteps:
    n: int = 1


@register("request_resize")
@dataclass(frozen=True)
class RequestResize:
    target: ParallelConfig
    overlap: Optional[str] = None  # "stream" | "stop_copy" | None
    # a tuned OperatingPoint's to_dict() (reshard/autotune.py); kept a
    # plain dict on the wire so the schema doesn't chase tuner fields
    operating_point: Optional[dict] = None


@register("retarget_resize")
@dataclass(frozen=True)
class RetargetResize:
    target: ParallelConfig
    overlap: Optional[str] = None
    operating_point: Optional[dict] = None


@register("escalate_commit")
@dataclass(frozen=True)
class EscalateCommit:
    pass


@register("cancel_resize")
@dataclass(frozen=True)
class CancelResize:
    outcome: Optional[str] = None


@register("fail_stop_recover")
@dataclass(frozen=True)
class FailStopRecover:
    target: ParallelConfig
    devices_failed: bool = True
    lost_ranks: tuple[int, ...] = ()


@register("checkpoint_now")
@dataclass(frozen=True)
class CheckpointNow:
    pass


@register("prefetch_world")
@dataclass(frozen=True)
class PrefetchWorld:
    target: ParallelConfig


@register("prefetch_tick")
@dataclass(frozen=True)
class PrefetchTick:
    pass


@register("wait_shadow_ready")
@dataclass(frozen=True)
class WaitShadowReady:
    timeout: Optional[float] = None


@register("query_status")
@dataclass(frozen=True)
class QueryStatus:
    pass


@register("query_records")
@dataclass(frozen=True)
class QueryRecords:
    since: int = 0  # record index; the response returns records[since:]


@register("query_estimate")
@dataclass(frozen=True)
class QueryEstimate:
    target: ParallelConfig


@register("query_ledger")
@dataclass(frozen=True)
class QueryLedger:
    pass


@register("query_survivor_target")
@dataclass(frozen=True)
class QuerySurvivorTarget:
    lost_ranks: tuple[int, ...] = ()


# ---------------------------------------------------------------------------
# Responses (endpoint -> driver)
# ---------------------------------------------------------------------------


@register("ack")
@dataclass(frozen=True)
class Ack:
    ok: bool = True
    detail: str = ""


@register("step_result")
@dataclass(frozen=True)
class StepResult:
    steps: int = 0
    # endpoints that own a virtual clock (SimEndpoint) report it here so
    # the driver's trace clock can follow simulated time; live endpoints
    # return -1.0 and the driver falls back to scaled wall time
    clock_s: float = -1.0


@register("resize_started")
@dataclass(frozen=True)
class ResizeStarted:
    gen_id: int


@register("escalate_result")
@dataclass(frozen=True)
class EscalateResult:
    escalated: bool
    record: Optional[RecordView] = None


@register("recover_result")
@dataclass(frozen=True)
class RecoverResult:
    record: RecordView


@register("prefetch_result")
@dataclass(frozen=True)
class PrefetchResult:
    started: int = 0


@register("status")
@dataclass(frozen=True)
class StatusResponse:
    parallel: ParallelConfig
    world_size: int
    step: int = 0
    reconfig_pending: bool = False
    durable: bool = False  # a checkpoint directory backs the last rung
    records: int = 0  # record count (drivers use it to resync absorb)
    kind: str = "train"  # "train" | "serve" | "sim"


@register("records")
@dataclass(frozen=True)
class RecordsResponse:
    records: tuple[RecordView, ...] = ()
    total: int = 0


@register("estimate")
@dataclass(frozen=True)
class EstimateResponse:
    estimate: ReconfigEstimate


@register("ledger")
@dataclass(frozen=True)
class LedgerResponse:
    goodput: float = 0.0
    pause_seconds: float = 0.0
    train_gpu_seconds: float = 0.0
    steps: int = 0
    samples: float = 0.0


@register("target")
@dataclass(frozen=True)
class TargetResponse:
    target: Optional[ParallelConfig] = None


@register("error")
@dataclass(frozen=True)
class ErrorResponse:
    kind: str  # "recovery" | "unsupported" | "invalid" | "internal"
    message: str = ""


# Events (arbiter -> driver): the existing core dataclasses go on the
# wire unchanged — registering them here keeps one codec for the whole
# control plane.
register("resize_event", ResizeEvent)
register("fail_stop_event", FailStopEvent)


COMMANDS = (
    TrainSteps, RequestResize, RetargetResize, EscalateCommit, CancelResize,
    FailStopRecover, CheckpointNow, PrefetchWorld, PrefetchTick,
    WaitShadowReady, QueryStatus, QueryRecords, QueryEstimate, QueryLedger,
    QuerySurvivorTarget,
)
RESPONSES = (
    Ack, StepResult, ResizeStarted, EscalateResult, RecoverResult,
    PrefetchResult, StatusResponse, RecordsResponse, EstimateResponse,
    LedgerResponse, TargetResponse, ErrorResponse,
)
EVENTS = (ResizeEvent, FailStopEvent)


# ---------------------------------------------------------------------------
# Golden transcript (tests/golden/protocol_v1.jsonl)
# ---------------------------------------------------------------------------


def golden_messages() -> list:
    """One representative instance per registered type, deterministic,
    exercising the tricky encodings: nested records, tuples, Optionals,
    non-finite floats. The committed golden file freezes ``dumps`` of
    each; tests/test_protocol.py diffs against it byte-for-byte."""
    tgt = ParallelConfig(dp=2, pp=1, tp=2)
    rec = RecordView(
        gen_id=3, src="dp4xpp1xtp1", dst="dp2xpp1xtp2", mode="live_overlap",
        outcome="committed", prepare_s=1.25, total_pause_s=0.125,
        reused_layers=4, resident_layers=2, resident_cells=9,
        skipped_bytes=1 << 20, wire_bytes=2048, logical_bytes=4096,
        warm_hit=True, prepare_source="pool",
        operating_point={"stream_k": 4, "chunk_bytes": 1 << 16,
                         "staging_bytes": 1 << 20, "source": "tuned"},
    )
    est = ReconfigEstimate(
        prepare_s=20.0, precopy_s=1.5, stream_pause_s=0.25,
        stop_copy_pause_s=2.5, plan_bytes=1 << 24, rounds=3, step_s=0.25,
        warm=False, wire_bytes=1 << 23, layers=12, lossless_transfer_s=5.0,
        peer_ok=True, peer_bytes=1 << 22, peer_pause_s=0.75,
        measured_bw=2.5e9,
    )
    return [
        TrainSteps(n=4),
        RequestResize(target=tgt, overlap="stream",
                      operating_point={"stream_k": 8, "chunk_bytes": 65536,
                                       "staging_bytes": 1 << 21,
                                       "source": "tuned"}),
        RetargetResize(target=ParallelConfig(dp=1, tp=2), overlap="stop_copy"),
        EscalateCommit(),
        CancelResize(outcome="skipped"),
        FailStopRecover(target=ParallelConfig(dp=2), devices_failed=True,
                        lost_ranks=(2, 3)),
        CheckpointNow(),
        PrefetchWorld(target=tgt),
        PrefetchTick(),
        WaitShadowReady(timeout=30.0),
        QueryStatus(),
        QueryRecords(since=2),
        QueryEstimate(target=tgt),
        QueryLedger(),
        QuerySurvivorTarget(lost_ranks=(6, 7)),
        Ack(ok=True, detail="checkpointed"),
        StepResult(steps=1, clock_s=12.5),
        ResizeStarted(gen_id=7),
        EscalateResult(escalated=True, record=rec),
        RecoverResult(record=rec),
        PrefetchResult(started=2),
        StatusResponse(parallel=tgt, world_size=4, step=120,
                       reconfig_pending=True, durable=True, records=5,
                       kind="train"),
        RecordsResponse(records=(rec,), total=4),
        EstimateResponse(estimate=est),
        LedgerResponse(goodput=0.9375, pause_seconds=12.5,
                       train_gpu_seconds=4000.0, steps=800, samples=204800.0),
        TargetResponse(target=ParallelConfig(dp=2, tp=1)),
        TargetResponse(target=None),
        ErrorResponse(kind="recovery", message="survivors do not cover state"),
        ResizeEvent(time_s=60.0, target=tgt, warning_s=120.0),
        ResizeEvent(time_s=90.0, target=ParallelConfig(dp=4),
                    warning_s=float("inf")),
        FailStopEvent(time_s=180.0, lost_ranks=(2, 3),
                      target=ParallelConfig(dp=1, tp=2)),
    ]

