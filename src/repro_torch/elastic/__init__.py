"""Trace-driven elasticity scheduling (paper §2.3 event streams, §4.1).

The controller executes ONE reconfiguration; this package turns streams of
elasticity events — spot-market warnings, preemptions, fail-stops — into
deadline-aware decisions, spoken over a serializable command/response
protocol (``protocol.py``, DESIGN.md §17) to an endpoint
(``endpoint.py``) fronting the live :class:`LiveRController`, the serving
controller, or a calibrated DES model: overlapped streaming when the
warning window allows, stop-copy when it is tight, peer-replica recovery
when the window is gone but survivors still cover the state (DESIGN.md
§15, ``redundancy.py``), durable checkpoint only when nothing else fits
(DESIGN.md §10). ``faults.py`` drives ``LiveRController.fail_stop_recover``
from each lifecycle phase.

The port of the JAX package's ``elastic/``; it exports what the JAX
package's ``elastic/__init__.py`` does, and ``PHASES``, ``RankEndpoint``
and ``RankParityStore`` (per-rank worlds) besides.
"""

from repro_torch.elastic.endpoint import (
    ControllerEndpoint,
    DeadlineEstimator,
    Endpoint,
    PrefetchPolicy,
    RankEndpoint,
    ServeEndpoint,
    SimEndpoint,
    WireEndpoint,
    as_endpoint,
)
from repro_torch.elastic.faults import PHASES, FaultInjector, InjectionReport, controller_phase
from repro_torch.elastic.protocol import ReconfigEstimate, RecordView
from repro_torch.elastic.redundancy import (
    ParityStore,
    RankParityStore,
    RecoveryError,
    RedundancyMap,
    balance_donors,
    heal_plan,
    survivors_for,
)
from repro_torch.elastic.scheduler import (
    ElasticScheduler,
    EventOutcome,
    ScheduleReport,
    choose_mode,
)
from repro_torch.elastic.trace import events_from_trace

__all__ = [
    "PHASES",
    "ControllerEndpoint",
    "DeadlineEstimator",
    "ElasticScheduler",
    "Endpoint",
    "EventOutcome",
    "FaultInjector",
    "InjectionReport",
    "ParityStore",
    "PrefetchPolicy",
    "RankEndpoint",
    "RankParityStore",
    "ReconfigEstimate",
    "RecordView",
    "RecoveryError",
    "RedundancyMap",
    "ScheduleReport",
    "ServeEndpoint",
    "SimEndpoint",
    "WireEndpoint",
    "as_endpoint",
    "balance_donors",
    "choose_mode",
    "controller_phase",
    "events_from_trace",
    "heal_plan",
    "survivors_for",
]
