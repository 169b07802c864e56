"""Elasticity beyond one reconfiguration: the peer-redundancy recovery
layer (``redundancy.py``, DESIGN.md §15) and the fault injector that drives
``LiveRController.fail_stop_recover`` from each lifecycle phase
(``faults.py``). The JAX package's control plane (the wire protocol, the
endpoints, the deadline scheduler and the trace reader) is not ported yet
(ROADMAP queue 1 item 9)."""

from repro_torch.elastic.faults import PHASES, FaultInjector, InjectionReport, controller_phase
from repro_torch.elastic.redundancy import (
    ParityStore,
    RecoveryError,
    RedundancyMap,
    balance_donors,
    heal_plan,
    survivors_for,
)

__all__ = [
    "PHASES",
    "FaultInjector",
    "InjectionReport",
    "ParityStore",
    "RecoveryError",
    "RedundancyMap",
    "balance_donors",
    "controller_phase",
    "heal_plan",
    "survivors_for",
]
