"""Fleet-scale elasticity: N jobs arbitrated over one volatile device
pool (ROADMAP item 4; DESIGN.md §18).

One shared spot/preemption trace names how many devices the cluster
holds at each moment; the :class:`FleetArbiter` decides *which job*
grows or shrinks — the "Brain" pattern from EasyDL — and tells each job
over the ``elastic/protocol.py`` control plane. Value functions come
from ``roofline/analysis.py``'s analytic scaling curves calibrated per
job; ``policies.py`` ships the static / fair-share baselines and the
marginal-throughput allocator the benchmark gates on.

A copy of the JAX package's ``fleet/__init__.py``.
"""

from repro_torch.fleet.arbiter import (
    ArbitratedEvent,
    FleetArbiter,
    FleetJob,
    FleetReport,
)
from repro_torch.fleet.policies import (
    FairSharePolicy,
    JobView,
    MarginalThroughputPolicy,
    Policy,
    StaticPolicy,
    make_policy,
)

__all__ = [
    "ArbitratedEvent",
    "FairSharePolicy",
    "FleetArbiter",
    "FleetJob",
    "FleetReport",
    "JobView",
    "MarginalThroughputPolicy",
    "Policy",
    "StaticPolicy",
    "make_policy",
]
