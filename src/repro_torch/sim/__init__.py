"""The reconfiguration simulator: a copy of the JAX package's ``sim/``
(without ``calibrate.py``). Its cluster models are the reference's, not
measurements of the H100."""

from repro_torch.sim.des import Simulator
from repro_torch.sim.cluster import ClusterModel, PAPER_TESTBED, TPU_V5E_POD
from repro_torch.sim.liver_sim import (
    reconfig_downtime,
    volatility_run,
    SystemKind,
)
from repro_torch.sim.volatility import make_trace, REGIMES

__all__ = [
    "Simulator",
    "ClusterModel",
    "PAPER_TESTBED",
    "TPU_V5E_POD",
    "reconfig_downtime",
    "volatility_run",
    "SystemKind",
    "make_trace",
    "REGIMES",
]
