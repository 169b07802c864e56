"""Reconfiguration-system models over the DES engine: LiveR vs the two
checkpoint baselines (Megatron-LM Checkpoint restart, UCP reshape-on-load),
reproducing the paper's evaluation figures at arbitrary scale.

A copy of the JAX package's ``sim/liver_sim.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from repro_torch.core.downtime import GoodputLedger
from repro_torch.sim.cluster import ClusterModel, model_state_bytes
from repro_torch.sim.des import Simulator


class SystemKind(str, enum.Enum):
    LIVER = "liver"
    MEGATRON_CKPT = "megatron_ckpt"
    UCP = "ucp"


@dataclass
class Downtime:
    phases: dict[str, float]

    @property
    def total(self) -> float:
        return sum(self.phases.values())


def reconfig_downtime(
    system: SystemKind,
    cluster: ClusterModel,
    params: float,
    world_before: int,
    world_after: int,
    move_fraction: float = 1.0,
    storage_bw_override: float | None = None,
) -> Downtime:
    """Downtime (training paused) for one resize event.

    LiveR streams the bf16 parameter state P2P (paper §6.3: ~28 GB for 14B);
    restart systems reload the FULL mixed-precision training state
    (≈10 B/param) from shared storage. move_fraction: fraction of state
    bytes that actually moves under the intersection plan (1.0 = worst case;
    the measured fraction for a given transition can be plugged in from
    core/intersection.py).
    """
    world = max(world_before, world_after)
    cl = cluster
    if storage_bw_override is not None:
        cl = _with_storage(cluster, storage_bw_override)

    if system is SystemKind.LIVER:
        live_state = model_state_bytes(params)  # bf16 params, P2P
        return Downtime(
            {
                "drain": cl.drain_s,
                "transfer": cl.transfer_s(live_state * move_fraction, world),
                "switch": cl.switch_s,
            }
        )
    full_state = model_state_bytes(params, with_optimizer=True)
    load = cl.ckpt_load_s(full_state, world_after)
    if system is SystemKind.UCP:
        load *= 0.55  # parallel reshape-on-load (paper: narrows reload gap)
    return Downtime(
        {
            "ckpt_load": load,
            "proc_spawn": cl.proc_spawn_s,
            "cuda_init": cl.cuda_init_s,
            "dist_init": cl.dist_init_s(world_after),
            "misc": cl.misc_s,
        }
    )


def _with_storage(cluster: ClusterModel, bw: float) -> ClusterModel:
    import dataclasses

    return dataclasses.replace(cluster, storage_bw_gbps_per_gpu=bw)


# ---------------------------------------------------------------------------
# Volatility runs (Figs. 7 & 8)
# ---------------------------------------------------------------------------


@dataclass
class VolatilityResult:
    ledger: GoodputLedger
    events: int
    reconfig_pause_s: float
    goodput: float
    wasted_gpu_hours: float


def volatility_run(
    system: SystemKind,
    cluster: ClusterModel,
    params: float,
    trace: list[tuple[float, int]],  # (event time, new world size)
    duration_s: float,
    initial_world: int,
    ckpt_interval_s: float = 300.0,
) -> VolatilityResult:
    """Discrete-event run of a volatility trace.

    Each event pauses training for the system's reconfiguration downtime.
    Checkpoint-based systems additionally *lose progress back to the last
    durable checkpoint* (the preemption warning is too short to finish a
    full distributed save, so they fall back — the paper's own baseline
    setting: "we choose to fallback to previous checkpoint"); the lost work
    is re-computed, accounted as idle GPU area. LiveR loses nothing (the
    live handoff preserves iteration N state) and pays only the measured
    0.28 % steady-state overhead while the shadow world prepares.
    """
    sim = Simulator()
    ledger = GoodputLedger()
    state = {"world": initial_world, "pause_total": 0.0}

    t_prev = 0.0
    events = sorted(trace)
    for ev_time, new_world in events:
        if ev_time >= duration_s:
            break
        if ev_time > t_prev:
            ledger.record(t_prev, ev_time, "train", state["world"])
        dt = reconfig_downtime(
            system, cluster, params, state["world"], new_world
        ).total
        if system is SystemKind.LIVER:
            prep = cluster.prepare_s(max(state["world"], new_world))
            dt += prep * cluster.steady_overhead
            lost = 0.0
        else:
            # progress since the last checkpoint is recomputed
            lost = min(ev_time - t_prev, (ev_time - t_prev) % ckpt_interval_s)
        end = min(ev_time + dt, duration_s)
        ledger.record(ev_time, end, "pause", max(state["world"], new_world))
        if lost > 0:
            ledger.record(end, end, "idle", 0)  # marker
            # recomputation: training time that produces no new progress
            redo_end = min(end + lost, duration_s)
            ledger.record(end, redo_end, "idle", new_world)
            end = redo_end
        state["pause_total"] += dt if ev_time + dt <= duration_s else duration_s - ev_time
        state["world"] = new_world
        t_prev = end
    if t_prev < duration_s:
        ledger.record(t_prev, duration_s, "train", state["world"])

    return VolatilityResult(
        ledger=ledger,
        events=len([e for e in events if e[0] < duration_s]),
        reconfig_pause_s=state["pause_total"],
        goodput=ledger.goodput,
        wasted_gpu_hours=ledger.wasted_gpu_hours(),
    )
