"""Two-job fleet demo on the PyTorch port: one volatile device pool
arbitrated across a REAL live training job and a simulated neighbor.

    PYTHONPATH=src python examples/fleet_train_torch.py
    PYTHONPATH=src python examples/fleet_train_torch.py --device cpu
    PYTHONPATH=src python examples/fleet_train_torch.py --all-sim

The torch version of ``examples/fleet_train.py``. The ``FleetArbiter``
plans the shared capacity trace with the marginal-throughput policy, then
each job replays its assigned events through the ``ElasticScheduler``:
the live job over the wire protocol against the port's
``LiveRController`` on the card's rank pool (8 ranks, every one on the
card; ``--device cpu`` puts them on the CPU), the simulated one against a
closed-form ``SimEndpoint`` on its virtual clock. Per-job goodput is
printed at exit. A CUDA request without a card raises.

``--all-sim`` swaps the live job for a second simulated one and runs the
whole fleet on one shared DES clock through ``FleetArbiter.run``: the
100-job-scale path, finishing in milliseconds, on no device.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# one shared capacity trace: grow to 16, shrink to 8, settle at 12
TRACE = [(8.0, 16, "resize", 1e9), (16.0, 8, "resize", 1e9), (24.0, 12, "resize", 1e9)]
INITIAL = 12
RANK_POOL = 8


def run_all_sim() -> None:
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.elastic import SimEndpoint, WireEndpoint
    from repro_torch.fleet import FleetArbiter, FleetJob, make_policy
    from repro_torch.sim.des import Simulator

    sim = Simulator()
    jobs = []
    for name, params in (("small", 0.4e9), ("big", 7e9)):
        ep = WireEndpoint(SimEndpoint(name, params=params, global_batch=256, parallel=ParallelConfig(dp=4), sim=sim))
        jobs.append(FleetJob(name=name, endpoint=ep, params=params, global_batch=256,
                             feasible_worlds=(1, 2, 4, 8, 12)))
    arb = FleetArbiter(jobs, make_policy("marginal"), sim=sim)
    # stretch the trace to hours so reconfig pauses are visible but small
    trace = [(t * 450, w, k, 120.0) for t, w, k, _ in TRACE]
    rep = arb.run(trace, duration_s=4 * 3600.0, initial_capacity=INITIAL)
    print(f"policy={rep.policy}  cluster goodput "
          f"{rep.cluster_goodput * 100:.1f}%  "
          f"({rep.arbitrated_events} arbitrated events)")
    for j in rep.jobs:
        print(f"  {j['name']:8s} world={j['world']:2d} "
              f"goodput={j['goodput'] * 100:6.2f}%  "
              f"samples={j['samples']:.0f}")


def run_mixed(device: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.controller import LiveRController
    from repro_torch.core.topology_search import best_target
    from repro_torch.elastic import ControllerEndpoint, DeadlineEstimator, ElasticScheduler, SimEndpoint, WireEndpoint
    from repro_torch.elastic import protocol as P
    from repro_torch.fleet import FleetArbiter, FleetJob, make_policy
    from repro_torch.optim import AdamWConfig

    cfg = get_config("qwen3-1.7b").reduced()
    print(f"live job: {cfg.name} on a pool of {RANK_POOL} ranks on {device}; sim job: 7B neighbor")
    ctrl = LiveRController(
        cfg, ParallelConfig(dp=2, tp=2), AdamWConfig(learning_rate=1e-3), seq_len=32, global_batch=8,
        overlap="stop_copy", device=device, devices=[device] * RANK_POOL,
    )
    ctrl.train_steps(4)  # warm-up: kernels built, estimator seeded

    live_ep = WireEndpoint(ControllerEndpoint(ctrl))
    targets = {w: best_target(cfg, w, 8, 32, max_pp=1) for w in (2, 4, 8)}
    sim_ep = WireEndpoint(SimEndpoint("sim-7b", params=7e9, global_batch=256, parallel=ParallelConfig(dp=4)))
    jobs = [
        FleetJob(name="live", endpoint=live_ep, params=float(cfg.param_count()), global_batch=8,
                 feasible_worlds=(2, 4, 8), target_fn=lambda w: targets[w]),
        FleetJob(name="sim-7b", endpoint=sim_ep, params=7e9, global_batch=256, feasible_worlds=(1, 2, 4, 8)),
    ]
    arb = FleetArbiter(jobs, make_policy("marginal"), calibrate=False)
    plans = arb.plan_assignments(TRACE, initial_capacity=INITIAL, default_warning_s=1e9)
    for name, evs in plans.items():
        moves = ", ".join(f"t={e.time_s:.0f}s→{e.target.world_size}dev" for e in evs)
        print(f"  plan[{name}]: {moves or 'hold'}")

    rep = ElasticScheduler(live_ep, estimator=DeadlineEstimator(ctrl), sync_prepare=True, tail_steps=2).run(
        plans["live"])
    srep = ElasticScheduler(sim_ep, tail_steps=2).run(plans["sim-7b"])
    ledger = sim_ep.handle(P.QueryLedger())

    print("\nper-job goodput:")
    print(f"  live    goodput={rep.goodput * 100:6.2f}%  steps={rep.steps}  "
          f"world={ctrl.world.parallel.describe()}  "
          f"outcomes={[o.outcome for o in rep.outcomes]}")
    print(f"  sim-7b  goodput={ledger.goodput * 100:6.2f}%  "
          f"steps={ledger.steps}  "
          f"outcomes={[o.outcome for o in srep.outcomes]}")
    print(f"control-plane traffic: live={live_ep.commands} cmds "
          f"({live_ep.bytes_tx + live_ep.bytes_rx} wire bytes), "
          f"sim={sim_ep.commands} cmds")
    if any(o.outcome not in ("committed", "coalesced") for o in rep.outcomes):
        sys.exit(f"a live event did not commit: {[o.outcome for o in rep.outcomes]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--all-sim", action="store_true", help="both jobs simulated on one shared DES clock")
    ap.add_argument("--device", default="cuda", help="the live job's device (not used with --all-sim)")
    args = ap.parse_args()
    if args.all_sim:
        run_all_sim()
    else:
        run_mixed(args.device)


if __name__ == "__main__":
    main()
