"""End-to-end elastic training on the PyTorch port: a ~100M-parameter model
trained for a few hundred steps with TWO live reconfigurations and one
fail-stop injected mid-run, the full LiveR lifecycle.

    PYTHONPATH=src python examples/elastic_train_torch.py [--steps 200]
    PYTHONPATH=src python examples/elastic_train_torch.py --device cpu --steps 8

The torch version of ``examples/elastic_train.py``. It runs on the card
(every rank of every world on the one device) unless ``--device cpu`` is
given; a CUDA request without a card raises.

``--trace SECONDS`` switches from the fixed schedule to the deadline-aware
``ElasticScheduler`` replaying a seeded spot-market event stream
(``sim.volatility.spot_trace``): resize warnings are coalesced/retargeted
and fall back down the lattice (stream -> stop-copy -> peer recovery ->
checkpoint) as their windows demand.

Watch for:
  * [event]/[switch] lines: training continues while the shadow world
    prepares; the pause at the switch is milliseconds;
  * goodput printed at the end;
  * the loss curve crossing reconfigurations without a blip (paper Fig. 9).

The checkpoint the fail-stop falls back to is written under a
``_elastic_train_ckpt_*`` directory beside this file's repository root and
removed at the end.
"""

import argparse
import dataclasses
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core.controller import LiveRController  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402


def run_trace(ctrl, trace_seconds: float) -> None:
    """Replay a seeded spot trace through the deadline scheduler."""
    from repro_torch.elastic import ElasticScheduler, events_from_trace
    from repro_torch.sim.volatility import spot_trace

    # ~10 events at native spacing 30x the live spacing, then compressed
    # 30x so events land roughly every ``trace_seconds`` of wall clock.
    # Warning windows are widened to ~90s live (2700 native), so that the
    # lattice picks live rungs rather than the checkpoint fallback.
    trace = spot_trace(
        trace_seconds * 30 * 10, trace_seconds * 30,
        world_choices=(4, 8), seed=5, warning_s=2700.0,
    )
    events = events_from_trace(
        trace, ctrl.cfg, ctrl.global_batch, ctrl.seq_len,
        compress=30.0, max_pp=1,
    )
    print(f"replaying {len(events)} events, one every ~{trace_seconds:.0f}s")
    sched = ElasticScheduler(
        ctrl,
        on_event=lambda o: print(
            f"[event {o.index}] {o.kind} -> {o.target}: "
            f"decision={o.decision or '-'} outcome={o.outcome or 'pending'}"
        ),
    )
    rep = sched.run(events)
    print(
        f"\ntrace done: {rep.steps} steps, goodput {rep.goodput*100:.2f}%, "
        f"pause {rep.pause_seconds:.2f}s"
    )
    for o in rep.outcomes:
        print(
            f"  ev{o.index} {o.kind:9s} {o.target:14s} "
            f"{o.decision:10s} -> {o.outcome:10s} "
            f"pause={o.pause_s*1e3:.0f}ms reused={o.reused_layers}"
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument(
        "--trace", type=float, default=0.0, metavar="SECONDS",
        help="replay a spot trace with ~SECONDS between events through the "
        "deadline scheduler instead of the fixed schedule",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ~100M params: qwen3 geometry at width 512
    cfg = dataclasses.replace(
        get_config("qwen3-1.7b"),
        name="qwen3-100m",
        num_layers=8,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        d_ff=2048,
        vocab_size=32000,
        dtype="float32",
    )
    from repro_torch.models.model import analytic_param_count

    print(f"model: {cfg.name} ({analytic_param_count(cfg)/1e6:.0f}M params)")

    ckpt_dir = tempfile.mkdtemp(prefix="_elastic_train_ckpt_", dir=ROOT)
    try:
        opt = AdamWConfig(learning_rate=6e-4, warmup_steps=20, total_steps=args.steps)
        ctrl = LiveRController(
            cfg,
            ParallelConfig(dp=2, tp=2),
            opt,
            seq_len=128,
            global_batch=8,
            ckpt_dir=ckpt_dir,
            ckpt_interval=40,
            device=args.device,
        )

        if args.trace:
            ctrl.train_steps(4)  # warm-up: the estimator gets step times
            # last-resort rung only: fail-stops recover from surviving peers
            # first (DESIGN.md §15); the checkpoint covers uncovered losses
            ctrl.checkpoint_now()
            run_trace(ctrl, args.trace)
            return

        schedule = {
            args.steps // 4: ("resize", ParallelConfig(dp=2, tp=4)),  # scale out
            args.steps // 2: ("resize", ParallelConfig(dp=1, tp=4)),  # scale in
            3 * args.steps // 4: ("failstop", ParallelConfig(dp=2, tp=2)),
        }
        losses = []
        while ctrl.step < args.steps:
            ev = schedule.pop(ctrl.step, None)
            if ev:
                kind, target = ev
                if kind == "resize":
                    print(f"[event] step {ctrl.step}: live resize -> {target.describe()}")
                    ctrl.request_resize(target)
                else:
                    print(f"[event] step {ctrl.step}: fail-stop!")
                    rec = ctrl.fail_stop_recover(target)
                    print(f"        recovered ({rec.mode}) to step {ctrl.step} in {rec.total_pause_s:.1f}s")
            n_before = len(ctrl.records)
            losses += ctrl.train_steps(1)
            if len(ctrl.records) > n_before and ctrl.records[-1].mode == "live":
                r = ctrl.records[-1]
                print(f"[switch] {r.src} -> {r.dst}: pause {r.total_pause_s*1e3:.0f}ms "
                      f"(prepare {r.prepare_s:.1f}s fully overlapped)")
            if ctrl.step % 20 == 0:
                print(f"  step {ctrl.step:4d} loss={losses[-1]:.4f} "
                      f"world={ctrl.world.parallel.describe()}")

        print(f"\nfinal loss {losses[-1]:.4f} (start {losses[0]:.4f})")
        print(f"goodput {ctrl.ledger.goodput*100:.2f}%  "
              f"total pause {ctrl.ledger.pause_seconds:.2f}s  "
              f"events: {[r.mode for r in ctrl.records]}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
