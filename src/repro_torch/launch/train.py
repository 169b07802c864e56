"""Elastic training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-1.7b --reduced --device cpu --dp 2 --tp 2 --steps 20 \\
        --seq 32 --batch 8 --resize 5:dp2,tp4 --resize 12:dp1,tp4 --overlap stream

Each ``--resize STEP:SPEC`` (SPEC comma-separated, ``dp2,tp4``) requests a
live reconfiguration at that step; the switch lands at the first iteration
boundary after the shadow world is ready (invariant I3), by stop-copy or,
with ``--overlap stream``, by overlapped streaming and a split-step commit.
``--failstop STEP:SPEC`` fails the ranks beyond SPEC's world at that step
and recovers onto SPEC from the survivors (``fail_stop_recover``), or from
the latest checkpoint under ``--ckpt-dir`` (written every
``--ckpt-interval`` steps) when they cannot cover the state.
Runs on the GPU unless ``--device cpu`` is given; a CUDA request without a
card exits with an error. The reshard wire is lossless here, as in the JAX
launcher; the compressed wire is the controller's ``wire_policy``.

Not ported, and refused with a message: pipeline stages (``--pp`` > 1) and
int8 gradient compression (``--compression int8_ef``). An SSM model
(mamba2-2.7b) trains on the CPU only: on the card its SSD kernel has no
backward yet, and the launcher raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import time


def parse_parallel(spec: str):
    """'dp2,tp4' -> ParallelConfig."""
    from repro_torch.configs.base import ParallelConfig

    kv = {}
    for part in spec.split(","):
        k = part.rstrip("0123456789")
        kv[k] = int(part[len(k):])
    return ParallelConfig(**kv)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--overlap", default="stop_copy", choices=["stop_copy", "stream"],
                    help="reconfiguration transfer mode: stop-copy pause or "
                    "overlapped layer streaming with split-step commit")
    ap.add_argument("--stream-k", type=int, default=4,
                    help="layers pre-copied per iteration boundary (overlap=stream)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--resize", action="append", default=[], metavar="STEP:SPEC")
    ap.add_argument("--failstop", default=None, metavar="STEP:SPEC")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write run record JSON here")
    args = ap.parse_args()

    unported = {
        "--pp > 1 (pipeline stages, ROADMAP queue 1 item 5)": args.pp > 1,
        "--compression int8_ef (gradient compression, ROADMAP queue 1 item 5)": args.compression != "none",
    }
    refused = [what for what, given in unported.items() if given]
    if refused:
        ap.error("not ported yet: " + "; ".join(refused))

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.controller import LiveRController
    from repro_torch.models.transformer import check_trainable
    from repro_torch.optim import AdamWConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    check_trainable(cfg, args.device)  # an SSM mixer on the card raises NotImplementedError
    parallel = ParallelConfig(dp=args.dp, pp=args.pp, tp=args.tp)
    opt = AdamWConfig(learning_rate=args.lr, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    print(f"[train] {cfg.name} {parallel.describe()} seq={args.seq} batch={args.batch} "
          f"steps={args.steps} device={args.device}", flush=True)
    ctrl = LiveRController(
        cfg, parallel, opt, seq_len=args.seq, global_batch=args.batch, device=args.device,
        ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
        microbatches=args.microbatches, overlap=args.overlap, stream_k=args.stream_k,
    )
    resizes = sorted((int(s.split(":")[0]), parse_parallel(s.split(":")[1])) for s in args.resize)
    failstop = None
    if args.failstop:
        at, spec = args.failstop.split(":")
        failstop = (int(at), parse_parallel(spec))

    losses: list[float] = []
    t0 = time.perf_counter()
    while ctrl.step < args.steps:
        while resizes and resizes[0][0] <= ctrl.step and not ctrl.reconfig_pending:
            _, target = resizes.pop(0)
            print(f"[event] step {ctrl.step}: resize -> {target.describe()} "
                  "(shadow prepare in background)", flush=True)
            ctrl.request_resize(target)
        if failstop and failstop[0] == ctrl.step:
            print(f"[event] step {ctrl.step}: FAIL-STOP -> {failstop[1].describe()}", flush=True)
            rec = ctrl.fail_stop_recover(failstop[1])
            print(f"[event] recovered via {rec.mode} at step {ctrl.step} in {rec.total_pause_s:.2f}s "
                  f"(moved {rec.moved_bytes / 1e6:.1f}MB, donors {rec.donors})", flush=True)
            failstop = None
        before = len(ctrl.records)
        losses += ctrl.train_steps(1)
        if len(ctrl.records) > before:
            r = ctrl.records[-1]
            print(f"[switch] step {ctrl.step}: {r.src} -> {r.dst} pause={r.total_pause_s * 1e3:.1f}ms "
                  f"(prepare {r.prepare_s:.2f}s overlapped, moved {r.moved_bytes / 1e6:.1f}MB)", flush=True)
        if ctrl.step % 10 == 0:
            print(f"  step {ctrl.step:5d} loss={losses[-1]:.4f} world={ctrl.world.parallel.describe()}",
                  flush=True)

    wall = time.perf_counter() - t0
    print(f"[done] {args.steps} steps in {wall:.1f}s; goodput={ctrl.ledger.goodput * 100:.2f}% "
          f"pause_total={ctrl.ledger.pause_seconds:.3f}s reconfigs={len(ctrl.records)}", flush=True)
    if args.out:
        rec = {
            "arch": cfg.name,
            "device": str(ctrl.device),
            "losses": losses,
            "goodput": ctrl.ledger.goodput,
            "pause_seconds": ctrl.ledger.pause_seconds,
            "reconfigs": [
                {"src": r.src, "dst": r.dst, "mode": r.mode, "prepare_s": r.prepare_s,
                 "pause_s": r.total_pause_s, "moved_bytes": r.moved_bytes}
                for r in ctrl.records
            ],
            "iteration_times": ctrl.iteration_times,
        }
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)


if __name__ == "__main__":
    main()
