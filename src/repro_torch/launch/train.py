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

``--pp 2 --microbatches 4`` trains through pipeline stages (at least ``pp``
microbatches are run) and ``--resize 5:dp1,pp2,tp2`` resizes into them;
``--compression int8_ef`` sends the gradients through the int8 round trip
with error feedback (not with ``--pp`` > 1, which refuses it, as does an
enc-dec model). An SSM model trains
on the card through the SSD forward and backward kernels, at full width
for example

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --dp 2 --tp 2 --steps 10 --seq 1024 --batch 4

(fp32 params, gradients and Adam moments, about 45 GB at 64 layers by
count; the ``[done]`` line prints the card's peak. A live resize, which
holds the target world's state beside it, does not fit one 80 GB card at
that depth). An enc-dec model (``--arch seamless-m4t-large-v2``) trains on
the seeded frames of ``data.SyntheticFrames``: the JAX launcher's zero
frames make the encoder's gradients overflow at full depth. A MoE model
(``--arch mixtral-8x7b``) trains with its aux loss in the loss, and a
resize may change the expert-parallel degree (``--resize 5:dp2,tp2,ep2``).

``--nproc N`` trains per-rank worlds instead: N rank processes
(``launch/ranks.py``), each holding its shards of the state, under
``core/rank_controller.py::RankController``; a resize streams cells rank to
rank. On the card every rank is ``cuda:0`` and the ranks talk through gloo
via pinned host memory; ``--device cpu`` runs gloo on the CPU. Decoders of
attention blocks with dense or MoE MLPs, on dp x pp x ep x tp worlds
(``--microbatches`` on every world: a pipeline world runs at least ``pp``,
any other at most its rows a rank, which they must divide; an ep degree
comes with a resize spec, ``--resize 4:ep2,tp2``, as in the JAX launcher,
which has no ``--ep``);
``--failstop STEP:SPEC`` loses the ranks beyond SPEC's world (their state
poisoned and freed, ``RankController.lose_state``) and recovers onto SPEC
from the survivors or from the per-rank checkpoint under ``--ckpt-dir``
(the one-process format); no ``--compression``; rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --device cpu --nproc 8 --dp 2 --tp 2 --steps 12 --seq 32 --batch 8 \\
        --resize 4:dp2,tp4 --overlap stream --stream-k 2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --nproc 4 \\
        --pp 2 --tp 2 --microbatches 4 --resize 4:dp2,tp2
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b --reduced \\
        --device cpu --nproc 4 --tp 4 --resize 4:ep2,tp2 --resize 8:ep4,tp1
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --nproc 4 \\
        --dp 2 --tp 2 --steps 12 --seq 16 --batch 4 --ckpt-dir /tmp/ck --ckpt-interval 5 \\
        --failstop 8:dp1,tp2
"""

from __future__ import annotations

import argparse
import json
import time

import torch


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
    ap.add_argument("--nproc", type=int, default=0,
                    help="train per-rank worlds in this many rank processes (0: one process)")
    ap.add_argument("--out", default=None, help="write run record JSON here")
    args = ap.parse_args()
    if args.nproc:
        if args.compression != "none":
            ap.error("--nproc trains per-rank worlds: no --compression")
        from repro_torch.launch.ranks import run_ranks
        from repro_torch.models.model import resolve_device

        if resolve_device(args.device).type == "cuda":  # a CUDA request without a card fails here
            from repro_torch.kernels import build

            build.build_all()  # once, here, not in every rank
        out = run_ranks(_rank_main, args.nproc, vars(args), device=args.device)[0]
    else:
        try:
            ctrl = _controller(None, vars(args), print)
        except ValueError as e:  # a world the pipeline refuses (enc-dec, int8_ef)
            ap.error(str(e))
        out = _train(ctrl, vars(args), print)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)


def _rank_main(rank: int, args: dict) -> dict:
    """One rank process of ``--nproc``: the same loop on every rank, rank 0
    prints."""
    say = print if rank == 0 else (lambda *a, **k: None)
    return _train(_controller(rank, args, say), args, say)


def _controller(rank, args: dict, say):
    """The run's controller: one process (``rank`` None), or rank ``rank``
    of the per-rank pool."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import SyntheticFrames
    from repro_torch.optim import AdamWConfig

    cfg = get_config(args["arch"])
    if args["reduced"]:
        cfg = cfg.reduced()
    parallel = ParallelConfig(dp=args["dp"], pp=args["pp"], tp=args["tp"])
    steps = args["steps"]
    opt = AdamWConfig(learning_rate=args["lr"], warmup_steps=max(steps // 10, 1), total_steps=steps)
    data = None
    if cfg.family == "encdec":
        data = SyntheticFrames(cfg.vocab_size, args["seq"], args["batch"], cfg.d_model)
    kw = dict(data=data, microbatches=args["microbatches"], overlap=args["overlap"], stream_k=args["stream_k"])
    head = f"[train] {cfg.name} {parallel.describe()} seq={args['seq']} batch={args['batch']} steps={steps}"
    if rank is None:
        from repro_torch.core.controller import LiveRController

        say(f"{head} compression={args['compression']} device={args['device']}", flush=True)
        return LiveRController(cfg, parallel, opt, seq_len=args["seq"], global_batch=args["batch"],
                               device=args["device"], ckpt_dir=args["ckpt_dir"], ckpt_interval=args["ckpt_interval"],
                               compression=args["compression"], **kw)
    from repro_torch.core.rank_controller import RankController
    from repro_torch.distribution.groups import RankPool
    from repro_torch.launch.ranks import rank_device

    device = rank_device(args["device"], rank)
    pool = RankPool()
    say(f"{head} ranks={pool.size} backend={pool.backend} device={device}", flush=True)
    events = args["resize"] + ([args["failstop"]] if args["failstop"] else [])
    worlds = [parse_parallel(s.split(":")[1]) for s in events]
    return RankController(cfg, parallel, opt, args["seq"], args["batch"], pool, worlds=worlds, device=device,
                          ckpt_dir=args["ckpt_dir"], ckpt_interval=args["ckpt_interval"], **kw)


def _train(ctrl, args: dict, say) -> dict:
    """The training loop with its resizes and fail-stop; the run's record."""
    resizes = sorted((int(s.split(":")[0]), parse_parallel(s.split(":")[1])) for s in args["resize"])
    failstop = None
    if args["failstop"]:
        at, spec = args["failstop"].split(":")
        failstop = (int(at), parse_parallel(spec))
    pool = getattr(ctrl, "pool", None)
    steps = args["steps"]
    losses: list[float] = []
    t0 = time.perf_counter()
    while ctrl.step < steps:
        while resizes and resizes[0][0] <= ctrl.step and not ctrl.reconfig_pending:
            _, target = resizes.pop(0)
            say(f"[event] step {ctrl.step}: resize -> {target.describe()} (shadow prepare in background)", flush=True)
            ctrl.request_resize(target)
        if failstop and failstop[0] == ctrl.step:
            say(f"[event] step {ctrl.step}: FAIL-STOP -> {failstop[1].describe()}", flush=True)
            rec = ctrl.fail_stop_recover(failstop[1])  # on ranks, the lost ranks' state goes first
            say(f"[event] recovered via {rec.mode} at step {ctrl.step} in {rec.total_pause_s:.2f}s "
                f"(moved {rec.moved_bytes / 1e6:.1f}MB, donors {rec.donors})", flush=True)
            failstop = None
        before = len(ctrl.records)
        losses += ctrl.train_steps(1)
        if len(ctrl.records) > before:
            r = ctrl.records[-1]
            ranks = ""
            if pool is not None:
                rc = ctrl.rank_commits[-1]
                ranks = (f"; rank 0 sent {sum(rc.sent_bytes.values()) / 1e6:.1f}MB, host-staged "
                         f"{rc.host_bytes / 1e6:.1f}MB")
            say(f"[switch] step {ctrl.step}: {r.src} -> {r.dst} pause={r.total_pause_s * 1e3:.1f}ms "
                f"(prepare {r.prepare_s:.2f}s overlapped, moved {r.moved_bytes / 1e6:.1f}MB{ranks})", flush=True)
        if ctrl.step % 10 == 0:
            say(f"  step {ctrl.step:5d} loss={losses[-1]:.4f} world={ctrl.world.parallel.describe()}", flush=True)

    wall = time.perf_counter() - t0
    extra = ""
    if pool is not None:
        extra = f" host-staged {pool.staging.bytes / 1e9:.3f}GB in {pool.staging.seconds:.2f}s (rank 0)"
    if ctrl.device.type == "cuda":
        extra += f" peak={torch.cuda.max_memory_allocated(ctrl.device) / 1e9:.2f}GB"
    say(f"[done] {steps} steps in {wall:.1f}s; goodput={ctrl.ledger.goodput * 100:.2f}% "
        f"pause_total={ctrl.ledger.pause_seconds:.3f}s reconfigs={len(ctrl.records)}{extra}", flush=True)
    return {
        "arch": ctrl.cfg.name,
        "device": str(ctrl.device),
        "ranks": pool.size if pool is not None else 1,
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


if __name__ == "__main__":
    main()
