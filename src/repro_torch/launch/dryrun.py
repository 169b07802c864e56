"""Dry run of every (architecture x input-shape) cell on the meta device.

The counterpart of ``repro/launch/dryrun.py``. Where the JAX dry run
lowers and compiles each cell against the production mesh (16 x 16 one
pod, 2 x 16 x 16 two pods) and reads XLA's memory and cost analyses, this
one executes the port's own step once on the meta device, at full size,
and reads:

- the per-chip argument bytes: every input's shard under the sharding
  rules (``distribution/sharding.py``), summed exactly: params, the
  optimizer state (``mu``, ``nu``, ``count``), the batch, and for decode
  the cache and an enc-dec model's cross KV;
- the global FLOPs and bytes of the step (``roofline/counting.py``:
  ``FlopCounterMode``, the aten ops' bytes, and the kernels' own records
  from their meta routes), which the roofline formulas divide by the
  chips, as the JAX package does with its per-partition counts x chips;
- the step's peak live bytes above its inputs, reported as the temp bytes
  on a one-chip mesh only, where the global peak is the chip's.

No device is touched: the step runs on meta tensors, so nothing
initialises CUDA. Values with no honest counterpart yet are ``null`` and
``not_counted`` says why (the collective bytes wait for the per-rank step
to run under ``core/mock_groups.py``'s mock groups here, ROADMAP queue 1
item 13; there is no lowering or compile; execution counts
every op, so the JAX three-probe fit is not needed).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --multi-pod --out results/dryrun_torch

``--sweep`` runs one subprocess per cell (a cell's failure or memory
growth cannot poison the rest) and caches one JSON file per cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distribution import sharding as S
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.models import model as M
from repro_torch.roofline.analysis import RooflineReport
from repro_torch.roofline.counting import count
from repro_torch.utils.pytree import tree_paths

NOT_COUNTED = {
    "collective_bytes": "the dry run does not run the per-rank step under the mock groups yet (ROADMAP queue 1 item 13); "
                        "the bottleneck is taken over the compute and memory terms",
    "per_collective": "as collective_bytes",
    "lower_s": "no lowering: the step executes on the meta device",
    "compile_s": "no compile: the step executes on the meta device",
    "probe_model": "execution counts every op of every layer, so the three-probe fit is not needed",
}
TEMP_NOT_COUNTED = "the counted peak is global; it is a chip's only on a one-chip mesh"


def _microbatches(shape: ShapeConfig, mesh: MeshSpec, opts: dict) -> int:
    """The JAX dry run's default: two sequences a data-parallel rank a
    microbatch (``mesh.size // 16`` data ranks)."""
    return opts.get("microbatches", max(1, shape.global_batch // (max(1, mesh.size // 16) * 2)))


def _state_bytes(tree: dict, specs: dict, mesh: MeshSpec) -> dict[str, int]:
    """``{path: per-chip bytes}`` of a tensor tree under its spec tree."""
    flat_specs = tree_paths(specs)
    return {p: S.shard_bytes(x, flat_specs[p], mesh) for p, x in tree_paths(tree).items()}


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, opts: dict):
    """The cell's step, its meta inputs and their per-chip bytes:
    ``(fn, args, {leaf path: bytes}, used opts)``. Each path is prefixed
    by its input (``params/``, ``opt/``, ``batch/``, ``cache/``,
    ``cross_kv/``)."""
    from repro_torch.distribution.step import init_opt_state, make_train_step
    from repro_torch.optim import AdamWConfig

    params = M.abstract_params(cfg)
    specs = M.input_specs(cfg, shape)
    per_chip: dict[str, int] = {}
    if shape.kind == "train":
        microbatches = _microbatches(shape, mesh, opts)
        opt = init_opt_state(params)
        remat = opts.get("remat", "full")
        step = make_train_step(cfg, AdamWConfig(), microbatches, remat, grad_accum=opts.get("grad_accum", "explicit"))
        per_chip.update({f"params/{p}": n for p, n in _state_bytes(params, S.param_shardings(cfg, mesh), mesh).items()})
        per_chip.update({f"opt/{p}": n for p, n in _state_bytes(opt, S.opt_state_shardings(cfg, mesh), mesh).items()})
        batch_specs = {k: S.batch_sharding(mesh, shape.global_batch, x.dim()) for k, x in specs.items()}
        per_chip.update({f"batch/{p}": n for p, n in _state_bytes(specs, batch_specs, mesh).items()})
        return step, (params, opt, specs), per_chip, {"microbatches": microbatches, "remat": remat}
    if opts.get("served_dtype"):
        params = M.cast_params(params, opts["served_dtype"])
    if shape.kind == "prefill":
        max_seq = opts.get("max_seq", shape.seq_len)

        def prefill(params, batch):
            with torch.inference_mode():
                return M.prefill(cfg, params, batch, max_seq=max_seq)

        per_chip.update({f"params/{p}": n for p, n in _state_bytes(params, S.param_shardings(cfg, mesh), mesh).items()})
        batch_specs = {k: S.batch_sharding(mesh, shape.global_batch, x.dim()) for k, x in specs.items()}
        per_chip.update({f"batch/{p}": n for p, n in _state_bytes(specs, batch_specs, mesh).items()})
        return prefill, (params, specs), per_chip, {"max_seq": max_seq}

    serving = opts.get("serve_params", "fsdp") == "replicated"

    def decode(params, cache, tokens, pos, cross_kv=None):
        with torch.inference_mode():
            return M.decode_step(cfg, params, cache, tokens, pos, cross_kv)

    per_chip.update({f"params/{p}": n for p, n in
                     _state_bytes(params, S.param_shardings(cfg, mesh, serving=serving), mesh).items()})
    cache_specs = S.cache_shardings(cfg, mesh, shape.global_batch, shape.seq_len)
    per_chip.update({f"cache/{p}": n for p, n in _state_bytes(specs["cache"], cache_specs, mesh).items()})
    per_chip["batch/tokens"] = S.shard_bytes(specs["tokens"], S.batch_sharding(mesh, shape.global_batch), mesh)
    args = [params, specs["cache"], specs["tokens"], specs["pos"]]
    if cfg.family == "encdec":
        # replicated, as the JAX decode step shards it
        per_chip.update({f"cross_kv/{p}": x.numel() * x.element_size() for p, x in tree_paths(specs["cross_kv"]).items()})
        args.append(specs["cross_kv"])
    return decode, tuple(args), per_chip, {"serve_params": "replicated" if serving else "fsdp"}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N T for a train step, 2 N T for prefill, 2 N b for a decode step
    (N the active params), as the JAX dry run counts them."""
    n_active = M.analytic_param_count(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def dry_run(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, opts: dict | None = None,
            arch: str | None = None, shape_name: str | None = None) -> dict:
    """One cell: execute its step on meta under the counters; the JAX
    dry run's keys, filled from the port's counts."""
    opts = dict(opts or {})
    if opts.get("param_dtype"):
        cfg = dataclasses.replace(cfg, param_dtype=opts["param_dtype"])
    t_all = time.perf_counter()
    fn, args, per_chip, used = build_cell(cfg, shape, mesh, opts)
    _, counted = count(fn, *args)
    one_chip = mesh.size == 1
    report = RooflineReport(
        arch=arch or cfg.name, shape=shape_name or shape.name, mesh=mesh.describe(), chips=mesh.size,
        hlo_flops=float(counted.flops), hlo_bytes=float(counted.bytes), collective_bytes=None,
        per_collective=None, model_flops=model_flops(cfg, shape),
    )
    not_counted = dict(NOT_COUNTED)
    if not one_chip:
        not_counted["temp_size_in_bytes"] = TEMP_NOT_COUNTED
    return {
        "arch": arch or cfg.name,
        "shape": shape_name or shape.name,
        "mesh": mesh.describe(),
        "status": "ok",
        "chips": mesh.size,
        "params_total": M.analytic_param_count(cfg),
        "params_active": M.analytic_param_count(cfg, active_only=True),
        "lower_s": None,
        "compile_s": None,
        "total_s": time.perf_counter() - t_all,
        "memory_analysis": {
            "argument_size_in_bytes": sum(per_chip.values()),
            "temp_size_in_bytes": counted.peak_bytes if one_chip else None,
        },
        "probe_model": None,
        "opts": {**opts, **used},
        **report.to_dict(),
        "not_counted": not_counted,
        "counts": counted.to_dict(),
    }


def _run_cell(arch: str, shape_name: str, multi_pod: bool, opts: dict | None = None) -> dict:
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh.describe(), "status": "skipped", "reason": reason}
    return dry_run(cfg, SHAPES[shape_name], mesh, opts, arch=arch, shape_name=shape_name)


def _result_path(out_dir: str, arch: str, shape: str, mesh_desc: str, tag: str = "") -> str:
    suffix = f"_{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}_{shape}_{mesh_desc}{suffix}.json")


def sweep(out_dir: str, multi_pod: bool, archs=None, shapes=None, force=False) -> None:
    os.makedirs(out_dir, exist_ok=True)
    archs = archs or list(ASSIGNED)
    shapes = shapes or list(SHAPES)
    mesh_desc = make_production_mesh(multi_pod=multi_pod).describe()
    todo = [(a, s, _result_path(out_dir, a, s, mesh_desc)) for a in archs for s in shapes]
    todo = [(a, s, p) for a, s, p in todo if force or not os.path.exists(p)]
    print(f"[sweep] {len(todo)} cells to run ({mesh_desc})", flush=True)
    for i, (a, s, p) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s, "--out", out_dir]
        if multi_pod:
            cmd.append("--multi-pod")
        print(f"[sweep {i + 1}/{len(todo)}] {a} x {s} ({mesh_desc})", flush=True)
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True)
        dt = time.time() - t0
        if r.returncode != 0:
            err = {"arch": a, "shape": s, "mesh": mesh_desc, "status": "error", "stderr": r.stderr[-4000:],
                   "seconds": dt}
            with open(p, "w") as f:
                json.dump(err, f, indent=2)
            print(f"  ERROR after {dt:.0f}s: {r.stderr.splitlines()[-1] if r.stderr else '?'}", flush=True)
        else:
            print(f"  done in {dt:.0f}s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opts", default="{}", help="JSON dict: microbatches/remat/grad_accum/serve_params/"
                                                 "param_dtype/served_dtype/max_seq")
    args = ap.parse_args()

    if args.sweep:
        sweep(args.out, args.multi_pod, archs=[args.arch] if args.arch else None,
              shapes=[args.shape] if args.shape else None, force=args.force)
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --sweep)")
    mesh_desc = make_production_mesh(multi_pod=args.multi_pod).describe()
    try:
        res = _run_cell(args.arch, args.shape, args.multi_pod, opts=json.loads(args.opts))
    except Exception:
        res = {"arch": args.arch, "shape": args.shape, "mesh": mesh_desc, "status": "error",
               "stderr": traceback.format_exc()[-4000:]}
    res["cuda_initialized"] = torch.cuda.is_initialized()
    os.makedirs(args.out, exist_ok=True)
    with open(_result_path(args.out, args.arch, args.shape, mesh_desc, args.tag), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({k: v for k, v in res.items() if k not in ("counts",)}, indent=2))
    if res["status"] == "error" or res["cuda_initialized"]:
        print(res.get("stderr", "the dry run initialised CUDA"), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
