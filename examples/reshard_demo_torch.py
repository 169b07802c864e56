"""Intersection-planner walkthrough on the PyTorch port: the transfer plan
for the paper's Fig. 5 scenario (TP=4 -> TP=8) and for a mixed 3D
reshape, each executed through the port's live streaming path (the shared
reshard engine and ``LiveExecutor``: the row kernels on the card, their
plain versions on the CPU) and checked bit-exact.

    PYTHONPATH=src python examples/reshard_demo_torch.py
    PYTHONPATH=src python examples/reshard_demo_torch.py --device cpu

The torch version of ``examples/reshard_demo.py``: the plan lines it
prints are that example's. Every rank of both worlds sits on the one
device (a world's state is its global tensors there), so the executor
moves the plan's cells between the two worlds' tensors on that device. A
CUDA request without a card raises.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core.intersection import plan_transfer, verify_completeness  # noqa: E402
from repro_torch.core.reshard import live_reshard_planned  # noqa: E402
from repro_torch.core.resource_view import TensorSpec, build_tensor_specs  # noqa: E402
from repro_torch.kernels import reshard_pack as rp  # noqa: E402
from repro_torch.models.model import resolve_device  # noqa: E402
from repro_torch.models.transformer import block_program  # noqa: E402

BUDGET = 256 * 1024  # staging bytes


def execute(specs, plan, ca, cb, device, seed: int) -> None:
    """Run ``plan`` on random global tensors through the live path and
    check every destination tensor bit-exact against its source."""
    rng = np.random.default_rng(seed)
    state = {s.name: torch.from_numpy(rng.normal(size=s.shape).astype(s.dtype)).to(device) for s in specs}
    launches = sum(rp.launches.values())
    dst, stats = live_reshard_planned(specs, plan, state, [device] * ca.world_size, [device] * cb.world_size,
                                      staging_bytes=BUDGET)
    for name, x in state.items():
        if not torch.equal(dst[name], x):
            sys.exit(f"{name}: the destination differs from the source")
    print(f"  executed ({device.type}): {stats.layers_streamed} layer barriers, "
          f"{stats.executed_bytes:,} B moved, peak staging {stats.peak_staging_bytes:,} B <= budget {BUDGET:,} B, "
          f"{sum(rp.launches.values()) - launches} row-kernel launches, bit-exact")
    if stats.peak_staging_bytes > BUDGET:
        sys.exit("the staging buffer outgrew its budget")


def fig5_tp4_to_tp8(device) -> None:
    print("=== paper Fig. 5: weight W[:, :] under TP=4 -> TP=8 ===")
    spec = TensorSpec("params/w", (8, 64), "float32", ("none", "tp"), "stages", "params")
    ca, cb = ParallelConfig(tp=4), ParallelConfig(tp=8)
    plan = plan_transfer([spec], ca, cb)
    for t in sorted(plan.tasks, key=lambda t: t.dst_rank):
        cols = t.bounds[1]
        print(f"  src rank {t.src_rank} -> dst rank {t.dst_rank}: "
              f"cols [{cols[0]:2d},{cols[1]:2d})  ({t.nbytes} B)")
    print(f"  total: {len(plan.tasks)} tasks, {plan.network_bytes} network bytes, "
          f"no full-tensor materialization\n")
    execute([spec], plan, ca, cb, device, seed=1)


def mixed_3d_reshape(device) -> None:
    print("=== mixed 3D reshape of a real model's state "
          "(qwen3 reduced, params+optimizer) ===")
    cfg = get_config("qwen3-1.7b").reduced()
    specs = build_tensor_specs(cfg, include_optimizer=True)
    ca, cb = ParallelConfig(dp=2, pp=2, tp=2), ParallelConfig(dp=1, pp=1, tp=4)
    plan = plan_transfer(specs, ca, cb, num_positions=len(block_program(cfg)))
    verify_completeness(specs, plan, cb)
    tx, rx = plan.per_rank_bytes()
    print(f"  {ca.describe()} ({ca.world_size} ranks) -> "
          f"{cb.describe()} ({cb.world_size} ranks)")
    print(f"  tensors: {len(specs)}, tasks: {len(plan.tasks)}, "
          f"layers streamed: {len(plan.layers())}")
    print(f"  network bytes: {plan.network_bytes:,}  "
          f"zero-copy (local) bytes: {plan.local_bytes:,}")
    print(f"  per-dst-rank receive bytes: { {k: f'{v:,}' for k, v in sorted(rx.items())} }")
    execute(specs, plan, ca, cb, device, seed=0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    fig5_tp4_to_tp8(device)
    mixed_3d_reshape(device)


if __name__ == "__main__":
    main()
