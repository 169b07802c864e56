"""Cluster hardware models for the reconfiguration simulator.

Two calibrations ship:
  * PAPER_TESTBED — the paper's 4×A800 (32 GPU) cluster, constants fitted to
    the paper's own measurements (Table 1 breakdown, §2.2.1's "~60 s init for
    32 GPUs/14B", §6.3's 2–4 s transfer for 28 GB) so the simulator can be
    validated against every published figure;
  * TPU_V5E_POD — the JAX package's deployment target, constants from the
    v5e datasheet + compile/restart timings measured by the JAX package's
    sim/calibrate.py, scaled per DESIGN.md.

A copy of the JAX package's ``sim/cluster.py``: both calibrations are the
reference's, copied as they are. Neither is a measurement of the H100 the
port runs on (no H100 preset yet: ROADMAP queue 1 item 12).

Distributed-init scaling follows the paper's observation that communicator
construction grows with world size (NCCL tree setup ~log + per-rank
handshakes ~linear).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ClusterModel:
    name: str
    gpus_per_node: int
    # training
    step_time_s_per_1e9_params: float  # iteration time scale (measured)
    # restart path
    storage_bw_gbps_per_gpu: float  # checkpoint read bandwidth per GPU
    proc_spawn_s: float  # process relaunch + framework import
    cuda_init_s: float  # CUDA context + cuDNN/JIT warmup per restart
    nccl_base_s: float  # communicator setup base
    nccl_per_rank_s: float  # per-rank handshake cost
    nccl_log_s: float  # topology-discovery log term
    misc_s: float  # setup/sync residue (paper Table 1: 2.4 s)
    # live path
    interconnect_gbps_per_gpu: float  # P2P streaming bandwidth per GPU
    drain_s: float  # in-flight drain at iteration boundary
    switch_s: float  # atomic metadata swap
    plan_s: float  # CPU transfer planning
    steady_overhead: float  # fractional iteration slowdown during prepare
    # shadow prepare (overlapped; relevant vs warning window)
    prepare_base_s: float
    prepare_per_rank_s: float

    def dist_init_s(self, world: int) -> float:
        return (
            self.nccl_base_s
            + self.nccl_per_rank_s * world
            + self.nccl_log_s * math.log2(max(world, 2))
        )

    def ckpt_load_s(self, model_bytes: float, world: int) -> float:
        bw = self.storage_bw_gbps_per_gpu * 1e9 / 8 * world
        return model_bytes / bw

    def transfer_s(self, moved_bytes: float, world: int) -> float:
        bw = self.interconnect_gbps_per_gpu * 1e9 / 8 * world
        return moved_bytes / bw

    def prepare_s(self, world: int) -> float:
        return self.prepare_base_s + self.prepare_per_rank_s * world

    def step_time_s(self, params: float, world: int, ref_world: int = 32) -> float:
        # fixed global batch: time ∝ params / world (weak efficiency factor)
        eff = (ref_world / world) ** 0.05 if world else 1.0
        return self.step_time_s_per_1e9_params * (params / 1e9) * (ref_world / max(world, 1)) * eff


# --- paper testbed: constants solved against the paper's measurements -----
# Table 1 (GPT-20B, 32 GPUs): ckpt load 54.6 s, dist init+warmup 70.1 s,
# misc 2.4 s. §2.2.1: 14B/32 GPUs init ≈ 60 s. §6.3: 28 GB transfer ≈ 2 s,
# switch < 0.5 s, steady-state overhead 0.28 %. Model state ≈ 2 bytes/param
# (bf16) × (1 + optimizer partition share) ≈ paper's "~28 GB for 14B".
PAPER_TESTBED = ClusterModel(
    name="a800x32",
    gpus_per_node=8,
    step_time_s_per_1e9_params=0.55,
    # restart reloads the FULL distributed state (fp16 params + fp32 master
    # + Adam moments ≈ 10 B/param, see model_state_bytes(with_optimizer));
    # 0.915 Gb/s/GPU reproduces Table 1's 54.6 s for GPT-20B on 32 GPUs.
    storage_bw_gbps_per_gpu=0.915,
    proc_spawn_s=8.0,
    cuda_init_s=12.0,
    nccl_base_s=20.0,
    nccl_per_rank_s=0.55,
    nccl_log_s=2.5,
    misc_s=2.4,   # Table 1 misc
    # LiveR streams bf16 params P2P: 28 GB in ~2 s for 14B (paper §6.3)
    interconnect_gbps_per_gpu=4.7,
    drain_s=4.0,   # finish iteration N + drain in-flight work (~1 iter)
    switch_s=0.4,  # sub-second metadata swap (Fig. 6c)
    plan_s=0.6,
    steady_overhead=0.0028,  # §6.3: 0.28 % iteration-time delta
    prepare_base_s=25.0,
    prepare_per_rank_s=0.9,
)

# --- TPU v5e pod target (per-chip ICI ~50 GB/s, compile measured locally) --
TPU_V5E_POD = ClusterModel(
    name="tpu-v5e-pod",
    gpus_per_node=4,
    step_time_s_per_1e9_params=0.12,
    storage_bw_gbps_per_gpu=4.0,
    proc_spawn_s=3.0,
    cuda_init_s=0.0,  # no CUDA; runtime init folded into compile
    nccl_base_s=15.0,  # XLA compile+load base (measured scaling locally)
    nccl_per_rank_s=0.08,
    nccl_log_s=6.0,
    misc_s=1.5,
    interconnect_gbps_per_gpu=400.0,  # 50 GB/s ICI per chip
    drain_s=0.2,
    switch_s=0.05,
    plan_s=0.4,
    steady_overhead=0.003,
    prepare_base_s=20.0,
    prepare_per_rank_s=0.05,
)


def model_state_bytes(params: float, with_optimizer: bool = False) -> float:
    """bf16 params; with_optimizer adds fp32 master + Adam moments
    (mixed-precision training state ≈ 10 B/param, what a restart reloads)."""
    per = 2.0 + (8.0 if with_optimizer else 0.0)
    return params * per
