"""Target-topology search (the paper's §2.3(D) integration point).

LiveR solves the *execution* problem — transitioning between parallelism
configurations without stopping — and explicitly defers the *search* problem
("which configuration to choose") to an external system: "A natural
integration would have the search system determine the target (TP', PP',
DP') and LiveR execute the live transition."

This module is that search system: given a device count and a model config,
it enumerates feasible ``ParallelConfig``s (divisibility + per-chip memory)
and ranks them with a roofline-flavored step-time model (compute + the
structural TP/DP collective terms), optionally weighing the *transition
cost* from the current config (bytes moved under the intersection plan) so
frequent small resizes prefer nearby layouts — a liveness-aware refinement
the paper's discussion motivates.

A copy of the JAX package's ``core/topology_search.py``; its roofline model
reads the H100's constants from ``launch/mesh.py`` where the JAX package
reads a TPU v5e's, and its ``ICI_BW`` term is NVLink's rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, ICI_BW, PEAK_FLOPS_BF16


@dataclass(frozen=True)
class Candidate:
    parallel: ParallelConfig
    step_time_s: float
    mem_per_chip: float
    transition_bytes: int = 0
    score: float = 0.0


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def feasible_configs(
    cfg: ModelConfig,
    world: int,
    global_batch: int,
    max_pp: int = 8,
) -> list[ParallelConfig]:
    """All (dp, pp, tp) with dp·pp·tp == world respecting divisibility:
    dp | global_batch, pp | n_periods, tp bounded by head/ffn divisibility."""
    from repro_torch.models.transformer import n_periods

    np_ = n_periods(cfg)
    out = []
    for tp in _divisors(world):
        if cfg.d_ff and cfg.d_ff % tp != 0 and (cfg.num_heads * cfg.resolved_head_dim) % tp != 0:
            continue
        rest = world // tp
        for pp in _divisors(rest):
            if pp > max_pp or np_ % pp != 0:
                continue
            dp = rest // pp
            if global_batch % dp != 0:
                continue
            out.append(ParallelConfig(dp=dp, pp=pp, tp=tp))
    return out


def estimate_step_time(
    cfg: ModelConfig,
    parallel: ParallelConfig,
    global_batch: int,
    seq_len: int,
) -> tuple[float, float]:
    """(step seconds, param+opt bytes per chip) — napkin roofline model.

    compute: 6·N_active·D/(world·peak) with a pipeline-bubble factor;
    collective: Megatron-TP's ~4 activation collectives per layer over ICI +
    the DP gradient reduce.
    """
    from repro_torch.models.model import analytic_param_count

    n_active = analytic_param_count(cfg, active_only=True)
    n_total = analytic_param_count(cfg)
    world = parallel.world_size
    tokens = global_batch * seq_len

    compute = 6.0 * n_active * tokens / (world * PEAK_FLOPS_BF16)
    # pipeline bubble (GPipe-ish): (pp-1)/(m + pp - 1), m = microbatches
    m = max(global_batch // parallel.dp, 1)
    bubble = (parallel.pp - 1) / (m + parallel.pp - 1)
    compute /= max(1e-9, 1.0 - bubble)

    # TP activation collectives: ~4 per layer, bytes = tokens/dp·d·2B, only
    # when tp > 1; DP gradient reduce-scatter+all-gather: 2·params·2B/world
    coll = 0.0
    if parallel.tp > 1:
        coll += 4 * cfg.num_layers * (tokens / max(parallel.dp, 1)) * cfg.d_model * 2 / ICI_BW / max(parallel.dp * parallel.pp, 1)
    if parallel.dp > 1:
        coll += 2 * n_total * 2 / (world * ICI_BW)

    # memory per chip: bf16 params + fp32 moments sharded over (tp·pp[·dp zeRO])
    state = n_total * (2 + 8) / (parallel.tp * parallel.pp * parallel.dp)
    act = (tokens / max(parallel.dp, 1) / m) * cfg.d_model * 2 * 4  # rough
    mem = state + act
    return compute + coll, mem


def search(
    cfg: ModelConfig,
    world: int,
    global_batch: int,
    seq_len: int,
    current: ParallelConfig | None = None,
    transition_weight: float = 0.0,
    hbm_bytes: float = HBM_BYTES,
    max_pp: int = 8,
) -> list[Candidate]:
    """Ranked feasible candidates (best first).

    transition_weight converts transition bytes (from the intersection
    planner, when ``current`` is given) into equivalent step-seconds so the
    search trades steady-state speed against reconfiguration cost.
    """
    from repro_torch.core.intersection import plan_transfer
    from repro_torch.core.resource_view import build_tensor_specs

    cands = []
    specs = build_tensor_specs(cfg) if (current and transition_weight) else None
    for par in feasible_configs(cfg, world, global_batch, max_pp=max_pp):
        t, mem = estimate_step_time(cfg, par, global_batch, seq_len)
        if mem > hbm_bytes:
            continue
        tb = 0
        if specs is not None and par != current:
            tb = plan_transfer(
                specs, current, par, layer_granular=False
            ).network_bytes
        score = t + transition_weight * tb
        cands.append(Candidate(par, t, mem, tb, score))
    return sorted(cands, key=lambda c: c.score)


def likely_next_targets(
    cfg: ModelConfig,
    current: ParallelConfig,
    max_world: int,
    global_batch: int,
    seq_len: int,
    k: int = 2,
    factors: tuple[float, ...] = (0.5, 2.0),
    max_pp: int = 8,
    transition_weight: float = 0.0,
) -> list[ParallelConfig]:
    """The warm pool's prefetch candidates (DESIGN.md §12).

    Elasticity events overwhelmingly halve or double capacity (spot
    reclaim takes a node group; walk-up returns it), so the likely next
    device counts are the walk-down/walk-up neighbors of the current
    world. For each neighbor count this returns the search's ranked
    feasible configurations, merged round-robin across counts (best of
    each neighbor first), deduplicated, excluding the current config,
    capped at ``k`` — the top-k targets a speculative
    ``prefetch_world`` should build while the controller is idle.
    """
    ranked: list[list[ParallelConfig]] = []
    seen_counts = {current.world_size}
    for f in factors:
        world = max(1, min(max_world, int(round(current.world_size * f))))
        if world in seen_counts:
            continue
        seen_counts.add(world)
        cands = search(
            cfg, world, global_batch, seq_len, current=current,
            transition_weight=transition_weight, max_pp=max_pp,
        )
        ranked.append([c.parallel for c in cands if c.parallel != current])
    out: list[ParallelConfig] = []
    depth = 0
    while len(out) < k and any(depth < len(r) for r in ranked):
        for r in ranked:
            if depth < len(r) and r[depth] not in out:
                out.append(r[depth])
                if len(out) >= k:
                    break
        depth += 1
    return out[:k]


def failover_target(
    cfg: ModelConfig,
    current: ParallelConfig,
    global_batch: int,
    max_pp: int = 8,
) -> Optional[ParallelConfig]:
    """The prefix-survivor standby: the world an unannounced fail-stop
    would recover into (DESIGN.md §15).

    Under prefix device allocation a failure takes the tail ranks, and
    the cheapest covered recovery target drops whole replica groups:
    one DP replica when ``dp > 1`` (survivors hold every shard locally),
    else half the tp (parity repairs the lost tp group), else half the
    pp. Keeping this one world warm in the pool bounds the fail-stop
    pause to the transfer itself — never a cold Prepare.
    """
    dp, pp, tp = current.dp, current.pp, current.tp
    candidates: list[ParallelConfig] = []
    if dp > 1:
        # largest feasible dp' < dp, same (pp, tp): one-replica-down
        # first, halving as the divisibility fallback
        for d in range(dp - 1, 0, -1):
            if global_batch % d == 0:
                candidates.append(ParallelConfig(dp=d, pp=pp, tp=tp))
                break
    elif tp > 1:
        candidates.append(ParallelConfig(dp=1, pp=pp, tp=tp // 2))
    elif pp > 1:
        candidates.append(ParallelConfig(dp=1, pp=pp // 2, tp=1))
    for cand in candidates:
        if cand in feasible_configs(
            cfg, cand.world_size, global_batch, max_pp=max_pp
        ):
            return cand
    return None


def best_target(
    cfg: ModelConfig,
    world: int,
    global_batch: int,
    seq_len: int,
    current: ParallelConfig | None = None,
    transition_weight: float = 0.0,
    max_pp: int = 8,
) -> ParallelConfig:
    cands = search(
        cfg, world, global_batch, seq_len, current, transition_weight,
        max_pp=max_pp,
    )
    if not cands:
        raise ValueError(
            f"no feasible topology for {cfg.name} at world={world} "
            f"(batch {global_batch})"
        )
    return cands[0].parallel
