"""Volatility trace generation (paper §6.4 regimes, §6.5 24-h trace).

Deterministic (seeded) so benchmark outputs are reproducible.

A copy of the JAX package's ``sim/volatility.py``.
"""

from __future__ import annotations

import numpy as np

REGIMES = {
    "low": 60 * 60.0,  # ~hourly events
    "medium": 30 * 60.0,
    "high": 10 * 60.0,
}


def make_trace(
    duration_s: float,
    mean_interval_s: float,
    world_choices: tuple[int, ...] = (16, 24, 32),
    seed: int = 0,
) -> list[tuple[float, int]]:
    """Poisson-ish arrival of resize events with jittered intervals."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out: list[tuple[float, int]] = []
    world = world_choices[-1]
    while True:
        t += rng.uniform(0.5, 1.5) * mean_interval_s
        if t >= duration_s:
            break
        choices = [w for w in world_choices if w != world]
        world = int(rng.choice(choices))
        out.append((t, world))
    return out


def spot_trace(
    duration_s: float,
    mean_interval_s: float,
    world_choices: tuple[int, ...] = (16, 24, 32),
    seed: int = 0,
    warning_s: float = 120.0,
    failstop_every: int = 5,
    emit_lost: bool = False,
) -> list[tuple]:
    """Spot-market style event stream for the live scheduler (paper §4.1).

    Like :func:`make_trace` but each row carries an event kind and warning
    window: resizes arrive with the spot notice (AWS's 2-minute default);
    every ``failstop_every``-th event is an unannounced fail-stop dropping
    to the smallest pool (warning 0). Rows are ``(t, world, kind,
    warning_s)`` — ``elastic.events_from_trace`` turns them into typed
    events with concrete topologies. With ``emit_lost=True`` fail-stop rows
    grow a fifth element naming the dead ranks (a seeded draw from the
    pre-failure world's upper ranks) so fault-injection replays get a
    deterministic peer-recovery donor geometry; resize rows keep the
    4-tuple shape either way.
    """
    rng = np.random.default_rng(seed)
    t = 0.0
    out: list[tuple] = []
    world = world_choices[-1]
    n = 0
    while True:
        t += rng.uniform(0.5, 1.5) * mean_interval_s
        if t >= duration_s:
            break
        n += 1
        if failstop_every and n % failstop_every == 0:
            prev = world
            world = min(world_choices)
            pool = list(range(world, prev))
            if emit_lost and pool:
                # prefix allocation: survivors are ranks 0..world-1, so the
                # dead set is drawn from the complement [world, prev)
                k = int(rng.integers(1, len(pool) + 1))
                lost = tuple(
                    sorted(int(r) for r in rng.choice(pool, size=k, replace=False))
                )
                out.append((t, world, "fail_stop", 0.0, lost))
            else:
                out.append((t, world, "fail_stop", 0.0))
        else:
            choices = [w for w in world_choices if w != world]
            world = int(rng.choice(choices))
            out.append((t, world, "resize", warning_s))
    return out


def paper_24h_trace(seed: int = 1) -> list[tuple[float, int]]:
    """~47 events over 24 h (paper Fig. 8: GPT-14B, 32 GPUs, 47 reconfigs)."""
    duration = 24 * 3600.0
    trace = make_trace(duration, duration / 48.0, seed=seed)
    return trace[:47]
