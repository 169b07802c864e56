"""Fault-injection harness for peer recovery (DESIGN.md §15). A copy of
the JAX package's ``elastic/faults.py``.

Recovery that only works between steps is not recovery. This module kills
device subsets at each phase of the controller's reconfiguration lifecycle
— at an idle iteration boundary, mid-stream (an overlap session with
layers still to pre-copy), and mid-commit (the split-step switch armed for
the next step) — and drives ``fail_stop_recover`` from exactly that state,
so the tests and ``chip_smoke.py`` can prove the recovery path holds
everywhere, not just in the easy case.

The cluster here is emulated (every rank of a world on one device), so
"killing" rank r means:
every byte r exclusively held must be reconstructable without reading it.
The harness enforces that structurally rather than by trusting the
transfer: it asserts the executed plan's remote tasks never name a dead
rank as source (the survivor-constrained planner guarantees this by
construction; the assertion catches regressions in that construction).

On a per-rank world (``core/rank_controller.py``, one process a rank) the
lost ranks' processes stay up (gloo cannot lose a member without a new
rendezvous), but their state goes: ``kill`` fails them with
``devices_failed=True``, and before the recovery begins each lost rank
poisons every shard, moment, carry, destination buffer and parity word it
holds (every byte set to 0xFF, a NaN in a float) and frees it
(``RankController.fail_stop_recover`` -> ``lose_state``), so a read of a
dead byte shows in the result. A lost rank inside the target world comes back as a replacement
that holds nothing and receives its shards from the donors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.errors import RecoveryError
from repro_torch.core.reshard import plan_state_transfer
from repro_torch.elastic.redundancy import survivors_for

__all__ = ["PHASES", "FaultInjector", "InjectionReport", "controller_phase"]

# lifecycle phases a fault can land in, orthogonal to the recovery scheme
PHASES = ("idle", "mid_stream", "mid_commit")


def controller_phase(ctrl) -> str:
    """Classify the controller's reconfiguration phase at a step boundary.

    ``mid_commit``: the split-step switch is armed — the NEXT train step
    would commit the generation. ``mid_stream``: an overlap session is
    live with pre-copy layers outstanding. ``idle``: neither (a shadow
    may still be building; its loss is covered by the idle case since no
    state has moved yet).
    """
    if getattr(ctrl, "_commit_armed", False):
        return "mid_commit"
    session = getattr(ctrl, "_session", None)
    if session is not None and not session.done_precopy:
        return "mid_stream"
    return "idle"


@dataclass
class InjectionReport:
    phase: str  # phase the fault actually landed in
    lost_ranks: tuple[int, ...]
    step_before: int
    step_after: int
    mode: str  # peer_recover | fallback
    outcome: str  # committed | fell_back
    donors: int
    parity_bytes: int
    pause_s: float
    demoted: bool  # True when the checkpoint rung had to serve


@dataclass
class FaultInjector:
    """Drive a controller to a lifecycle phase, then kill devices there.

    ``ctrl`` is a live :class:`~repro_torch.core.controller.LiveRController`;
    the injector owns the stepping loop so the fault lands between a step
    and its boundary poll — the same cut an external failure detector
    would observe.
    """

    ctrl: object
    reports: list[InjectionReport] = field(default_factory=list)

    def run_until(self, phase: str, max_steps: int = 64) -> bool:
        """Train one step at a time until the controller sits in ``phase``.

        Reaching ``mid_stream``/``mid_commit`` requires the caller to have
        started a resize (``begin_resize``) first; returns False when the
        phase never shows up within ``max_steps`` (e.g. the stream
        finished too fast — retry with a smaller ``stream_k``).
        """
        assert phase in PHASES, phase
        for _ in range(max_steps):
            if controller_phase(self.ctrl) == phase:
                return True
            self.ctrl.train_steps(1)
        return controller_phase(self.ctrl) == phase

    def kill(
        self,
        target: ParallelConfig,
        lost_ranks: tuple[int, ...] = (),
        expect_phase: Optional[str] = None,
    ) -> InjectionReport:
        """Fail-stop the ``lost_ranks`` device subset right now.

        Asserts the survivor-constrained recovery plan never sources a
        dead rank, then runs the controller's recovery from whatever
        lifecycle state it is in. Raises :class:`RecoveryError` through
        unchanged when no rung can serve.
        """
        phase = controller_phase(self.ctrl)
        if expect_phase is not None:
            assert phase == expect_phase, (
                f"fault landed in phase {phase!r}, wanted {expect_phase!r}"
            )
        src = self.ctrl.world.parallel
        survivors = survivors_for(
            src, lost_ranks, target=target, devices_failed=True
        )
        dead = frozenset(range(src.world_size)) - survivors
        _, plan = plan_state_transfer(
            self.ctrl.cfg, src, target,
            source_policy=self.ctrl.source_policy, allowed_src=survivors,
        )
        leaks = [t for t in plan.tasks if t.kind != "lost" and t.src_rank in dead]
        assert not leaks, (
            f"survivor-constrained plan reads dead ranks: "
            f"{[(t.tensor, t.src_rank) for t in leaks[:5]]}"
        )

        step_before = self.ctrl.step
        rec = self.ctrl.fail_stop_recover(
            target, devices_failed=True, lost_ranks=tuple(lost_ranks)
        )
        report = InjectionReport(
            phase=phase,
            lost_ranks=tuple(sorted(dead)),
            step_before=step_before,
            step_after=self.ctrl.step,
            mode=rec.mode,
            outcome=rec.outcome,
            donors=getattr(rec, "donors", 0),
            parity_bytes=getattr(rec, "parity_bytes", 0),
            pause_s=rec.total_pause_s,
            demoted=rec.mode != "peer_recover",
        )
        self.reports.append(report)
        return report

    def inject(
        self,
        phase: str,
        target: ParallelConfig,
        lost_ranks: tuple[int, ...] = (),
        resize_target: Optional[ParallelConfig] = None,
        max_steps: int = 64,
    ) -> InjectionReport:
        """Reach ``phase`` (starting a resize toward ``resize_target`` when
        one is needed to create stream/commit activity), then kill."""
        if phase in ("mid_stream", "mid_commit") and resize_target is not None:
            if not getattr(self.ctrl, "reconfig_pending", False):
                self.ctrl.request_resize(resize_target, overlap="stream")
            # deterministic phase entry: the shadow build is asynchronous,
            # so without this wait the stepping loop below races the cold
            # compile and may never observe the streaming window
            self.ctrl.wait_shadow_ready()
        if not self.run_until(phase, max_steps=max_steps):
            raise RecoveryError(
                f"could not drive the controller into phase {phase!r} "
                f"within {max_steps} steps"
            )
        return self.kill(target, lost_ranks, expect_phase=phase)
