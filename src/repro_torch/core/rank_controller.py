"""The LiveR training controller on per-rank worlds (SPMD).

Every process of the rank pool (``distribution/groups.py::RankPool``, the
processes ``launch/ranks.py`` spawns) runs a :class:`RankController` with
the same arguments and calls the same verbs at the same steps. A world is a
dp x pp x ep x tp ``ParallelConfig`` whose rank ``r`` is process ``r``: it
holds its shards of every param, ``mu`` and ``nu`` leaf it has a part of
(``core/resource_view.py::shard_of``: its stage's periods, its experts,
its tp columns; the embedding on stage 0, the final norm and the head on
the last), trains on its dp rows through the per-rank step
(``distribution/step.py``, or ``distribution/pipeline.py``'s stages;
collectives over the world's ``RankGroups``), and a resize streams cells
rank to rank through the ``RankExecutor`` (``reshard/executors.py``), to
and from ranks that hold no part of a leaf as well. Processes outside the
active world idle through its steps and take part in the boundaries and
the transfers.

The lifecycle is ``LiveRController``'s, through its per-rank hooks
(``_agree_ready``, ``_named_state``, ``_session_executor``, ``_reshard``,
``_install``, and ``_initial_state`` / ``_dst_buffers`` at start and in
Prepare): Prepare on the shadow thread
(``core/shadow.py::build_rank_world``: the rank's functions, its step run
once on meta under the mock process groups, the plan, this rank's
destination shards), then stop-copy or overlapped streaming with a
split-step commit. What each process decides on its own host is agreed
before it issues a collective: at each step boundary with a resize in
flight the ranks all-reduce (MIN) their shadow's readiness over the pool,
so every rank marks the world ready, starts a round and arms the commit at
the same step; the rounds themselves are fixed by the plan and
``stream_k``, the same on every rank. Otherwise ranks would post
mismatched messages and hang.

Every world's groups are created at start, on every process in one order
(``worlds=``); a resize to a world not named there raises. The step count
of a process joining a world is the pool's agreed (MAX) count.
``gathered_params`` assembles the params on rank 0 (None elsewhere).

Not on per-rank worlds yet (they raise): the warm pool and prefetch,
retarget and escalation, fail-stop recovery and checkpoints, the transfer
prewarms, ``compression="int8_ef"``.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.controller import LiveRController
from repro_torch.core.intersection import TransferPlan
from repro_torch.core.reshard import DEFAULT_STAGING_BYTES, named_state_leaves, rank_reshard_planned
from repro_torch.core.resource_view import assemble, build_tensor_specs, view_of
from repro_torch.core.shadow import WorldHandle, build_rank_world, rank_state_buffers, world_microbatches
from repro_torch.data import SyntheticLM
from repro_torch.distribution.groups import RankPool, make_world_groups
from repro_torch.distribution.step import check_rank_model, init_opt_state, shard_params
from repro_torch.optim import AdamWConfig
from repro_torch.reshard.executors import RankExecutor, wire_rounded
from repro_torch.utils.pytree import tree_from_paths, tree_map_with_path

__all__ = ["RankCommit", "RankController", "gather_each"]


def gather_each(pool: RankPool, named: dict[str, torch.Tensor], parallel: ParallelConfig, specs, device):
    """Yield ``(spec, whole tensor)`` for each spec in turn: the shards of
    ``parallel``'s dp-0 ranks that hold a part of it (``named``, this
    rank's, by tensor name) assembled on rank 0's ``device``, ``None`` on
    the other ranks. One tensor is whole at a time; every rank of the pool
    iterates it."""
    dp0 = [r for r in range(parallel.world_size) if parallel.rank_coords(r)[0] == 0]
    for spec in specs:
        holders = [r for r in dp0 if view_of(spec, parallel, r) is not None]
        if pool.rank == 0:
            shards, recvs = {}, []
            for r in holders:
                if r == 0:
                    shards[0] = named[spec.name].to(device)
                else:
                    shards[r] = torch.empty(view_of(spec, parallel, r).shape(), dtype=getattr(torch, spec.dtype),
                                            device=device)
                    recvs.append((r, shards[r]))
            pool.exchange([], recvs)
            yield spec, assemble(shards, spec, parallel)
        else:
            if pool.rank in holders:
                pool.exchange([(0, named[spec.name])], [])
            yield spec, None


@dataclass
class RankCommit:
    """One commit's per-rank figures, beside the shared ``ReconfigRecord``:
    what this rank put in and took out of its destination shards, and what
    the host staging carried for it (gloo on a card)."""

    gen_id: int
    executed_bytes: int = 0
    sent_bytes: dict = field(default_factory=dict)  # by destination rank, the plan's logical bytes
    recv_bytes: dict = field(default_factory=dict)  # by source rank
    host_bytes: int = 0  # through pinned host buffers during the commit
    host_seconds: float = 0.0


class RankController(LiveRController):
    """``LiveRController`` for process ``pool.rank`` of a per-rank world
    (the module docstring). ``worlds``: every ``ParallelConfig`` a resize
    may target. ``microbatches``: every world's, as
    ``core/shadow.py::world_microbatches`` gives them (a pipeline world at
    least its pp; any other at most its rows a rank, which they divide)."""

    def __init__(
        self,
        cfg: ModelConfig,
        parallel: ParallelConfig,
        opt_cfg: AdamWConfig,
        seq_len: int,
        global_batch: int,
        pool: RankPool,
        worlds=(),
        data: Optional[SyntheticLM] = None,
        staging_bytes: int = DEFAULT_STAGING_BYTES,
        device="cuda",
        microbatches: int = 1,
        seed: int = 0,
        overlap: str = "stop_copy",
        stream_k: int = 4,
        source_policy: str = "nearest",
        wire_policy=None,
        params: Optional[dict] = None,
    ):
        for p in (parallel, *worlds):
            check_rank_model(cfg, p)
            world_microbatches(p, microbatches, global_batch)
        self.pool = pool
        self.rank = pool.rank
        self.groups = make_world_groups(pool, [parallel, *worlds])
        self._specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
        self.rank_commits: list[RankCommit] = []
        self._commit_execs: list[RankExecutor] = []
        super().__init__(
            cfg, parallel, opt_cfg, seq_len, global_batch, data=data, staging_bytes=staging_bytes, device=device,
            microbatches=microbatches, seed=seed, overlap=overlap, stream_k=stream_k, source_policy=source_policy,
            wire_policy=wire_policy, params=params, devices=[device] * pool.size,
        )

    # ------------------------------------------------------------------
    # Worlds and state
    # ------------------------------------------------------------------
    def _build_world(self, target: ParallelConfig) -> WorldHandle:
        if target not in self.groups:
            raise ValueError(f"{target.describe()}: its groups were not created at start (name it in worlds=)")
        return build_rank_world(self.cfg, target, self.opt_cfg, self.global_batch, self.seq_len,
                                self.groups[target], self.device, self.microbatches)

    def _initial_state(self, params: Optional[dict], seed: int):
        """This rank's shards of the seeded init (drawn whole on the
        device, as the one-process controller draws it, then cut), or of
        ``params``; None outside the world."""
        from repro_torch.models.model import init_params

        world = self.world
        if not world.member:
            return None, None
        if params is None:
            params = init_params(self.cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
        shards = shard_params(self.cfg, tree_map_with_path(lambda _, x: x.to(self.device), params), world.parallel,
                              self.rank)
        del params
        return shards, init_opt_state(shards)

    def _dst_buffers(self, specs, plan, handle: WorldHandle, reuse: Optional[dict]) -> dict:
        return rank_state_buffers(specs, plan, handle.parallel, self.rank, self.device)

    def _named(self) -> dict[str, torch.Tensor]:
        """This rank's shards by tensor name ({} outside the world)."""
        if self.params is None:
            return {}
        return named_state_leaves(self.params, self.opt_state)[0]

    def _batch(self) -> Optional[dict]:
        """This rank's dp rows of the step's batch (None outside the world)."""
        g = self.world.groups
        if not g.member:
            return None
        tokens = torch.from_numpy(self.data.shard_at(self.step, g.dp_rank, g.dp))
        return {"tokens": tokens.to(device=self.device, dtype=torch.long)}

    def request_resize(self, target: ParallelConfig, overlap: Optional[str] = None, operating_point=None) -> int:
        """Call on every rank at the same step."""
        check_rank_model(self.cfg, target)
        world_microbatches(target, self.microbatches, self.global_batch)
        if target not in self.groups:
            raise ValueError(f"{target.describe()}: its groups were not created at start (name it in worlds=)")
        return super().request_resize(target, overlap, operating_point)

    # ------------------------------------------------------------------
    # The lifecycle's per-rank hooks (core/controller.py)
    # ------------------------------------------------------------------
    def _agree_ready(self, ready: bool) -> bool:
        """The consistent cut, agreed: every rank all-reduces (MIN) its
        shadow's readiness, so all act on it at the same boundary."""
        return self.pool.agree(1.0 if ready else 0.0, "min") >= 1.0

    def _named_state(self) -> tuple[dict, dict]:
        # the step count is agreed at the install, not moved
        return self._named(), {}

    def _session_executor(self, new_world: WorldHandle, staging_bytes: int) -> RankExecutor:
        return RankExecutor({s.name: s for s in self._session_specs}, {}, self.rank, self._session_plan.cfg_dst,
                            self.pool, self.device, staging_bytes, wire_policy=self.wire_policy,
                            dst_buffers=new_world.buffers,
                            rounded=wire_rounded(self._session_plan, self._session_specs, self.rank,
                                                 self.wire_policy))

    def _reshard(self, specs, plan: TransferPlan, named: dict, new_world: WorldHandle, staging_bytes: int,
                 wire_policy=None, dst_buffers: Optional[dict] = None):
        moved, stats, ex = rank_reshard_planned(specs, plan, named, self.rank, self.pool, self.device,
                                                staging_bytes=staging_bytes, wire_policy=wire_policy,
                                                dst_buffers=dst_buffers)
        self._commit_execs.append(ex)
        return moved, stats

    def _install(self, moved: dict, extras: dict, new_world: WorldHandle):
        """This rank's destination shards (``moved``) as the state on
        ``new_world``, (None, None) outside it; the step count is the
        pool's agreed (MAX) one."""
        count = int(self.opt_state["count"]) if self.opt_state is not None else 0
        count = int(self.pool.agree(count, "max"))
        if not new_world.member:
            return None, None
        paths = [s.name[len("params/"):] for s in self._specs
                 if s.collection == "params" and view_of(s, new_world.parallel, self.rank) is not None]
        params = tree_from_paths({p: moved[f"params/{p}"] for p in paths})
        opt_state = {coll: tree_from_paths({p: moved[f"{coll}/{p}"] for p in paths}) for coll in ("mu", "nu")}
        opt_state["count"] = torch.tensor(count, dtype=torch.int32, device=self.device)
        return params, opt_state

    @contextmanager
    def _counted(self, executors: list):
        """Append this rank's ``RankCommit`` for the commit run inside:
        what ``executors`` and the transfers run in it moved, and the host
        staging from here to its end."""
        gen_id = self._builder.gen_id
        host0 = (self.pool.staging.bytes, self.pool.staging.seconds)
        self._commit_execs = list(executors)
        yield
        rc = RankCommit(gen_id, host_bytes=self.pool.staging.bytes - host0[0],
                        host_seconds=self.pool.staging.seconds - host0[1])
        for ex in self._commit_execs:
            rc.executed_bytes += ex.executed_bytes
            for src, into in ((ex.sent_bytes, rc.sent_bytes), (ex.recv_bytes, rc.recv_bytes)):
                for peer, n in src.items():
                    into[peer] = into.get(peer, 0) + n
        self._commit_execs = []
        self.rank_commits.append(rc)

    def _commit_switch(self) -> None:
        with self._counted([]):
            super()._commit_switch()

    def _split_step_commit(self, batch: Optional[dict]) -> dict:
        with self._counted([self._session.executor]):
            return super()._split_step_commit(batch)

    # ------------------------------------------------------------------
    # Verification
    # ------------------------------------------------------------------
    def gathered_params(self) -> Any:
        """A host copy of the params as numpy arrays on rank 0, None on the
        other ranks (verification only: never on the live path). Call on
        every rank."""
        specs = [s for s in self._specs if s.collection == "params"]
        out = {}
        for spec, whole in gather_each(self.pool, self._named(), self.world.parallel, specs, self.device):
            if whole is not None:
                out[spec.name[len("params/"):]] = whole.cpu().numpy()
        return tree_from_paths(out) if self.rank == 0 else None

    # ------------------------------------------------------------------
    # Not on per-rank worlds yet
    # ------------------------------------------------------------------
    def _not_yet(self, what: str):
        raise NotImplementedError(f"{what} is not ported to per-rank worlds yet")

    def prefetch_world(self, target):
        self._not_yet("prefetch_world")

    def retarget_resize(self, target, overlap=None, operating_point=None):
        self._not_yet("retarget_resize")

    def escalate_commit(self):
        self._not_yet("escalate_commit")

    def fail_stop_recover(self, *args, **kwargs):
        self._not_yet("fail_stop_recover")

    def prewarm_transfer(self, *args, **kwargs):
        self._not_yet("prewarm_transfer")

    def prewarm_failover_ahead(self):
        self._not_yet("prewarm_failover_ahead")

    def checkpoint_now(self):
        self._not_yet("checkpoint_now")
