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
(``_all``, ``_named_state``, ``_session_executor``, ``_reshard``,
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

The rest of the lifecycle runs through the same hooks, each decision a
rank takes on its own host agreed over the pool before it changes what the
rank sends (``_all``, MIN of a flag):

- the warm pool and ``prefetch_world``: a rank's pooled world holds its
  own functions and no tensor; whether a prefetch starts, which ended
  speculative builds are harvested, and whether a Prepare or a recovery
  takes a pooled world or joins a build (``_take_pooled``: a world exists
  on every rank or is used on none) are agreed, so every rank's pool keys,
  evicts and invalidates alike;
- ``retarget_resize``: the superseded session's carries are handed on
  where their view in the new target is the one they hold
  (``_carries_for``), its buffers as this rank's destination shards
  (``core/shadow.py::rank_state_buffers(reuse=)``), and the layers the
  successor adopts are agreed (``reshard/overlap.py::OverlapSession.adopt``);
- ``escalate_commit``: the readiness is agreed, and the session's carries
  and buffers are the stop-copy's destination;
- ``fail_stop_recover``: the residual shadow, the parity word's freshness
  and the checkpoint rung are agreed; the survivor-constrained,
  donor-balanced plan streams rank to rank, lossless whatever
  ``wire_policy`` is; a dead group is repaired from the XOR parity word on
  the rank ``heal_plan`` makes its source (``elastic/redundancy.py::
  RankParityStore``); the checkpoint rung reads each rank's view of the
  target world from the files (``checkpoint/ckpt.py::RankCheckpointer``,
  the one-process format, so the JAX loader reads it);
- a lost rank's process stays up (gloo cannot lose a member without a new
  rendezvous): ``lose_state`` poisons and frees all it held, and inside
  the target world it comes back as a replacement that receives its shards;
- ``prewarm_transfer`` and ``prewarm_failover_ahead`` plan on a thread and
  issue no collective.

Not on per-rank worlds yet: ``compression="int8_ef"`` (the constructor
takes no ``compression``).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.checkpoint import RankCheckpointer, load_rank_checkpoint
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.controller import LiveRController
from repro_torch.core.intersection import TransferPlan
from repro_torch.core.reshard import DEFAULT_STAGING_BYTES, named_state_leaves, rank_reshard_planned
from repro_torch.core.resource_view import assemble, build_tensor_specs, view_of
from repro_torch.core.shadow import WorldHandle, build_rank_world, rank_state_buffers, world_microbatches
from repro_torch.data import SyntheticLM
from repro_torch.distribution.groups import RankPool, make_world_groups
from repro_torch.distribution.step import check_rank_model, init_opt_state, shard_params
from repro_torch.elastic.redundancy import RankParityStore, survivors_for
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
        world_pool=None,
        ckpt_dir: Optional[str] = None,
        ckpt_interval: int = 50,
        parity_every: int = 0,
    ):
        for p in (parallel, *worlds):
            check_rank_model(cfg, p)
            world_microbatches(p, microbatches, global_batch)
        self.pool = pool
        self.rank = pool.rank
        self.groups = make_world_groups(pool, [parallel, *worlds])
        self._specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
        self._spec_map = {s.name: s for s in self._specs}
        self.rank_commits: list[RankCommit] = []
        self._commit_execs: list[RankExecutor] = []
        super().__init__(
            cfg, parallel, opt_cfg, seq_len, global_batch, data=data, staging_bytes=staging_bytes, device=device,
            microbatches=microbatches, seed=seed, overlap=overlap, stream_k=stream_k, source_policy=source_policy,
            wire_policy=wire_policy, params=params, devices=[device] * pool.size, world_pool=world_pool,
            ckpt_dir=ckpt_dir, ckpt_interval=ckpt_interval, parity_every=parity_every,
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
        return rank_state_buffers(specs, plan, handle.parallel, self.rank, self.device, reuse=reuse)

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

    def _check_target(self, target: ParallelConfig) -> None:
        check_rank_model(self.cfg, target)
        world_microbatches(target, self.microbatches, self.global_batch)
        if target not in self.groups:
            raise ValueError(f"{target.describe()}: its groups were not created at start (name it in worlds=)")

    def request_resize(self, target: ParallelConfig, overlap: Optional[str] = None, operating_point=None) -> int:
        """Call on every rank at the same step (as every verb below)."""
        self._check_target(target)
        return super().request_resize(target, overlap, operating_point)

    def retarget_resize(self, target: ParallelConfig, overlap: Optional[str] = None, operating_point=None) -> int:
        self._check_target(target)
        return super().retarget_resize(target, overlap, operating_point)

    def prefetch_world(self, target: ParallelConfig) -> bool:
        """As in one process, where ``target``'s groups were created at
        start; False for any other world (the same on every rank)."""
        try:
            self._check_target(target)
        except ValueError:
            return False
        return super().prefetch_world(target)

    # ------------------------------------------------------------------
    # The lifecycle's per-rank hooks (core/controller.py)
    # ------------------------------------------------------------------
    def _all(self, flag: bool) -> bool:
        """``flag`` on every rank of the pool (an all-reduce MIN): the
        consistent cut is agreed so, every rank acting on its shadow's
        readiness at the same boundary."""
        return self.pool.agree(1.0 if flag else 0.0, "min") >= 1.0

    def _ready_spec_keys(self) -> list:
        """The speculative builds every rank has ended (one all-reduce)."""
        keys = list(self._spec_builders)
        flags = self.pool.agree_all([1.0 if self._spec_builders[k].ready else 0.0 for k in keys], "min")
        return [k for k, f in zip(keys, flags) if f >= 1.0]

    def _take_pooled(self, target: ParallelConfig) -> tuple:
        """The one-process take, agreed: what every rank has (a warm world
        2, an in-flight build 1, nothing 0; MIN). Where some rank has
        nothing, every rank puts back what it took and builds cold; else
        each uses its own and all record the agreed source."""
        warm, join, _ = super()._take_pooled(target)
        have = 2 if warm is not None else 1 if join is not None else 0
        agreed = int(self.pool.agree(have, "min"))
        key = self.pool_key(target)
        if agreed == 0:
            if warm is not None:
                self.world_pool.put(key, warm)
            if join is not None:
                self._spec_builders[key] = join
            return None, None, "cold"
        # a build of the same world left beside a warm one would part this
        # rank's speculative builds from the others'
        self._spec_builders.pop(key, None)
        return warm, join, "pool" if agreed == 2 else "speculative_join"

    def _carries_for(self, carries: dict, target: ParallelConfig) -> dict:
        """The carries whose view in ``target`` on this rank is the view
        they hold in the superseded session's target: the ones the
        successor may adopt as streamed."""
        old = self._session_plan.cfg_dst
        out = {}
        for name, t in carries.items():
            spec = self._spec_map[name]
            a = view_of(spec, old, self.rank) if self.rank < old.world_size else None
            b = view_of(spec, target, self.rank) if self.rank < target.world_size else None
            if a is not None and b is not None and a.bounds == b.bounds:
                out[name] = t
        return out

    def _make_checkpointer(self, ckpt_dir: str) -> RankCheckpointer:
        def state():
            count = int(self.opt_state["count"]) if self.opt_state is not None else 0
            return self._named(), int(self.pool.agree(count, "max")), self.world.parallel

        return RankCheckpointer(ckpt_dir, self.pool, self._specs, state)

    def _load_checkpoint(self, world: WorldHandle) -> tuple:
        """Every rank's view of ``world`` read from the latest checkpoint,
        into the live tensors whose view does not change; the rest of the
        old state is let go first."""
        old, new = self.world.parallel, world.parallel
        keep = {n: t for n, t in self._named().items()
                if self.rank < new.world_size and view_of(self._spec_map[n], new, self.rank) is not None
                and view_of(self._spec_map[n], new, self.rank).bounds == view_of(self._spec_map[n], old, self.rank).bounds}
        self.params = self.opt_state = None
        named, count, step, load_s = load_rank_checkpoint(self.ckpt_dir, self._specs, new, self.pool, self.device,
                                                          live=keep)
        del keep
        params, opt_state = self._state_from(named, count, world)
        return params, opt_state, step, load_s

    def _parity_store(self, specs, parallel: ParallelConfig) -> RankParityStore:
        return RankParityStore(specs, parallel, self.pool, self.device)

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
        return self._state_from(moved, int(self.pool.agree(count, "max")), new_world)

    def _state_from(self, moved: dict, count: int, new_world: WorldHandle):
        """(params, opt_state) of this rank on ``new_world`` from its shards
        by name and the step count; (None, None) outside it."""
        if not new_world.member:
            return None, None
        paths = [s.name[len("params/"):] for s in self._specs
                 if s.collection == "params" and view_of(s, new_world.parallel, self.rank) is not None]
        params = tree_from_paths({p: moved[f"params/{p}"] for p in paths})
        opt_state = {coll: tree_from_paths({p: moved[f"{coll}/{p}"] for p in paths}) for coll in ("mu", "nu")}
        opt_state["count"] = torch.tensor(count, dtype=torch.int32, device=self.device)
        return params, opt_state

    @contextmanager
    def _counted(self, executors: list, gen_id: Optional[int] = None):
        """Append this rank's ``RankCommit`` for the commit (a recovery:
        ``gen_id`` -1) run inside: what ``executors`` and the transfers run
        in it moved, and the host staging from here to its end."""
        gen_id = self._builder.gen_id if gen_id is None else gen_id
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

    def fail_stop_recover(self, target: ParallelConfig, devices_failed: bool = True, lost_ranks: tuple = ()):
        """Call on every rank at the same step (a lost rank's too: its
        process stays up). Where ``devices_failed``, the lost ranks' state
        goes first (``lose_state``)."""
        self._check_target(target)
        if devices_failed:
            src = self.world.parallel
            self.lose_state(frozenset(range(src.world_size))
                            - survivors_for(src, lost_ranks, target=target, devices_failed=True))
        with self._counted([], gen_id=-1):
            return super().fail_stop_recover(target, devices_failed=devices_failed, lost_ranks=lost_ranks)

    def _drop_reconfig(self, target: ParallelConfig) -> tuple:
        """The one-process hand-on, less the tensors that are not this
        rank's view in ``target`` (a session's carries of another target)."""
        residual, buffers = super()._drop_reconfig(target)
        keep = {}
        for name, t in buffers.items():
            spec = self._spec_map[name]
            view = view_of(spec, target, self.rank) if self.rank < target.world_size else None
            if view is not None and tuple(t.shape) == view.shape() and t.dtype == getattr(torch, spec.dtype):
                keep[name] = t
        return residual, keep

    def lose_state(self, lost: frozenset) -> None:
        """A fail-stop of ``lost``: on a lost rank every shard, moment,
        carry, destination buffer and parity word this process holds is
        overwritten with 0xFF bytes and its storage freed, and the
        references dropped; the process stays in the pool. A survivor keeps
        all it holds. Call on every rank (no collective)."""
        if self.rank not in lost:
            return
        held = list(self._named().values())
        if self.opt_state is not None:
            held.append(self.opt_state["count"])
        if self._session is not None:
            self._session.drain()
            ex = self._session.executor
            held += [*ex.dst.values(), *ex.dst_buffers.values()]
            ex.dst, ex.dst_buffers = {}, {}
            ex.update_sources({})
        if self._builder is not None and self._builder.ready and self.machine.shadow is not None:
            shadow = self._builder.result()
            held += list(shadow.buffers.values())
            shadow.buffers = {}
        if self._reuse is not None:
            held += list(self._reuse[0].values())
            self._reuse = None
        if self._parity is not None:
            held.append(self._parity.word)
        self._sync()
        freed = set()
        for t in held:
            st = t.untyped_storage()
            if st.data_ptr() in freed or st.nbytes() == 0:
                continue
            freed.add(st.data_ptr())
            torch.empty(0, dtype=torch.uint8, device=t.device).set_(st, 0, (st.nbytes(),)).fill_(0xFF)
        self._sync()
        for t in held:
            st = t.untyped_storage()
            if st.resizable() and st.nbytes():
                st.resize_(0)
        # the parity store keeps its step and groups: the survivors' words
        # are the ones a repair reads
        self.params = self.opt_state = None
        del held

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
