"""Process groups of per-rank worlds: what the JAX package's mesh is to its
global arrays.

A per-rank world is a ``ParallelConfig`` whose ranks are processes, each
holding its own shard of every tensor (``core/resource_view.py::shard_of``).
The processes of the rank pool share one default group
(``torch.distributed``), and :class:`RankPool` is that group: the batched
point-to-point call the reshard executor posts its cells through
(``reshard/executors.py::RankExecutor``), and the agreement the
controller's step boundaries take (``core/rank_controller.py``).
:class:`RankGroups` is one world seen from one process: its dp, pp, ep and
tp groups (each the ranks that differ from this one in that coordinate
only), its coordinates from ``ParallelConfig.rank_coords`` (the
coordinates ``core/resource_view.py::view_of`` reads), and the
collectives its step takes (``all_reduce`` sum or max, ``all_gather``,
``reduce_scatter``, and the pipeline's point-to-point ``send`` and
``recv`` to a peer of a group, by its index there).

``dist.new_group`` is collective over the default group, so every process
creates every world's groups, in the same order, for each
``ParallelConfig`` the pool may use (:func:`make_world_groups`, once at
start); a process outside a world creates its groups too and never calls
them.

The backend: ``nccl`` where every rank has a card of its own, ``gloo``
otherwise, and on the CPU. Under gloo a CUDA tensor goes through a pinned
host buffer, here and nowhere else (:class:`HostStaging`, which counts the
bytes and seconds it carries); nothing else in the code knows which
backend is in use. On one card this is a stand-in for the interconnect:
the ranks' compute and shards stay on the card.

Every collective over a group of one rank is the identity and records
nothing; the others append ``(op, group, bytes)`` to ``collectives``
(``bytes`` what this rank puts in, or takes out of a ``recv``), as
``core/mock_groups.py::MockGroups`` does without communicating. The pool
records its own the same way, under the group ``"pool"``: the byte-frame
broadcast from rank 0 (``broadcast_bytes``, the control plane's command
frames, ``elastic/endpoint.py::RankEndpoint``) and the XOR reduction of
``uint8`` words (``xor_reduce``, the parity word's and its repair's,
``elastic/redundancy.py::RankParityStore``). Its agreements
(``agree``, ``agree_all``) record nothing: they carry a flag a rank, not
state.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ParallelConfig

__all__ = [
    "Collectives",
    "HostStaging",
    "RankGroups",
    "RankPool",
    "check_rank_world",
    "group_members",
    "make_world_groups",
]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
# a frame or a word crosses the pool in pieces of at most this many bytes
POOL_CHUNK_BYTES = 1 << 28


GROUPS = ("dp", "pp", "ep", "tp")


def check_rank_world(parallel: ParallelConfig) -> None:
    """A per-rank world has a degree of at least 1 on each of dp, pp, ep
    and tp."""
    bad = {g: getattr(parallel, g) for g in GROUPS if getattr(parallel, g) < 1}
    if bad:
        raise ValueError(f"{parallel.describe()}: degrees {bad} below 1")


def group_members(parallel: ParallelConfig, group: str, rank: int) -> list[int]:
    """The ranks of ``parallel`` in ``rank``'s ``group``: those whose
    coordinates differ from its own in that group's only, in the order of
    that coordinate."""
    coords = list(parallel.rank_coords(rank))
    axis = GROUPS.index(group)
    out = []
    for i in range(getattr(parallel, group)):
        coords[axis] = i
        out.append(parallel.coords_rank(*coords))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class HostStaging:
    """Moves CUDA tensors through pinned host buffers for a backend that
    communicates host memory (gloo): ``bytes`` and ``seconds`` count what
    it carried, both directions."""

    def __init__(self, active: bool):
        self.active = active
        self.bytes = 0
        self.seconds = 0.0

    def needed(self, t: torch.Tensor) -> bool:
        return self.active and t.is_cuda

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.bytes += _nbytes(t)
        self.seconds += time.perf_counter() - t0
        return host

    def empty_host(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def to_device(self, dst: torch.Tensor, host: torch.Tensor) -> None:
        t0 = time.perf_counter()
        dst.copy_(host)
        self.bytes += _nbytes(host)
        self.seconds += time.perf_counter() - t0


class Collectives:
    """The collectives of one world as its step calls them, over groups
    named ``"dp"``, ``"pp"``, ``"ep"`` and ``"tp"``; the subclass
    communicates (``_all_reduce``, ``_all_gather``, ``_reduce_scatter``,
    ``_send``, ``_recv``) or does not. Each collective returns a new tensor
    (over a group of one rank, the input itself) and leaves its input as it
    is."""

    parallel: ParallelConfig
    rank: int

    def _setup(self, parallel: ParallelConfig, rank: int) -> None:
        check_rank_world(parallel)
        self.parallel = parallel
        self.rank = rank
        self.member = 0 <= rank < parallel.world_size
        self.dp, self.pp, self.ep, self.tp = parallel.dp, parallel.pp, parallel.ep, parallel.tp
        coords = parallel.rank_coords(rank) if self.member else (-1, -1, -1, -1)
        self.dp_rank, self.pp_rank, self.ep_rank, self.tp_rank = coords
        self.collectives: list[tuple[str, str, int]] = []

    def size(self, group: str) -> int:
        return {"dp": self.dp, "pp": self.pp, "ep": self.ep, "tp": self.tp}[group]

    def _record(self, op: str, group: str, t: torch.Tensor) -> None:
        self.collectives.append((op, group, _nbytes(t)))

    def all_reduce(self, t: torch.Tensor, group: str, op: str = "sum") -> torch.Tensor:
        if self.size(group) == 1:
            return t
        self._record(f"all_reduce_{op}", group, t)
        return self._all_reduce(t.contiguous().clone(), group, op)

    def all_gather(self, t: torch.Tensor, group: str, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in group order."""
        if self.size(group) == 1:
            return t
        self._record("all_gather", group, t)
        return self._all_gather(t.contiguous(), group, dim)

    def reduce_scatter(self, t: torch.Tensor, group: str, dim: int = -1) -> torch.Tensor:
        """The sum over the group of ``t``, cut along ``dim`` into equal
        parts: this rank's part."""
        if self.size(group) == 1:
            return t
        if t.shape[dim] % self.size(group):
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} is not a multiple of {self.size(group)}")
        self._record("reduce_scatter", group, t)
        return self._reduce_scatter(t.contiguous(), group, dim)

    def send(self, t: torch.Tensor, group: str, peer: int) -> None:
        """``t`` to the rank of index ``peer`` in this rank's ``group``;
        returns once ``t`` may be overwritten. A pair of ranks matches its
        sends and receives in the order both post them."""
        self._record("send", group, t)
        self._send(t.contiguous(), group, peer)

    def recv(self, shape, dtype, device, group: str, peer: int) -> torch.Tensor:
        """A new tensor of ``shape`` and ``dtype`` on ``device``: what the
        rank of index ``peer`` in this rank's ``group`` sent."""
        out = torch.empty(shape, dtype=dtype, device=device)
        self._record("recv", group, out)
        return self._recv(out, group, peer)


class RankPool:
    """The default group of the rank pool: this process's rank, the pool's
    size, the batched point-to-point call and the agreement of the step
    boundaries. ``torch.distributed`` must be initialised."""

    def __init__(self, backend: Optional[str] = None):
        if not dist.is_initialized():
            raise RuntimeError("RankPool needs torch.distributed initialised (init_process_group)")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = backend or dist.get_backend()
        self.staging = HostStaging(self.backend == "gloo")
        self.collectives: list[tuple[str, str, int]] = []

    def exchange(self, sends: list[tuple[int, torch.Tensor]], recvs: list[tuple[int, torch.Tensor]]) -> None:
        """Post every send (``(peer, tensor)``) and receive (``(peer,
        tensor)``, filled in place) in one ``dist.batch_isend_irecv`` and
        wait for all. Messages between a pair of ranks match in the order
        both sides list them."""
        if not sends and not recvs:
            return
        staged_recv = []
        ops = []
        for peer, t in sends:
            if peer == self.rank:
                raise ValueError("a rank does not send to itself")
            buf = self.staging.to_host(t) if self.staging.needed(t) else t.contiguous()
            ops.append(dist.P2POp(dist.isend, buf, peer))
        for peer, t in recvs:
            buf = self.staging.empty_host(t) if self.staging.needed(t) else t
            if not buf.is_contiguous():
                raise ValueError("a receive buffer must be contiguous")
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            staged_recv.append((t, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for t, buf in staged_recv:
            if buf is not t:
                self.staging.to_device(t, buf)

    def agree(self, value: float, op: str = "min") -> float:
        """``value`` reduced over every rank of the pool (``min``, ``max``
        or ``sum``): what each rank's host decided, made one decision."""
        return self.agree_all([value], op)[0]

    def agree_all(self, values, op: str = "min") -> list[float]:
        """Each of ``values`` reduced over every rank of the pool, in one
        all-reduce (every rank passes as many)."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        if t.numel():
            dist.all_reduce(t, op=_OPS[op])
        return t.tolist()

    def broadcast_bytes(self, frame: Optional[bytes]) -> bytes:
        """Rank 0's ``frame`` on every rank (the others pass None)."""
        n = torch.tensor([len(frame) if self.rank == 0 else 0], dtype=torch.int64)
        dist.broadcast(n, 0)
        size = int(n.item())
        buf = torch.frombuffer(bytearray(frame), dtype=torch.uint8) if self.rank == 0 and size else \
            torch.empty(size, dtype=torch.uint8)
        for lo in range(0, size, POOL_CHUNK_BYTES):
            dist.broadcast(buf[lo:lo + POOL_CHUNK_BYTES], 0)
        self.collectives.append(("broadcast_bytes", "pool", size))
        return buf.numpy().tobytes()

    def xor_reduce(self, word: torch.Tensor, dst: Optional[int] = None) -> torch.Tensor:
        """The byte-wise XOR over every rank of the pool of its ``word``
        (a contiguous ``uint8`` tensor, as long on every rank), written into
        ``word``: on every rank (``dst`` None) or on rank ``dst`` only (the
        others' words are left undefined). A word on the card goes through
        a host copy (gloo reduces host memory); a pool over nccl, which has
        no XOR, raises."""
        if word.dtype != torch.uint8 or not word.is_contiguous():
            raise ValueError("xor_reduce takes a contiguous uint8 tensor")
        if self.backend != "gloo":
            raise NotImplementedError(f"xor_reduce over {self.backend}: only gloo reduces by XOR")
        host = self.staging.to_host(word) if word.is_cuda else word
        for lo in range(0, host.numel(), POOL_CHUNK_BYTES):
            piece = host[lo:lo + POOL_CHUNK_BYTES]
            if dst is None:
                dist.all_reduce(piece, op=dist.ReduceOp.BXOR)
            else:
                dist.reduce(piece, dst, op=dist.ReduceOp.BXOR)
        self.collectives.append(("xor_reduce" if dst is None else f"xor_reduce_to_{dst}", "pool", host.numel()))
        if host is not word:
            self.staging.to_device(word, host)
        return word


class RankGroups(Collectives):
    """One world's dp, pp, ep and tp groups seen from process
    ``pool.rank``. Construct it on every process of the pool, in the same
    order (see :func:`make_world_groups`)."""

    def __init__(self, parallel: ParallelConfig, pool: RankPool):
        self._setup(parallel, pool.rank)
        self.pool = pool
        if parallel.world_size > pool.size:
            raise ValueError(f"{parallel.describe()} needs {parallel.world_size} ranks, the pool has {pool.size}")
        self._groups: dict[str, object] = {}
        self._members: dict[str, list[int]] = {}
        for name in ("tp", "ep", "pp", "dp"):
            if getattr(parallel, name) == 1:
                continue
            # each group once, listed from its first rank, in rank order
            layouts = sorted({tuple(group_members(parallel, name, r)) for r in range(parallel.world_size)})
            for ranks in layouts:
                group = dist.new_group(list(ranks))  # collective over the default group
                if self.rank in ranks:
                    self._groups[name] = group
                    self._members[name] = list(ranks)

    def _run(self, fn, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """``fn(x, out)`` on host copies of CUDA tensors under gloo, on the
        tensors themselves otherwise; returns ``out``."""
        st = self.pool.staging
        if not st.needed(x):
            fn(x, out)
            return out
        hx = st.to_host(x)
        hout = hx if out is x else st.empty_host(out)
        fn(hx, hout)
        st.to_device(out, hout)
        return out

    def _all_reduce(self, t, group, op):
        return self._run(lambda x, _: dist.all_reduce(x, op=_OPS[op], group=self._groups[group]), t, t)

    def _all_gather(self, t, group, dim):
        out = torch.empty((self.size(group), *t.shape), dtype=t.dtype, device=t.device)
        self._run(lambda x, o: dist.all_gather(list(o.unbind(0)), x, group=self._groups[group]), t, out)
        return torch.cat(list(out.unbind(0)), dim=dim)

    def _reduce_scatter(self, t, group, dim):
        stacked = torch.stack(t.chunk(self.size(group), dim=dim))
        out = torch.empty_like(stacked[0])
        self._run(lambda x, o: dist.reduce_scatter(o, list(x.unbind(0)), group=self._groups[group]), stacked, out)
        return out

    def _send(self, t, group, peer):
        st = self.pool.staging
        dist.send(st.to_host(t) if st.needed(t) else t, self._members[group][peer])

    def _recv(self, out, group, peer):
        st = self.pool.staging
        if not st.needed(out):
            dist.recv(out, self._members[group][peer])
            return out
        host = st.empty_host(out)
        dist.recv(host, self._members[group][peer])
        st.to_device(out, host)
        return out


def make_world_groups(pool: RankPool, worlds) -> dict[ParallelConfig, RankGroups]:
    """Every world's groups, created on every process of the pool in one
    order (the worlds deduplicated and sorted by (dp, pp, tp, ep)): call it on all
    ranks with the same worlds, once at start."""
    unique = sorted(set(worlds), key=lambda p: (p.dp, p.pp, p.tp, p.ep))
    for p in unique:
        check_rank_world(p)
    return {p: RankGroups(p, pool) for p in unique}
