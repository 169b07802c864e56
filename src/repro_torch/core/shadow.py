"""Shadow World construction (paper §4.4 'Parallel Worlds').

While the Active World keeps working, a background thread (the Companion
Manager's worker) builds the target world. A world of the port is a
``ParallelConfig`` plus a rank -> device list, and the functions that run
on it; what its build does ahead of the switch is the set-up the first
step on the new world would otherwise pay: kernel libraries, CUDA and
cuBLAS on the world's device (``serve/world.py`` for serving,
:func:`build_train_world` here for training) and, for a training resize,
the destination tensors the reshard writes into (:func:`state_buffers`,
called by the controller's Prepare once the plan is known).

The JAX package's Prepare lowers and compiles the world's step ahead of
time against abstract inputs, with mock process groups standing in for the
communicators (``core/mock_groups.py``). Eager PyTorch compiles nothing
ahead; a one-process world has no communicators, and its Prepare builds the
functions only. A per-rank world (:func:`build_rank_world`, one process a
rank over ``distribution/groups.py``) runs the rank's own step once on the
meta device under the mock process groups (``core/mock_groups.py``), and
plans and allocates only this rank's destination views
(:func:`rank_state_buffers`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig


def world_device(devices) -> torch.device:
    """The one device a one-process world's ranks map to: its state is held
    as global tensors there. Ranks on several devices are a per-rank world,
    one process a rank (:func:`build_rank_world`)."""
    distinct = {torch.device(d) for d in devices}
    if len(distinct) != 1:
        raise ValueError(
            f"a one-process world's ranks must all map to one device, got {sorted(map(str, distinct))}; "
            "place ranks on several devices with a per-rank world (core/rank_controller.py, one process a rank)"
        )
    return distinct.pop()


@dataclass
class WorldHandle:
    """Everything the loop needs from a world: the rank -> device list (in
    place of the JAX package's mesh) and the functions that run on it."""

    parallel: ParallelConfig
    devices: list  # rank -> torch.device
    step_fn: Callable
    gen_id: int = -1
    timings: dict = field(default_factory=dict)
    update_fn: Optional[Callable] = None
    # training worlds: the forward/backward half of the step (split-step
    # commit), the (src parallel, specs, plan) planned during Prepare, and
    # destination tensors allocated ahead, by tensor name
    grad_fn: Optional[Callable] = None
    plan_bundle: Optional[tuple] = None
    buffers: dict = field(default_factory=dict)
    released: bool = False
    # per-rank worlds: this process's rank, its device and the world's
    # process groups (None in a one-process world)
    rank: Optional[int] = None
    rank_device: Optional[torch.device] = None
    groups: Optional[object] = None

    @property
    def device(self) -> torch.device:
        if self.rank_device is not None:
            return self.rank_device
        return world_device(self.devices)

    @property
    def member(self) -> bool:
        """This process holds a rank of the world (always, in a
        one-process world)."""
        return self.groups is None or self.groups.member

    def release(self) -> None:
        """Drop the world's functions and buffers. Idempotent; a released
        handle must never run or be pooled again."""
        self.step_fn = None
        self.update_fn = None
        self.grad_fn = None
        self.plan_bundle = None
        self.buffers = {}
        self.released = True


class ShadowBuilder:
    """Builds a WorldHandle in a background thread; poll ``ready`` — the
    Companion Manager thread of the paper's §4.5.1.

    ``on_discard`` is invoked exactly once with the completed handle when
    the builder was abandoned — from the worker thread if the abandon
    preceded completion, from ``abandon()`` itself otherwise. The default
    releases the world's device memory (an orphaned build used to pin its
    mesh + executables until GC); the controller overrides it to deposit
    the world into the warm :class:`~repro_torch.core.world_pool.WorldPool`.
    """

    def __init__(
        self,
        build_fn: Callable[[], WorldHandle],
        gen_id: int,
        on_discard: Optional[Callable[[WorldHandle], None]] = None,
    ):
        self._build_fn = build_fn
        self.gen_id = gen_id
        self._result: Optional[WorldHandle] = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        # non-daemon: a daemon thread killed inside a CUDA call at
        # interpreter exit can abort the process; Python joins
        # non-daemon threads cleanly (exit waits out an in-flight build
        # instead of crashing)
        self._thread = threading.Thread(target=self._run, daemon=False)
        # stamped when the worker thread starts, NOT at construction:
        # callers (the warm pool above all) routinely construct builders
        # well before starting them, and stamping in __init__ silently
        # inflated prepare_total_s by the construction→start gap
        self.started_at: Optional[float] = None
        self.abandoned = False
        self._on_discard = on_discard
        self._discard_lock = threading.Lock()
        self._discarded = False

    def start(self) -> "ShadowBuilder":
        self._thread.start()
        return self

    def _run(self) -> None:
        self.started_at = time.perf_counter()
        try:
            handle = self._build_fn()
            handle.gen_id = self.gen_id
            handle.timings["prepare_total_s"] = time.perf_counter() - self.started_at
            self._result = handle
        except BaseException as e:  # surfaced on result()
            self._error = e
        finally:
            self._build_fn = None  # what the build closed over goes now
            self._done.set()
        self._maybe_discard()

    @property
    def ready(self) -> bool:
        return self._done.is_set()

    def _maybe_discard(self) -> None:
        with self._discard_lock:
            if not self.abandoned or self._discarded or self._result is None:
                return
            self._discarded = True
            handle = self._result
        if self._on_discard is not None:
            self._on_discard(handle)
        else:
            handle.release()

    def abandon(self) -> None:
        """Retarget/cancel semantics (paper §7 'Concurrent reconfiguration
        events'): the worker thread cannot be killed mid-build, so
        the builder is marked abandoned and its world discarded on
        completion (``on_discard`` — release or pool deposit; it no longer
        lingers until GC). The controller may start a fresh builder
        immediately — the stale thread only ever writes into this object."""
        self.abandoned = True
        if self._done.is_set():
            self._maybe_discard()

    @property
    def running(self) -> bool:
        """The worker thread has not ended yet."""
        return self._thread.is_alive()

    def join(self) -> None:
        """Wait until the worker thread has ended: its world built and, if
        the builder was abandoned, discarded."""
        self._thread.join()

    def result(self, timeout: Optional[float] = None) -> WorldHandle:
        if not self._done.wait(timeout):
            raise TimeoutError("shadow world not ready")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


# ---------------------------------------------------------------------------
# Training worlds
# ---------------------------------------------------------------------------

_TRAIN_KERNELS = ("flash_attention", "flash_attention_tc", "flash_attention_bwd", "flash_attention_bwd_tc",
                  "reshard_pack", "reshard_quant")
_SSM_TRAIN_KERNELS = ("ssd_scan", "ssd_scan_bwd")


def train_kernels(cfg: ModelConfig) -> tuple[str, ...]:
    """The kernel libraries a train world of ``cfg`` launches: the flash
    and reshard libraries, and the SSD forward and backward when a block
    has an SSM mixer, so that a cold Prepare has loaded them all before the
    commit."""
    from repro_torch.models.transformer import block_program

    has_ssm = any(mixer == "ssm" for mixer, _ in block_program(cfg))
    return _TRAIN_KERNELS + (_SSM_TRAIN_KERNELS if has_ssm else ())


def warm_device(device: torch.device, dtype: torch.dtype, kernels=_TRAIN_KERNELS) -> None:
    """Load the kernel libraries (building them first if this process has
    not) and initialise CUDA and cuBLAS on ``device`` in this thread."""
    from repro_torch.kernels import build

    for name in kernels:
        build.load(name)
    with torch.cuda.device(device):
        a = torch.ones((64, 64), dtype=dtype, device=device)
        (a @ a).sum()
        torch.cuda.current_stream(device).synchronize()


def abstract_batch(cfg: ModelConfig, global_batch: int, seq_len: int) -> dict:
    """The batch a train step takes, on the meta device: shapes and dtypes
    (the JAX package's ``ShapeDtypeStruct`` tree). An enc-dec model's
    ``frames`` are (global_batch, seq_len, d_model) in ``cfg.dtype``."""
    abatch = {"tokens": torch.empty((global_batch, seq_len), dtype=torch.long, device="meta")}
    if cfg.family == "encdec":
        abatch["frames"] = torch.empty(
            (global_batch, seq_len, cfg.d_model), dtype=getattr(torch, cfg.dtype), device="meta"
        )
    return abatch


def build_update_world_fn(cfg: ModelConfig, parallel: ParallelConfig, opt_cfg, compression: str = "none"):
    """The optimizer half of the step for the split-step commit (in place,
    ``distribution/step.py::make_update_fn``)."""
    from repro_torch.distribution.step import make_update_fn

    return make_update_fn(opt_cfg, compression)


def build_train_world(
    cfg: ModelConfig,
    parallel: ParallelConfig,
    opt_cfg,
    global_batch: int,
    seq_len: int,
    microbatches: int = 1,
    devices=None,
    compression: str = "none",
    remat: str = "full",
) -> WorldHandle:
    """Synchronous training-world construction (the shadow thread's body):
    the step, its grad and update halves, and on the card the kernel
    libraries and cuBLAS warmed in this thread. A ``pp > 1`` world trains
    through ``distribution/pipeline.py`` with ``max(microbatches, pp)``
    microbatches, as the JAX package builds it; it refuses an enc-dec model
    and ``compression="int8_ef"``."""
    from repro_torch.distribution.step import make_grad_fn, make_train_step

    if parallel.pp > 1:
        from repro_torch.distribution.pipeline import make_pipeline_grad_fn, make_pipeline_train_step

        mb = max(microbatches, parallel.pp)
        step_fn = make_pipeline_train_step(cfg, parallel, opt_cfg, mb, compression)
        grad_fn = make_pipeline_grad_fn(cfg, parallel, mb)
    else:
        step_fn = make_train_step(cfg, opt_cfg, microbatches, remat, compression)
        grad_fn = make_grad_fn(cfg, microbatches, remat)
    devices = [torch.device(d) for d in devices]
    if len(devices) != parallel.world_size:
        raise ValueError(f"{len(devices)} devices for a world of {parallel.world_size} ranks")
    device = world_device(devices)
    timings: dict = {}
    t0 = time.perf_counter()
    if device.type == "cuda":
        warm_device(device, getattr(torch, cfg.dtype), train_kernels(cfg))
    timings["warm_s"] = time.perf_counter() - t0
    return WorldHandle(
        parallel=parallel,
        devices=devices,
        step_fn=step_fn,
        timings=timings,
        update_fn=build_update_world_fn(cfg, parallel, opt_cfg, compression),
        grad_fn=grad_fn,
    )


def state_buffers(specs, plan, device: torch.device, reuse: Optional[dict] = None) -> dict[str, torch.Tensor]:
    """Destination tensors for every tensor the plan moves bytes into.
    Tensors whose every cell is resident are adopted in place at the
    commit (``reshard/executors.py``) and get none.

    ``reuse``: tensors by name that may serve as destinations (a superseded
    session's carries and unused buffers, at a retarget): one of the same
    name, shape, dtype and device is taken as it is, with whatever bytes it
    holds (the plan overwrites every row it moves), and only the rest are
    allocated, zeroed."""
    moved = {t.tensor for t in plan.tasks if t.kind != "resident"}
    reuse = reuse or {}
    out = {}
    for s in specs:
        if s.name not in moved:
            continue
        dtype = getattr(torch, s.dtype)
        buf = reuse.get(s.name)
        if buf is not None and tuple(buf.shape) == tuple(s.shape) and buf.dtype == dtype and buf.device == device:
            out[s.name] = buf
        else:
            out[s.name] = torch.zeros(s.shape, dtype=dtype, device=device)
    return out


# ---------------------------------------------------------------------------
# Per-rank training worlds
# ---------------------------------------------------------------------------


def rank_meta_args(cfg: ModelConfig, parallel: ParallelConfig, rank: int, global_batch: int, seq_len: int) -> tuple:
    """(params, opt_state, batch) of rank ``rank``'s step on the meta
    device: its shards' shapes and its dp rows of the batch."""
    from repro_torch.distribution.step import init_opt_state, shard_train_state
    from repro_torch.models.model import abstract_params

    params = abstract_params(cfg)
    params, opt = shard_train_state(cfg, params, init_opt_state(params), parallel, rank)
    return params, opt, abstract_batch(cfg, global_batch // parallel.dp, seq_len)


def world_microbatches(parallel: ParallelConfig, microbatches: int, global_batch: int) -> int:
    """The microbatches a per-rank world of ``parallel`` steps in: a world
    with pipeline stages ``max(microbatches, pp)``, as a one-process world
    takes them; any other ``min(microbatches, rows)`` over its
    ``global_batch / dp`` rows a rank, which must be a multiple of them.
    Refuses a world whose rows do not divide so."""
    if global_batch % parallel.dp:
        raise ValueError(f"global batch {global_batch} is not a multiple of dp={parallel.dp}")
    if parallel.pp > 1:
        return max(microbatches, parallel.pp)
    rows = global_batch // parallel.dp
    mb = min(microbatches, rows)
    if rows % mb:
        raise ValueError(f"{parallel.describe()}: {rows} rows a rank are not a multiple of microbatches={mb}")
    return mb


def rank_step_fns(cfg: ModelConfig, parallel: ParallelConfig, opt_cfg, microbatches: int, groups) -> tuple:
    """(train step, grad half, update half) of rank ``groups.rank`` of
    ``parallel``: through ``distribution/pipeline.py`` with ``max(
    microbatches, pp)`` microbatches where the world has pipeline stages,
    as a one-process world takes them, else ``distribution/step.py``."""
    from repro_torch.distribution.step import make_grad_fn, make_train_step, make_update_fn, split_paths

    update_fn = make_update_fn(opt_cfg, groups=groups, split=split_paths(cfg, parallel))
    if parallel.pp > 1:
        from repro_torch.distribution.pipeline import make_pipeline_grad_fn, make_pipeline_train_step

        mb = max(microbatches, parallel.pp)
        return (make_pipeline_train_step(cfg, parallel, opt_cfg, mb, groups=groups),
                make_pipeline_grad_fn(cfg, parallel, mb, groups), update_fn)
    return (make_train_step(cfg, opt_cfg, microbatches, groups=groups), make_grad_fn(cfg, microbatches, groups=groups),
            update_fn)


def build_rank_world(
    cfg: ModelConfig,
    parallel: ParallelConfig,
    opt_cfg,
    global_batch: int,
    seq_len: int,
    groups,
    device,
    microbatches: int = 1,
) -> WorldHandle:
    """A per-rank training world seen from one process (the shadow
    thread's body): ``groups`` is the world's ``RankGroups``, created at
    start on every process. For a rank of the world: the step, its grad and
    update halves over the rank's shards (:func:`rank_step_fns`, in
    :func:`world_microbatches`), the step
    run once on meta under the mock process groups (``timings["mock_s"]``,
    ``["aten_ops"]``), and on the card the kernel libraries and cuBLAS
    warmed in this thread. A process outside the world gets a handle with
    no functions."""
    from repro_torch.core.mock_groups import mock_warmup
    from repro_torch.distribution.step import check_rank_model

    check_rank_model(cfg, parallel)
    device = torch.device(device)
    handle = WorldHandle(parallel=parallel, devices=[device] * parallel.world_size, step_fn=None,
                         rank=groups.rank, rank_device=device, groups=groups)
    if not groups.member:
        return handle
    microbatches = world_microbatches(parallel, microbatches, global_batch)
    handle.step_fn, handle.grad_fn, handle.update_fn = rank_step_fns(cfg, parallel, opt_cfg, microbatches, groups)
    t0 = time.perf_counter()
    res = mock_warmup(lambda g: rank_step_fns(cfg, parallel, opt_cfg, microbatches, g)[0], parallel, groups.rank,
                      rank_meta_args(cfg, parallel, groups.rank, global_batch, seq_len))
    handle.timings.update(mock_s=time.perf_counter() - t0, aten_ops=res.aten_ops,
                          mock_collectives=len(res.collectives))
    t0 = time.perf_counter()
    if device.type == "cuda":
        warm_device(device, getattr(torch, cfg.dtype), train_kernels(cfg))
    handle.timings["warm_s"] = time.perf_counter() - t0
    return handle


def rank_state_buffers(specs, plan, parallel: ParallelConfig, rank: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Zeroed destination shards of rank ``rank`` of ``parallel`` (the
    plan's destination) for every tensor the plan moves bytes into on this
    rank; a tensor whose cells here are all resident is adopted at the
    commit and gets none."""
    from repro_torch.core.resource_view import view_of

    moved = {t.tensor for t in plan.tasks if t.dst_rank == rank and t.kind != "resident"}
    return {
        s.name: torch.zeros(view_of(s, parallel, rank).shape(), dtype=getattr(torch, s.dtype), device=device)
        for s in specs if s.name in moved
    }
