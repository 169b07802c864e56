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
ahead and a one-card world has no communicators, so neither has a
counterpart here.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig


def world_device(devices) -> torch.device:
    """The one device a world's ranks map to. Its state is held as global
    tensors there; placing ranks on several cards waits for the multi-card
    slice."""
    distinct = {torch.device(d) for d in devices}
    if len(distinct) != 1:
        raise ValueError(
            f"a world's ranks must all map to one device, got {sorted(map(str, distinct))} "
            "(placing ranks on several cards is not ported yet)"
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

    @property
    def device(self) -> torch.device:
        return world_device(self.devices)

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
    (the JAX package's ``ShapeDtypeStruct`` tree)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet (ROADMAP queue 1 item 10)"
        )
    return {"tokens": torch.empty((global_batch, seq_len), dtype=torch.long, device="meta")}


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
    libraries and cuBLAS warmed in this thread."""
    from repro_torch.distribution.step import make_grad_fn, make_train_step
    from repro_torch.models.transformer import check_trainable

    if parallel.pp != 1:
        raise NotImplementedError(
            f"{parallel.describe()}: pipeline stages are not ported yet (ROADMAP queue 1 item 5)"
        )
    devices = [torch.device(d) for d in devices]
    if len(devices) != parallel.world_size:
        raise ValueError(f"{len(devices)} devices for a world of {parallel.world_size} ranks")
    device = world_device(devices)
    check_trainable(cfg, device)  # an SSM mixer has no backward kernel on the card
    abstract_batch(cfg, global_batch, seq_len)  # refuses what the step cannot take
    timings: dict = {}
    t0 = time.perf_counter()
    if device.type == "cuda":
        warm_device(device, getattr(torch, cfg.dtype))
    timings["warm_s"] = time.perf_counter() - t0
    return WorldHandle(
        parallel=parallel,
        devices=devices,
        step_fn=make_train_step(cfg, opt_cfg, microbatches, remat, compression),
        timings=timings,
        update_fn=build_update_world_fn(cfg, parallel, opt_cfg, compression),
        grad_fn=make_grad_fn(cfg, microbatches, remat, device),
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
