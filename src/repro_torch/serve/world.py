"""Serving world construction — the decode analogue of the JAX package's
``build_train_world``, returning a :class:`WorldHandle` so serving worlds
are first-class citizens of the warm :class:`WorldPool`:

  * ``step_fn``   — the batched decode step (one token per slot);
  * ``update_fn`` — the prefill (wave admission);
  * ``devices``   — the rank -> device list; with one card every rank maps
    to it, and the world's params and cache are global tensors there.

Serving worlds are pp=1; tp and dp vary across resizes. The build runs in a
ShadowBuilder thread during Prepare and does on the card what the first
step on the new world would otherwise pay: it loads the kernel libraries
(``nvcc`` first, if this process has not built them) and initialises CUDA
and cuBLAS on the world's device (the library loads and the context are
per process; PyTorch keeps a cuBLAS handle per thread). It allocates none of
the state: the reshard executor allocates the destination at commit.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.shadow import WorldHandle, warm_device, world_device

__all__ = ["build_serve_world"]


# the kernel libraries a serving world runs: either mixer's and the
# reshard data plane's
_SERVE_KERNELS = ("flash_attention", "flash_attention_tc", "ssd_scan", "reshard_pack")


def build_serve_world(
    cfg: ModelConfig,
    parallel: ParallelConfig,
    n_slots: int,
    prompt_len: int,
    max_seq: int,
    devices,
    cache_dtype=torch.float32,
) -> WorldHandle:
    """Synchronous serving-world construction (the shadow thread's body).
    ``devices`` is the rank -> device list (``parallel.world_size``
    entries, all one device). ``n_slots`` and ``prompt_len`` are kept for
    the JAX package's signature, where they shape the ahead-of-time
    compile; eager PyTorch compiles nothing ahead."""
    from repro_torch.models import model as M

    if parallel.pp != 1:
        raise ValueError(f"serving worlds are single-stage (pp=1), got {parallel.describe()}")
    devices = [torch.device(d) for d in devices]
    if len(devices) != parallel.world_size:
        raise ValueError(f"{len(devices)} devices for a world of {parallel.world_size} ranks")
    device = world_device(devices)
    timings: dict = {}
    t0 = time.perf_counter()
    if device.type == "cuda":
        warm_device(device, getattr(torch, cfg.dtype), _SERVE_KERNELS)
    timings["warm_s"] = time.perf_counter() - t0

    def step_fn(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache, tokens, pos)

    def prefill_fn(params, batch):
        return M.prefill(cfg, params, batch, cache_dtype=cache_dtype, max_seq=max_seq)

    return WorldHandle(
        parallel=parallel,
        devices=devices,
        step_fn=step_fn,
        timings=timings,
        update_fn=prefill_fn,
    )
