"""Manifest-based checkpointing over torch tensors.

The port of ``repro/checkpoint/ckpt.py``, with the same on-disk format, so
that a checkpoint one package writes, the other loads:

* ``save_checkpoint`` writes one ``.npy`` per leaf, named by its sanitised
  ``a/b/c`` path, and a ``manifest.json`` (step, shapes, dtypes, files)
  into ``step_<step>.tmp``, then publishes it by one rename to
  ``step_<step>``. Tensors are written whole (the global logical layout),
  so loading under any parallel configuration is a plain read.
* ``load_checkpoint`` memory-maps each file and copies the leaf straight
  to the device, or into the caller's live tensors (``in_place=True``),
  one leaf at a time: a restore never holds a second state beside the
  first.
* ``AsyncCheckpointer`` snapshots to host memory in the caller's thread,
  synchronously (the optimizer updates the state in place, so a snapshot
  that shared its storage would change under the writer), and writes in a
  non-daemon thread; a write's failure surfaces at the next ``save`` or
  ``wait``.

A per-rank world (``core/rank_controller.py``) saves in the same format:
no process holds a whole tensor, so ``save_rank_checkpoint`` is collective
over the rank pool. Rank 0 creates every leaf's file at its global shape
(``np.lib.format.open_memmap``) and the step count's; the first rank of
each distinct view writes that view's region into the memory-mapped file;
once every rank's writes are agreed done, rank 0 writes the manifest and
publishes the directory by the one rename, so the JAX package's loader and
``load_checkpoint`` read it as any other. ``load_rank_checkpoint`` memory-
maps the files and copies only this rank's view of each leaf in the
target world, into the rank's live tensor where its view is unchanged.
``RankCheckpointer`` saves so, synchronously, on the training thread at a
step boundary: no collective runs on a second thread.

bfloat16 needs no ``ml_dtypes``: a bf16 leaf is stored as its 16-bit
pattern (``uint16``) under the manifest's dtype ``"bfloat16"``, and a
``"bfloat16"`` entry is read back as raw 16-bit items whatever dtype the
file declares (the JAX package's files declare a 2-byte void where
``ml_dtypes`` is not loaded).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.resource_view import dtype_name, view_of
from repro_torch.utils.pytree import tree_from_paths, tree_paths

MANIFEST = "manifest.json"


def _sanitize(path: str) -> str:
    return path.replace("/", "__")


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of a leaf as the numpy array written to disk (bf16 as
    its bit pattern), and its dtype name: a copy, never a view of a live
    CPU tensor."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf, copy=True)
        return arr, str(arr.dtype)
    x = leaf.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return x.numpy(), dtype_name(x.dtype)


def _write(step_dir: str, step: int, leaves, extra: Optional[dict]) -> None:
    """Write (path, array, dtype) leaves and the manifest into
    ``step_dir.tmp``, then publish it by one rename."""
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    manifest = {"step": step, "tensors": {}, "extra": extra or {}}
    for path, arr, dtype in leaves:
        fname = _sanitize(path) + ".npy"
        np.save(os.path.join(tmp_dir, fname), arr)
        manifest["tensors"][path] = {"shape": list(arr.shape), "dtype": dtype, "file": fname}
    with open(os.path.join(tmp_dir, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)  # atomic publish


def save_checkpoint(ckpt_dir: str, step: int, state: Any, extra: Optional[dict] = None) -> float:
    """Synchronous save, one leaf on the host at a time. Returns seconds
    spent."""
    t0 = time.perf_counter()
    leaves = ((path, *_host(leaf)) for path, leaf in tree_paths(state).items())
    _write(_step_dir(ckpt_dir, step), step, leaves, extra)
    return time.perf_counter() - t0


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _read(step_dir: str, meta: dict) -> torch.Tensor:
    """One leaf from its file, as a CPU tensor over the memory map (no
    copy of the file's bytes is made here)."""
    arr = np.load(os.path.join(step_dir, meta["file"]), mmap_mode="c")
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr))


def load_checkpoint(
    ckpt_dir: str,
    like: Any,
    step: Optional[int] = None,
    device=None,
    in_place: bool = False,
) -> tuple[Any, int, float]:
    """Load the leaves ``like`` names (its paths; a leaf's dtype is the
    one loaded, cast where the file's differs). Returns (state, step,
    seconds).

    Each leaf is copied from its memory-mapped file straight to ``device``
    (default the CPU) as a new tensor or, with ``in_place=True``, into the
    tensor ``like`` holds at its path (the live state), and the state
    returned is ``like``'s tree. Either way one leaf at a time."""
    t0 = time.perf_counter()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step_dir = _step_dir(ckpt_dir, step)
    with open(os.path.join(step_dir, MANIFEST)) as f:
        manifest = json.load(f)
    out = {}
    for path, leaf in tree_paths(like).items():
        src = _read(step_dir, manifest["tensors"][path])
        if in_place:
            out[path] = leaf.copy_(src)
        else:
            dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else getattr(torch, str(np.asarray(leaf).dtype))
            out[path] = src.to(device=device or "cpu", dtype=dtype, copy=True)
    for d in {x.device for x in out.values() if x.device.type == "cuda"}:
        torch.cuda.synchronize(d)
    return tree_from_paths(out), step, time.perf_counter() - t0


class AsyncCheckpointer:
    """Overlapped checkpointing: the snapshot to host inline, the disk
    write in a background thread. ``last_snapshot_seconds`` and
    ``last_save_seconds`` time the two halves of the last save."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_snapshot_seconds: Optional[float] = None
        self.last_save_seconds: Optional[float] = None

    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        host = [(path, *_host(leaf)) for path, leaf in tree_paths(state).items()]
        self.last_snapshot_seconds = time.perf_counter() - t0
        step_dir = _step_dir(self.ckpt_dir, step)

        def write():
            t0 = time.perf_counter()
            try:
                _write(step_dir, step, host, extra)
                self.last_save_seconds = time.perf_counter() - t0
            except BaseException as e:  # surfaced at the next save()/wait()
                self._error = e
                shutil.rmtree(step_dir + ".tmp", ignore_errors=True)

        # non-daemon: a daemon writer killed at interpreter exit leaves a
        # truncated .tmp dir and no published step; Python joins
        # non-daemon threads, so the atomic rename always completes
        self._thread = threading.Thread(target=write, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write; re-raise its failure here (not in the
        writer thread, where it would vanish). A raised error means the step
        being written is NOT durable: an older published step may be."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write to {self.ckpt_dir} failed; the latest published step (if any) is older"
            ) from err


# ---------------------------------------------------------------------------
# Per-rank worlds
# ---------------------------------------------------------------------------

COUNT_PATH = "opt/count"


def state_path(name: str) -> str:
    """The checkpoint path of a resource-view tensor name: ``params/...``
    as it is, a moment ``mu/...`` / ``nu/...`` under ``opt/``."""
    return name if name.startswith("params/") else "opt/" + name


def _np_dtype(dtype: str):
    return np.dtype(np.uint16) if dtype == "bfloat16" else np.dtype(dtype)


def _region(spec, parallel, rank: int):
    """(this rank's view of ``spec`` in ``parallel`` or None, whether this
    rank is the first of the ranks holding that view)."""
    if rank >= parallel.world_size:
        return None, False
    view = view_of(spec, parallel, rank)
    if view is None:
        return None, False
    first = min(r for r in range(parallel.world_size) if (v := view_of(spec, parallel, r)) is not None and v == view)
    return view, first == rank


def _agreed(pool, err: Optional[BaseException], what: str) -> None:
    """Raise on every rank of the pool when ``err`` is set on any: a rank
    that raised alone would leave the others waiting in the next
    collective."""
    if pool.agree(0.0 if err is not None else 1.0, "min") < 1.0:
        raise OSError(f"per-rank checkpoint: {what} failed on a rank") from err


def save_rank_checkpoint(ckpt_dir: str, step: int, named: dict, count: int, specs, parallel, pool) -> tuple[float, float]:
    """Save ``parallel``'s state from every rank of ``pool`` (call on each):
    ``named`` this rank's shards by tensor name (empty outside the world),
    ``count`` the step count. Returns (seconds, of them those the shards
    took to reach the host). Raises ``OSError`` on every rank when any
    failed; nothing is published then."""
    t0 = time.perf_counter()
    step_dir = _step_dir(ckpt_dir, step)
    tmp = step_dir + ".tmp"
    files = {s.name: os.path.join(tmp, _sanitize(state_path(s.name)) + ".npy") for s in specs}
    err = None
    if pool.rank == 0:
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for s in specs:
                np.lib.format.open_memmap(files[s.name], mode="w+", dtype=_np_dtype(s.dtype), shape=tuple(s.shape))
            np.save(os.path.join(tmp, _sanitize(COUNT_PATH) + ".npy"), np.asarray(count, dtype=np.int32))
        except Exception as e:
            err = e
    _agreed(pool, err, "creating the files")
    host_s = 0.0
    try:
        for s in specs:
            view, first = _region(s, parallel, pool.rank)
            if not first:
                continue
            t1 = time.perf_counter()
            arr, _ = _host(named[s.name])
            host_s += time.perf_counter() - t1
            mm = np.load(files[s.name], mmap_mode="r+")
            mm[tuple(slice(lo, hi) for lo, hi in view.bounds)] = arr
            mm.flush()
            del mm, arr
    except Exception as e:
        err = e
    _agreed(pool, err, "writing the regions")
    if pool.rank == 0:
        try:
            manifest = {"step": step, "tensors": {}, "extra": {}}
            for s in specs:
                manifest["tensors"][state_path(s.name)] = {
                    "shape": list(s.shape), "dtype": s.dtype, "file": os.path.basename(files[s.name])}
            manifest["tensors"][COUNT_PATH] = {"shape": [], "dtype": "int32", "file": _sanitize(COUNT_PATH) + ".npy"}
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(step_dir):
                shutil.rmtree(step_dir)
            os.rename(tmp, step_dir)  # atomic publish
        except Exception as e:
            err = e
    _agreed(pool, err, "publishing")
    return time.perf_counter() - t0, host_s


def load_rank_checkpoint(ckpt_dir: str, specs, parallel, pool, device, live: Optional[dict] = None
                         ) -> tuple[dict, int, int, float]:
    """This rank's views in ``parallel`` of the latest step every rank of
    ``pool`` sees (call on each): (tensors by name, the step count, the
    step, seconds). A view is copied from the memory-mapped file into
    ``live``'s tensor of the same name where its shape and dtype match, into
    a new tensor on ``device`` otherwise. Raises on every rank when the
    ranks see different steps or any rank fails."""
    t0 = time.perf_counter()
    seen = latest_step(ckpt_dir)
    seen = -1 if seen is None else seen
    if pool.agree(seen, "min") != pool.agree(seen, "max") or seen < 0:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir} that every rank sees")
    step_dir = _step_dir(ckpt_dir, seen)
    live = live or {}
    out, count, err = {}, 0, None
    try:
        with open(os.path.join(step_dir, MANIFEST)) as f:
            manifest = json.load(f)
        for s in specs:
            view, _ = _region(s, parallel, pool.rank)
            if view is None:
                continue
            src = _read(step_dir, manifest["tensors"][state_path(s.name)])[tuple(slice(lo, hi) for lo, hi in view.bounds)]
            dst = live.get(s.name)
            if dst is None or tuple(dst.shape) != view.shape() or dtype_name(dst.dtype) != s.dtype:
                dst = torch.empty(view.shape(), dtype=getattr(torch, s.dtype), device=device)
            out[s.name] = dst.copy_(src)
        count = int(_read(step_dir, manifest["tensors"][COUNT_PATH]))
    except Exception as e:
        err = e
    _agreed(pool, err, "reading the checkpoint")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out, count, seen, time.perf_counter() - t0


class RankCheckpointer:
    """The checkpointer of a per-rank world: ``save`` is
    :func:`save_rank_checkpoint`, synchronous and collective (every rank
    saves at the same step); ``state()`` gives (this rank's shards by name,
    the step count, the world's ``ParallelConfig``). ``last_snapshot_seconds``
    and ``last_save_seconds`` time the shards' copies to the host and the
    whole save."""

    def __init__(self, ckpt_dir: str, pool, specs, state):
        self.ckpt_dir = ckpt_dir
        self.pool = pool
        self.specs = list(specs)
        self.state = state
        self.last_snapshot_seconds: Optional[float] = None
        self.last_save_seconds: Optional[float] = None

    def save(self, step: int, state: Any = None) -> None:
        """``state`` is ignored: each rank saves what ``state()`` gives."""
        named, count, parallel = self.state()
        self.last_save_seconds, self.last_snapshot_seconds = save_rank_checkpoint(
            self.ckpt_dir, step, named, count, self.specs, parallel, self.pool)

    def wait(self) -> None:
        """Every save has ended when it returns."""
