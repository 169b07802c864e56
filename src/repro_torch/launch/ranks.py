"""Spawn a pool of rank processes over ``torch.distributed``.

    from repro_torch.launch.ranks import run_ranks
    results = run_ranks(program, 4, *args, device="cuda")

:func:`run_ranks` starts ``nproc`` processes (``torch.multiprocessing``,
``spawn``), each joining one default group at a ``file://`` store in the
call's own temporary directory, and calls ``program(rank, *args)`` in
each; it returns the
ranks' return values in rank order (saved with ``torch.save`` in the
child and loaded here, so tensors cross as bytes). ``program`` must be a
module-level function; its arguments cross to the ranks as one
``torch.save`` file in a temporary directory (through the spawn pipe, a
process's start would wait until the one before it had read them). The
backend is gloo on the CPU and wherever ranks share a card, nccl where
every rank has a card of its own; on a card every rank of the pool maps to
``cuda:<rank % device_count>``. A rank that raises, or dies, makes the
call raise and stops the others (each failing rank prints its traceback
at once, and a stopped rank where its threads were); a call that outlasts
``timeout`` seconds stops every rank and raises ``TimeoutError``.

No TCP port is chosen before the ranks start: the store is a file that
only this call's ranks know, and gloo's (or nccl's) own connections bind
the ports the system gives them, so worlds started at once on one host
cannot take each other's rendezvous.
"""

from __future__ import annotations

import faulthandler
import io
import os
import signal
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["rank_device", "run_ranks"]


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank`` in a pool on ``device``: the CPU, or card
    ``rank % device_count`` (every rank on one card shares it)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _blob(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _unblob(blob: bytes):
    return torch.load(io.BytesIO(blob), weights_only=False)


def _entry(rank: int, program: Callable, nproc: int, store: str, device: str, threads: int, args: str, queue) -> None:
    torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" and nproc <= torch.cuda.device_count() else "gloo"
    # a rank stopped by its peers' failure prints where each of its threads was
    faulthandler.register(signal.SIGTERM, chain=True)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=nproc)
    try:
        result = program(rank, *torch.load(args, weights_only=False))
        queue.put((rank, _blob(result)))
        dist.barrier()  # no rank leaves while a peer may still talk to it
    except BaseException:
        # printed at once: the peers' errors that follow from this one may
        # be the first the parent sees
        print(f"[rank {rank}] failed:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(program: Callable, nproc: int, *args, device="cpu", threads: int = 1,
              timeout: Optional[float] = None) -> list:
    """``program(rank, *args)`` in ``nproc`` rank processes; their return
    values in rank order (the module docstring)."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    tmp = tempfile.TemporaryDirectory(prefix="ranks_")
    path = os.path.join(tmp.name, "args.pt")
    torch.save(args, path)
    store = os.path.join(tmp.name, "store")
    procs = mp.start_processes(_entry, args=(program, nproc, store, str(device), threads, path, queue),
                               nprocs=nproc, join=False, start_method="spawn")
    results: dict[int, bytes] = {}
    t0 = time.monotonic()
    try:
        while True:
            while not queue.empty():
                rank, blob = queue.get()
                results[rank] = blob
            if procs.join(timeout=0.05):
                break
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"rank processes still running after {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join()
        tmp.cleanup()
    while not queue.empty():
        rank, blob = queue.get()
        results[rank] = blob
    missing = sorted(set(range(nproc)) - set(results))
    if missing:
        raise RuntimeError(f"ranks {missing} returned nothing")
    return [_unblob(results[r]) for r in range(nproc)]
