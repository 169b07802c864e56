"""Host and device calibration for the simulator (paper §5 'Simulator
Calibration').

The port's counterpart of the JAX package's ``sim/calibrate.py``, rewritten
over torch and the device it is given. It measures on THIS machine and
caches the constants as JSON at ``cache`` (by default
``results/calibration_torch.json`` at the repo root, never the JAX
package's ``results/calibration.json``). Keys kept from the JAX module,
with their meaning:

- ``proc_spawn_s``: a fresh interpreter that does nothing;
- ``memcpy_gbps``: a 64 MiB host copy, by the JAX formula (bytes per
  second / 1e9, times 8).

In place of jax's import and XLA's compiles (the port compiles nothing
ahead of time; eager PyTorch has no compile step):

- ``torch_cuda_init_s``: a fresh process that imports torch and makes its
  first launch on the device;
- ``h2d_gbps``, ``d2h_gbps`` (pinned host memory on the card) and
  ``d2d_gbps``: 64 MiB copies, bytes per second / 1e9;
- ``kernel_load_s``: loading every built kernel library in a fresh process
  (``kernels/build.py``; on the CPU no library is built, and it is the
  import of the kernel wrappers);
- ``build_base_s`` and ``build_scale``: a cold ``core/shadow.py::
  build_train_world`` (the first of a fresh process, on the device) of a
  reduced config at d_model 256, and what d_model 1024 adds (at least 1e-3,
  as ``compile_scale``), the counterpart of ``compile_base_s`` /
  ``compile_scale``.

``device`` defaults to the card; the record names the device it measured
(``"device"``), so that a CPU figure is never read as the card's. No
``ClusterModel`` preset is built from it yet.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[2]
CACHE = str(SRC.parent / "results" / "calibration_torch.json")
KEYS = ("proc_spawn_s", "torch_cuda_init_s", "memcpy_gbps", "h2d_gbps", "d2h_gbps", "d2d_gbps",
        "kernel_load_s", "build_base_s", "build_scale")
COPY_BYTES = 64 * 1024 * 1024
PROBE_WIDTHS = (256, 1024)

# A fresh process's cold train-world build: it starts the device, loads
# every built kernel library, then builds one world; prints its timings.
_BUILD_PROBE = """
import dataclasses, json, sys, time
import torch
dev = torch.device(sys.argv[1])
torch.ones(1, device=dev).sum().item()
t0 = time.perf_counter()
from repro_torch.kernels import build, ops  # noqa: F401
if dev.type == "cuda":
    for name in sorted(p.stem for p in build.CSRC.glob("*.cu")):
        build.load(name)
load_s = time.perf_counter() - t0
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.shadow import build_train_world
from repro_torch.optim import AdamWConfig
cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), d_model=int(sys.argv[2]))
t0 = time.perf_counter()
build_train_world(cfg, ParallelConfig(dp=1, tp=1), AdamWConfig(), 8, 64, devices=[dev])
print(json.dumps({"kernel_load_s": load_s, "build_s": time.perf_counter() - t0}))
"""


def _wall(args: list[str], env=None) -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, *args], check=True, env=env, capture_output=True)
    return time.perf_counter() - t0


def _copy_gbps(dst: torch.Tensor, src: torch.Tensor, reps: int = 5) -> float:
    """The median rate of ``dst.copy_(src)`` over ``reps`` copies, after one
    warm-up, each ended by a synchronise on a card."""
    sync = torch.cuda.synchronize if dst.is_cuda or src.is_cuda else (lambda: None)
    dst.copy_(src)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        sync()
        times.append(time.perf_counter() - t0)
    return src.numel() * src.element_size() / statistics.median(times) / 1e9


def _measure(device: torch.device) -> dict:
    out: dict = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))

    # process spawn + interpreter boot
    out["proc_spawn_s"] = _wall(["-c", "pass"])

    # torch import + the device's first launch in a fresh process
    out["torch_cuda_init_s"] = _wall(
        ["-c", f"import torch; torch.ones(1, device={str(device)!r}).sum().item()"], env)

    # host memcpy bandwidth (the staging-buffer assemble cost), the JAX formula
    buf = np.random.default_rng(0).random(COPY_BYTES // 8)
    t0 = time.perf_counter()
    for _ in range(4):
        _ = buf.copy()
    dt = (time.perf_counter() - t0) / 4
    out["memcpy_gbps"] = buf.nbytes / dt / 1e9 * 8

    # host <-> device and device copies
    pin = device.type == "cuda"
    host = torch.ones(COPY_BYTES // 4, dtype=torch.float32, pin_memory=pin)
    dev = torch.empty(COPY_BYTES // 4, dtype=torch.float32, device=device)
    out["h2d_gbps"] = _copy_gbps(dev, host)
    out["d2h_gbps"] = _copy_gbps(host, dev)
    out["d2d_gbps"] = _copy_gbps(torch.empty_like(dev), dev)
    del host, dev

    # kernel libraries and a cold train-world build at two widths
    probes = []
    for width in PROBE_WIDTHS:
        res = subprocess.run([sys.executable, "-c", _BUILD_PROBE, str(device), str(width)], check=True,
                             env=env, capture_output=True, text=True)
        probes.append(json.loads(res.stdout.strip().splitlines()[-1]))
    out["kernel_load_s"] = probes[0]["kernel_load_s"]
    out["build_base_s"] = probes[0]["build_s"]
    out["build_scale"] = max(probes[1]["build_s"] - probes[0]["build_s"], 1e-3)
    return out


def measure(force: bool = False, cache: str = CACHE, device="cuda") -> dict:
    """The calibration constants of this machine on ``device``: read from
    ``cache`` unless ``force`` or it is missing, else measured and written
    there. A device that is not there raises (no fall-back to the CPU)."""
    if not force and os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("calibrate: no CUDA device (pass device='cpu' to measure the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    out = _measure(device)
    os.makedirs(os.path.dirname(os.path.abspath(cache)), exist_ok=True)
    with open(cache, "w") as f:
        json.dump(out, f, indent=2)
    return out
