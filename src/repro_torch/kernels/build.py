"""Build and load the CUDA kernels of this package.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. The
build runs at first use, into ``kernels/_build/`` (listed in
``.gitignore``), and the library's name carries a hash of the sources and
flags, so an edit rebuilds and an unchanged tree loads what is there.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on PATH "
        "(the CUDA kernels of repro_torch are compiled at first use)"
    )


def source_hash(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, the headers beside it (``csrc/*.cuh``)
    and the flags: the key of the built library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_hash(name)}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    log = out.with_suffix(".log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, log


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every source that is not built yet, one ``nvcc`` each, all
    started together. Returns ``{name: library path}``; raises with the
    compiler's output if a build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        failed = []
        for name, job in jobs.items():
            if job is None:
                continue
            proc, tmp, log = job
            if proc.wait() != 0:
                failed.append(f"--- {name} ---\n{log.read_text()}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, library_path(name))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for the current build of ``name``
    (registers, shared memory, spills); empty if it was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]
