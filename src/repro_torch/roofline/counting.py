"""The dry run's counting mode: FLOPs, bytes and peak live bytes read off
one execution of a step on the meta device.

The port runs eagerly, op by op, so what its aten ops read and write is
what the card moves. One execution under :func:`count` gives:

- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` (the matrix
  products, convolutions and attention ops it has formulas for), plus the
  kernels' own records (``kernels/work.py``): a meta route runs no aten op
  that does the work;
- **bytes**: the input and output bytes of every aten op, leaving out
  views and metadata ops (which move nothing) and factory ops that only
  allocate, plus the kernels' records;
- **peak live bytes**: a liveness tracker over storages. Each storage an op
  creates counts from its creation until it is freed (a finaliser on the
  storage); an op's output on one of its inputs' storages (a view, an
  in-place op, a cast to the same dtype) creates none. Tensors created
  before the step (the state) are not seen, so the peak is the step's own
  above them, what ``MemTracker`` calls the non-external part.

Nothing here needs a device: on meta every op allocates nothing and
runs in microseconds.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import work

_aten = torch.ops.aten
# ops that allocate or read metadata and move no bytes
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._local_scalar_dense.default,
    _aten.lift_fresh.default, _aten.set_.source_Storage_storage_offset, _aten.resize_.default,
    _aten.sym_size.int, _aten.sym_stride.int, _aten.sym_numel.default, _aten.sym_storage_offset.default,
    _aten.is_same_size.default, _aten._has_compatible_shallow_copy_type.default,
}


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _BytesAndLive(TorchDispatchMode):
    """Sums the bytes each op reads and writes, and tracks the bytes of the
    storages ops create while they live."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: weakref.WeakSet = weakref.WeakSet()

    def _freed(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        # an output on an input's storage (a view, an in-place op, a no-op
        # cast) allocates nothing; nor does one on a storage already counted
        in_storages = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in in_storages or st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, n)
        if not (func.is_view or func in _NO_BYTES):
            self.bytes += sum(map(_tensor_bytes, ins)) + sum(map(_tensor_bytes, outs))
        return out


@dataclass
class StepCount:
    """What one execution of a step did, summed over all its ops."""

    flops: int  # aten_flops + kernel_flops
    bytes: int  # aten_bytes + kernel_bytes
    peak_bytes: int  # the step's own live bytes at their peak
    aten_flops: int
    aten_bytes: int
    kernel_flops: int
    kernel_bytes: int
    ops: int
    seconds: float  # host time of the counted execution
    kernels: dict = field(default_factory=dict)  # name -> {"launches", "flops", "bytes"}

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counters; returns (its
    result, :class:`StepCount`)."""
    t0 = time.perf_counter()
    with work.recording() as records, FlopCounterMode(display=False) as flop_mode, _BytesAndLive() as mode:
        result = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    kernels: dict = {}
    for r in records:
        k = kernels.setdefault(r.name, {"launches": 0, "flops": 0, "bytes": 0})
        k["launches"] += 1
        k["flops"] += r.flops
        k["bytes"] += r.bytes
    aten_flops = int(flop_mode.get_total_flops())
    kernel_flops = sum(r.flops for r in records)
    kernel_bytes = sum(r.bytes for r in records)
    return result, StepCount(
        flops=aten_flops + kernel_flops, bytes=mode.bytes + kernel_bytes, peak_bytes=mode.peak,
        aten_flops=aten_flops, aten_bytes=mode.bytes, kernel_flops=kernel_flops, kernel_bytes=kernel_bytes,
        ops=mode.ops, seconds=seconds, kernels=kernels,
    )
