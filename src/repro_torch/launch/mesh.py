"""The production mesh, described without devices, and the hardware
constants of the card the port runs on: one NVIDIA H100 SXM.

:func:`make_production_mesh` is the counterpart of the JAX package's: the
same axis names and sizes, 16 x 16 (``data``, ``model``) for one pod and
2 x 16 x 16 (``pod``, ``data``, ``model``) for two, so that every dry-run
cell has a JAX counterpart to be held against. On H100s, 256 chips are 32
nodes of 8. A :class:`MeshSpec` holds names and sizes only: no device and
no process group; ``distribution/sharding.py`` reads it.

The constants come from NVIDIA's H100 data sheet (SXM part, dense rates
without sparsity, at the full 700 W power limit), and they feed the
topology search's roofline model (``core/topology_search.py``), the dry
run's roofline terms and the bounds ``chip_smoke.py`` prints.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
HBM_BYTES = 80e9  # HBM3 bytes per card
ICI_BW = 450e9  # NVLink 4 bytes/s per direction per card (900 GB/s both ways)
SM_COUNT = 132  # streaming multiprocessors of the SXM part


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, outermost first."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``, 1 where the mesh has no such axis."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def describe(self) -> str:
        """``pod16x16`` or ``pod2x16x16``, as the JAX dry run names its meshes."""
        return "pod" + "x".join(map(str, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))
