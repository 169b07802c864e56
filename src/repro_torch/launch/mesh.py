"""Hardware constants of the card the port runs on: one NVIDIA H100 SXM.

The JAX package's ``launch/mesh.py`` holds a TPU v5e's constants and the
production mesh. A one-card world has no mesh, so only the constants have
a counterpart. They come from NVIDIA's H100 data sheet (SXM part, dense
rates without sparsity, at the full 700 W power limit), and they feed the
topology search's roofline model (``core/topology_search.py``) and the
bounds ``chip_smoke.py`` prints.
"""

from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
HBM_BYTES = 80e9  # HBM3 bytes per card
ICI_BW = 450e9  # NVLink 4 bytes/s per direction per card (900 GB/s both ways)
