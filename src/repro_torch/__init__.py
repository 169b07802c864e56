"""repro_torch: the PyTorch/CUDA port of the ``repro`` LiveR package.

The JAX package under ``src/repro/`` is the reference; this package mirrors
its module layout and parameter paths so each module has a counterpart
there. It imports ``torch`` and never ``jax`` or ``repro``. Entry points run
on the GPU (``device="cuda"``) unless the caller asks for the CPU.
"""

__version__ = "1.1.0"
