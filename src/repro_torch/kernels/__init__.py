"""Hand-written CUDA kernels for the compute hot spots, each with a
plain-torch version (``ref.py``) and device dispatch (``ops.py``). The
CUDA sources live in ``csrc/`` and are built at first use (``build.py``)."""
