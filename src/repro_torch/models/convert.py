"""Carry the JAX package's parameters into the port.

Torch cannot reproduce JAX's threefry draws, so tests that hold the port
against ``repro.models.model`` give both the same weights: the JAX params
flattened by ``repro.utils.pytree.tree_paths`` and converted with
``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import param_shapes
from repro_torch.utils.pytree import tree_from_paths


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch mapping
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def params_from_jax(flat: dict, cfg: ModelConfig, device, dtype: torch.dtype | None = None) -> dict:
    """``{a/b/c path: array}`` from the JAX package -> the port's param tree
    on ``device`` (in ``dtype`` when given, else the arrays' own dtype).

    Raises ``ValueError`` unless the paths and every shape equal what
    :func:`repro_torch.models.model.init_params` builds for ``cfg``.
    """
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    bad = sorted(
        f"{p}: {tuple(np.shape(flat[p]))} != {want[p]}"
        for p in set(want) & set(flat)
        if tuple(np.shape(flat[p])) != want[p]
    )
    if missing or extra or bad:
        raise ValueError(
            f"params do not match {cfg.name}: missing {missing}, extra {extra}, mis-shaped {bad}"
        )
    out = {}
    for path, a in flat.items():
        x = _to_tensor(a)
        out[path] = x.to(device=device, dtype=dtype or x.dtype)
    return tree_from_paths(out)
