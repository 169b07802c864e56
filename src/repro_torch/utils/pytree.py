"""Path helpers for parameter and cache trees.

The port keeps parameters as plain nested dicts of tensors (or numpy
arrays), like the JAX package. Leaves are named by ``a/b/c`` path strings,
the same names ``repro.utils.pytree.tree_paths`` gives: dict keys are
visited in sorted order, as ``jax.tree_util`` visits them.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten nested dicts into ``{"a/b/c": leaf}``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        out.update(tree_paths(tree[key], path))
    return out


def tree_from_paths(paths: dict[str, Any]) -> dict:
    """Rebuild nested dicts from ``{"a/b/c": leaf}``."""
    root: dict = {}
    for path, leaf in paths.items():
        node = root
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return root


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> dict:
    """Apply ``fn(path, leaf)`` to every leaf, keeping the structure."""
    return tree_from_paths({p: fn(p, leaf) for p, leaf in tree_paths(tree).items()})
