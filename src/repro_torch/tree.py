"""Nested-dict parameter trees in JAX's leaf order.

JAX flattens a dict by its sorted keys, recursively, so the reference's flat
vectors, wire payloads and per-leaf random draws all follow that order. Every
walk over a parameter tree in the port goes through here, never through
insertion or ``state_dict`` order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(key path, leaf)] in sorted-key order; a non-dict is one leaf."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    for k in sorted(tree):
        out.extend(leaves_with_paths(tree[k], prefix + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(paths: List[Path], values: list):
    """Inverse of ``leaves_with_paths``: nested dicts from (path, value)."""
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    root: dict = {}
    for path, v in zip(paths, values):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return root


def tree_map(fn: Callable, tree, *rest):
    """``jax.tree.map`` over nested dicts: ``fn`` sees leaves in sorted-key
    order (the order that numpy draws inside ``fn`` must follow)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)
