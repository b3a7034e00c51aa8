"""Mesh-aware sharding specs (twin of ``repro.pshard``).

Models name their parameters' and caches' sharding with *logical* axis
specs; ``resolve_spec`` resolves them against the installed mesh, dropping
axes the mesh does not have, so the same rules serve one device, a
(data, model) pod and a (pod, data, model) multi-pod mesh.

The installed mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or
None). Only its ``mesh_dim_names`` and ``shape`` are read, so specs resolve
at the production sizes on a fake process group, without a peer.
Placing tensors by these specs (DTensor) is not part of this module yet.
"""
from __future__ import annotations

import contextlib
import re

from repro_torch import tree

_MESH = None      # DeviceMesh or None
_MANUAL: tuple = ()  # axes the caller runs by hand (one process a pod)

# Logical batch axis: models name batch dims with the BATCH sentinel; 'tp'
# sharding resolves it to ('pod', 'data'), 'fsdp' and 'dp' to
# ('pod', 'data', 'model') (both mesh axes act data-parallel).
BATCH = "__batch__"
_BATCH_AXES: tuple = ("pod", "data")


class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or None) a tensor dim;
    compared as the tuple of its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def set_batch_axes(axes) -> None:
    global _BATCH_AXES
    _BATCH_AXES = tuple(axes)


def get_batch_axes() -> tuple:
    return _BATCH_AXES


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield
    finally:
        _MESH = prev


@contextlib.contextmanager
def manual_axes(axes):
    """Mark mesh axes as run by hand: specs drop them."""
    global _MANUAL
    prev, _MANUAL = _MANUAL, tuple(axes)
    try:
        yield
    finally:
        _MANUAL = prev


def _mesh_sizes() -> dict:
    if _MESH is None:
        return {}
    return dict(zip(_MESH.mesh_dim_names, _MESH.shape))


def _filter_axis(axis, names):
    if axis is None:
        return None
    if axis == BATCH:
        axis = _BATCH_AXES
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return axis if axis in names else None


def resolve_spec(*spec) -> PartitionSpec:
    """Drop spec axes that the installed mesh doesn't provide (or that are
    run by hand). A mesh axis may appear once: the first occurrence wins
    (e.g. fsdp batch = ('data', 'model') nulls a later 'model' head
    constraint)."""
    names = tuple(n for n in _mesh_sizes() if n not in _MANUAL)
    used: set = set()
    out = []
    for a in spec:
        f = _filter_axis(a, names)
        if f is None:
            out.append(None)
            continue
        fs = f if isinstance(f, tuple) else (f,)
        kept = tuple(x for x in fs if x not in used)
        used.update(kept)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return PartitionSpec(*out)


def _axis_size(ax) -> int:
    if ax is None or _MESH is None:
        return 1
    axes = ax if isinstance(ax, (tuple, list)) else (ax,)
    sizes = _mesh_sizes()
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def size_filter(spec: PartitionSpec, shape) -> PartitionSpec:
    """Drop spec axes whose mesh size doesn't divide the dim (e.g. 8 or 36
    heads against model = 16)."""
    out = []
    for i, ax in enumerate(spec):
        if i >= len(shape) or ax is None:
            out.append(ax if i < len(shape) else None)
            continue
        n = _axis_size(ax)
        out.append(ax if (n > 0 and shape[i] % n == 0 and shape[i] >= n)
                   else None)
    return PartitionSpec(*out)


# --------------------------------------------------------------------------- #
# Rule-based parameter sharding
# --------------------------------------------------------------------------- #

def spec_for_param(path: str, shape, rules) -> PartitionSpec:
    """First regex rule matching ``path`` wins; rules map pattern -> spec
    tuple. Axes that don't divide the dim are dropped (size_filter)."""
    for pat, spec in rules:
        if re.search(pat, path):
            cleaned = []
            for i, ax in enumerate(spec):
                if ax is None or i >= len(shape):
                    cleaned.append(None)
                    continue
                cleaned.append(ax)
            return size_filter(resolve_spec(*cleaned[: len(shape)]), shape)
    return resolve_spec(*([None] * len(shape)))


def tree_path_str(path) -> str:
    """A key path of ``repro_torch.tree`` as the rules match it:
    ``embed/embedding``."""
    return "/".join(str(p) for p in path)


def param_specs(params, rules):
    """Nested dict of PartitionSpec (mesh-filtered) for a param tree; the
    leaves need only a ``shape``: an init under ``FakeTensorMode`` gives
    the full-width shapes without allocating them."""
    paths, specs = [], []
    for path, leaf in tree.leaves_with_paths(params):
        paths.append(path)
        specs.append(spec_for_param(tree_path_str(path), tuple(leaf.shape),
                                    rules))
    return tree.unflatten(paths, specs)
