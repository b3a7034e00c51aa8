"""Mesh-aware sharding specs (twin of ``repro.pshard``).

Models name their parameters' and caches' sharding with *logical* axis
specs; ``resolve_spec`` resolves them against the installed mesh, dropping
axes the mesh does not have, so the same rules serve one device, a
(data, model) pod and a (pod, data, model) multi-pod mesh.

The installed mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or
None). Specs resolve from its ``mesh_dim_names`` and ``shape`` alone, so
they resolve at the production sizes on a fake process group, without a
peer. A resolved spec turns into DTensor placements (``placements``): mesh
dim j gets ``Shard(i)`` when spec entry i names its axis, ``Replicate()``
otherwise; ``distribute_params`` places a param tree by its rules and
``constrain`` redistributes an activation, the counterpart of the
reference's ``with_sharding_constraint``. On a plain tensor, or with no
mesh installed, ``constrain`` returns its argument itself.
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


# --------------------------------------------------------------------------- #
# DTensor placements
# --------------------------------------------------------------------------- #

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements(spec, mesh=None) -> tuple:
    """A resolved spec -> one placement a mesh dim: ``Shard(i)`` where
    entry i names the dim's axis, ``Replicate()`` elsewhere (and on a mesh
    dim of size 1, where the two hold the same). A tuple of axes on one
    dim must follow the mesh's order (DTensor shards a dim over several
    mesh dims major to minor, as ``NamedSharding`` does)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _MESH if mesh is None else mesh
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: axes {axes} of dim {i} "
                             f"out of the mesh's order {names}")
        for j in idx:
            if mesh.size(j) > 1:
                out[j] = Shard(i)
    return tuple(out)


def named_sharding(*spec):
    """(mesh, placements) of a logical spec on the installed mesh; None
    with no mesh."""
    if _MESH is None:
        return None
    return _MESH, placements(resolve_spec(*spec))


def submesh(mesh, drop=("pod",)):
    """``mesh`` without the dims named in ``drop`` (the (data, model)
    submesh a pod's model runs on)."""
    names = tuple(mesh.mesh_dim_names)
    kept = tuple(n for n in names if n not in drop)
    return mesh if kept == names else mesh[kept]


def param_shardings(params, rules):
    """Nested dict of (mesh, placements) for a param tree by its rules;
    None leaves with no mesh installed."""
    paths, out = [], []
    for path, leaf in tree.leaves_with_paths(params):
        paths.append(path)
        if _MESH is None:
            out.append(None)
            continue
        mesh = submesh(_MESH, _MANUAL)
        spec = spec_for_param(tree_path_str(path), tuple(leaf.shape), rules)
        out.append((mesh, placements(spec, mesh)))
    return tree.unflatten(paths, out)


def distribute_params(params, rules):
    """A param tree placed on the installed mesh as DTensors by its rules
    (each leaf's full value on every rank in, its shard kept)."""
    from torch.distributed.tensor import distribute_tensor
    if _MESH is None:
        return params
    paths, leaves = zip(*tree.leaves_with_paths(params))
    shard = tree.leaves(param_shardings(params, rules))
    return tree.unflatten(list(paths), [
        distribute_tensor(x, mesh, pl) for x, (mesh, pl) in zip(leaves, shard)])


def local_shape_and_offset(shape, mesh, pl):
    """(local shape, global offset) of a tensor of ``shape`` placed by
    ``pl`` at this rank's coordinate of ``mesh``: each ``Shard(d)`` splits
    what the mesh dims before it left of dim d into ``torch.chunk``
    pieces (DTensor's layout). Reads only the mesh's coordinate, so it
    runs under a fake mode too."""
    coord = mesh.get_coordinate()
    shape, off = list(shape), [0] * len(shape)
    for j, p in enumerate(pl):
        if not p.is_shard():
            continue
        d, n = p.dim, mesh.size(j)
        size = -(-shape[d] // n)
        off[d] += min(coord[j] * size, shape[d])
        shape[d] = max(0, min(size, shape[d] - coord[j] * size))
    return tuple(shape), tuple(off)


def from_replicated(x, mesh, pl):
    """A plain tensor holding the full value on every rank as a DTensor
    placed by ``pl`` (each rank keeps its shard; no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    full = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, pl)


def dtensor_context(tensors):
    """Where any of ``tensors`` (a tree or list) is a DTensor:
    ``implicit_replication`` (the plain tensors a model makes as it runs,
    positions, masks, zero states, take part as replicated) and, if no
    mesh is installed, its mesh installed (so ``constrain`` acts); else a
    no-op context."""
    dts = [t for t in tree.leaves(tensors) if _is_dtensor(t)] \
        if isinstance(tensors, dict) else \
        [t for t in tensors if _is_dtensor(t)]
    stack = contextlib.ExitStack()
    if dts:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        stack.enter_context(implicit_replication())
        if _MESH is None:
            stack.enter_context(use_mesh(dts[0].device_mesh))
    return stack


def spec_placements(shape, mesh, *spec) -> tuple:
    """The placements of a logical spec for a tensor of ``shape`` on
    ``mesh``: resolved, size-filtered."""
    with use_mesh(mesh):
        return placements(size_filter(resolve_spec(*spec), shape), mesh)


def place_as(x, mesh, pl):
    """``x`` as a DTensor on ``mesh`` with placements ``pl``: a DTensor
    redistributed, a plain tensor (the same full value on every rank)
    sharded without communication."""
    pl = tuple(pl)
    if not _is_dtensor(x):
        return from_replicated(x, mesh, pl)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


def place(x, mesh, *spec):
    """``place_as`` by a logical spec."""
    return place_as(x, mesh, spec_placements(x.shape, mesh, *spec))


def constrain(x, *spec):
    """Redistribute a DTensor to the resolved, size-filtered spec on its
    mesh (a Partial -> Replicate is the all-reduce, Partial -> Shard the
    reduce-scatter). A plain tensor, or no installed mesh: ``x`` itself."""
    if _MESH is None or not _is_dtensor(x):
        return x
    return place(x, x.device_mesh, *spec)


def grad_placements(pl, sharded_dims) -> tuple:
    """The placements of a ``local_map`` input's gradient: Partial on a
    mesh dim where the input is replicated but the shards compute on
    different data (``sharded_dims``), the input's own elsewhere."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if p.is_replicate() and j in sharded_dims else p
                 for j, p in enumerate(pl))
