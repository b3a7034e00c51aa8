"""``repro_torch.launch.specs.input_specs`` against the reference's, cell
for cell: every arch of ``list_archs()``, every shape of ``shapes_for``,
single pod at (16, 16) and multi-pod at (2, 16, 16), under the default
sharding and the ``tp``, ``fsdp`` and ``dp`` modes.

The reference resolves against ``jax.sharding.AbstractMesh`` (full-width
shapes from ``jax.eval_shape``); each of its leaves' local shape and offset
at a device follow from its ``PartitionSpec`` at that device's row-major
mesh coordinate. The port's inputs are fake tensors on a ``DeviceMesh``
over a fake process group at rank 0 and at the last rank (nothing
allocated); their local shapes and offsets are ``pshard``'s and DTensor's
own. Global shapes, dtypes and the local shape and offset of every leaf
must agree.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch import specs as jspecs
from repro_torch import pshard, tree
from repro_torch.config import shapes_for
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import specs as tspecs

torch.set_num_threads(1)

LAYOUTS = {"single": (16, 16), "multi": (2, 16, 16)}
MODES = (None, "tp", "fsdp", "dp")
DTYPES = {jnp.dtype("int32"): torch.int32, jnp.dtype("float32"): torch.float32,
          jnp.dtype("bfloat16"): torch.bfloat16}
CELLS = [(arch, s.name) for arch in list_archs()
         for s in shapes_for(get_config(arch))]


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def ref_local(spec, global_shape, mesh_shape, names, coord):
    """(local shape, offset) of a reference leaf at mesh coordinate
    ``coord``: each dim split over its axes, major to minor in the
    spec's order."""
    size = dict(zip(names, mesh_shape))
    at = dict(zip(names, coord))
    shape, off = [], []
    for i, n in enumerate(global_shape):
        ax = spec[i] if i < len(spec) else None
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        k, idx = 1, 0
        for a in axes:
            idx = idx * size[a] + at[a]
            k *= size[a]
        shape.append(n // k)
        off.append(idx * (n // k))
    return tuple(shape), tuple(off)


@pytest.fixture(scope="module", params=[(lay, r) for lay in LAYOUTS
                                        for r in ("first", "last")])
def layout(request):
    """(layout, mesh shape, port mesh at rank 0 or the last rank); the
    fake process group destroyed afterwards."""
    lay, which = request.param
    shape = LAYOUTS[lay]
    world = math.prod(shape)
    rank = 0 if which == "first" else world - 1
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield lay, shape, init_device_mesh("cpu", shape,
                                           mesh_dim_names=_names(shape))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_reference(layout, arch, shape_name):
    lay, mshape, tmesh = layout
    names = _names(mshape)
    coord = tuple(np.unravel_index(dist.get_rank(), mshape))
    assert tuple(tmesh.get_coordinate()) == coord
    for mode in MODES:
        ref = jspecs.input_specs(arch, shape_name, multi_pod=lay == "multi",
                                 mesh=AbstractMesh(mshape, names),
                                 sharding=mode)
        port = tspecs.input_specs(arch, shape_name, multi_pod=lay == "multi",
                                  mesh=tmesh, sharding=mode)
        assert port["cfg"].fsdp == ref["cfg"].fsdp
        assert port["kind"] == ref["kind"]
        order = ["params", "batch", "cache"]
        jl = jax.tree_util.tree_leaves_with_path(
            [ref["kwargs"][k] for k in order if k in ref["kwargs"]])
        js = jax.tree_util.tree_leaves(list(ref["in_shardings"]))
        tl = [leaf for k in order if k in port["kwargs"]
              for leaf in tree.leaves_with_paths(port["kwargs"][k])]
        ts = [sh for t in port["in_shardings"] for sh in tree.leaves(t)]
        assert len(jl) == len(tl) == len(js) == len(ts)
        for (jpath, jleaf), jsh, (tpath, tleaf), (m, pl) in zip(jl, js, tl,
                                                                ts):
            where = (mode, jax.tree_util.keystr(jpath), tpath)
            assert tuple(tleaf.shape) == tuple(jleaf.shape), where
            assert tleaf.dtype == DTYPES[jnp.dtype(jleaf.dtype)], where
            assert isinstance(tleaf, torch._subclasses.FakeTensor), where
            want = ref_local(tuple(jsh.spec), jleaf.shape, mshape, names,
                             coord)
            got = pshard.local_shape_and_offset(tleaf.shape, m, pl)
            assert (tuple(got[0]), tuple(got[1])) == want, where
            assert tuple(map(tuple, compute_local_shape_and_global_offset(
                tuple(tleaf.shape), m, pl))) == want, where
