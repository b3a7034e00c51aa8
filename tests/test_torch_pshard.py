"""``repro_torch.pshard`` and every family's ``param_rules`` / ``cache_spec``
against the reference's, spec for spec.

The reference resolves against ``jax.sharding.AbstractMesh`` over the
full-width ``jax.eval_shape`` of its init; the port against a
``DeviceMesh`` on a fake process group (nothing allocated, no peer) over
the full-width shapes of its init under ``FakeTensorMode``. Every arch of
``list_archs()`` and paper-cnn, at no mesh and at (16, 16), (2, 16, 16),
(2, 4) and (2, 2, 4), under the ``tp``, ``fsdp`` and ``dp`` sharding modes
with their batch axes, the cache at batch 1 and 128.
"""
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import pshard as jpshard
from repro.config import replace as jreplace
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch import pshard as tpshard
from repro_torch import tree
from repro_torch.config import replace as treplace
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.models import build_model as tbuild

ARCHS = list_archs(include_paper=True)
MESHES = {"none": None, "16x16": (16, 16), "2x16x16": (2, 16, 16),
          "2x4": (2, 4), "2x2x4": (2, 2, 4)}
MODES = ("tp", "fsdp", "dp")
# the batch axes each mode resolves BATCH to (repro/launch/specs.py:112)
BATCH_AXES = {"tp": ("pod", "data"), "fsdp": ("pod", "data", "model"),
              "dp": ("pod", "data", "model")}

_SHAPES = {}


def shapes(arch):
    """(reference shapes, port shapes) of the full-width init, leaf paths
    in sorted-key order on both sides."""
    if arch not in _SHAPES:
        jm, tm = jbuild(jget(arch)), tbuild(tget(arch))
        ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        with FakeTensorMode():
            port = tm.init(torch.Generator(), "cpu")
        _SHAPES[arch] = (ref, port)
    return _SHAPES[arch]


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """(reference mesh, port mesh) for one layout; the port's over a fake
    process group of prod(shape) ranks, destroyed afterwards (pytest-xdist
    reuses its workers)."""
    shape = MESHES[request.param]
    if shape is None:
        yield request.param, None, None
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        tmesh = init_device_mesh("cpu", shape, mesh_dim_names=_names(shape))
        yield request.param, AbstractMesh(shape, _names(shape)), tmesh
    finally:
        dist.destroy_process_group()


def _flat_ref(specs):
    out = []
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out.append((tuple(str(k.key) for k in path), tuple(spec)))
    return out


def _flat_port(specs):
    return [(p, tuple(s)) for p, s in tree.leaves_with_paths(specs)]


def _resolve_both(jmesh, tmesh, mode, fn_j, fn_t):
    jpshard.set_batch_axes(BATCH_AXES[mode])
    tpshard.set_batch_axes(BATCH_AXES[mode])
    with jpshard.use_mesh(jmesh), tpshard.use_mesh(tmesh):
        return fn_j(), fn_t()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_are_the_references(meshes, arch):
    name, jmesh, tmesh = meshes
    ref_shapes, port_shapes = shapes(arch)
    for mode in MODES:
        jm = jbuild(jreplace(jget(arch), sharding_mode=mode))
        tm = tbuild(treplace(tget(arch), sharding_mode=mode))
        want, got = _resolve_both(
            jmesh, tmesh, mode,
            lambda: _flat_ref(jpshard.param_specs(ref_shapes,
                                                  jm.param_rules())),
            lambda: _flat_port(tpshard.param_specs(port_shapes,
                                                   tm.param_rules())))
        assert got == want, (arch, name, mode)
        for batch in (1, 128):
            if jm.kind == "cnn":
                with pytest.raises(AttributeError):
                    jm.cache_spec(batch)
                with pytest.raises(ValueError, match="no decode path"):
                    tm.cache_spec(batch)
                continue
            want, got = _resolve_both(
                jmesh, tmesh, mode,
                lambda: _flat_ref(jm.cache_spec(batch)),
                lambda: _flat_port(tm.cache_spec(batch)))
            assert got == want, (arch, name, mode, batch)
    jpshard.set_batch_axes(BATCH_AXES["tp"])
    tpshard.set_batch_axes(BATCH_AXES["tp"])


SPECS = [(None,), ("pod",), ("data", "model"), (jpshard.BATCH, "model"),
         (("data", "model"), "model", None), ("model", ("pod", "data")),
         (jpshard.BATCH, ("data", "model")), ("model", "model"),
         (("pod", "model"), jpshard.BATCH, "data")]
SHAPES = [(16,), (8, 32), (32, 32, 7), (1, 16, 48), (2, 36, 4096)]


@pytest.mark.parametrize("mode", MODES)
def test_resolve_spec_and_size_filter_are_the_references(meshes, mode):
    """The logical specs models write, BATCH among them, resolved against
    each mesh (also with ``pod`` run by hand), then filtered by
    divisibility against shapes that do and do not divide."""
    name, jmesh, tmesh = meshes
    for manual in ((), ("pod",)):
        for spec in SPECS:
            def ref():
                with jpshard.manual_axes(manual):
                    r = jpshard.resolve_spec(*spec)
                    return [tuple(r)] + [tuple(jpshard.size_filter(r, s))
                                         for s in SHAPES]

            def port():
                with tpshard.manual_axes(manual):
                    r = tpshard.resolve_spec(*spec)
                    return [tuple(r)] + [tuple(tpshard.size_filter(r, s))
                                         for s in SHAPES]

            want, got = _resolve_both(jmesh, tmesh, mode, ref, port)
            assert got == want, (name, mode, manual, spec)
    jpshard.set_batch_axes(BATCH_AXES["tp"])
    tpshard.set_batch_axes(BATCH_AXES["tp"])


def test_partition_spec_is_a_tuple_of_its_entries():
    p = tpshard.PartitionSpec(None, ("data", "model"), "model")
    assert p == (None, ("data", "model"), "model")
    assert tuple(p) == tuple(jax.sharding.PartitionSpec(
        None, ("data", "model"), "model"))
    assert repr(p) == "PartitionSpec(None, ('data', 'model'), 'model')"
