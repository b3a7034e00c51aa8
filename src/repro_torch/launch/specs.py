"""Fake-tensor stand-ins for every model input of every cell (twin of
``repro.launch.specs``).

``input_specs(arch, shape_name, multi_pod=, mesh=, sharding=)`` returns
the step function's inputs and their shardings for that cell without
allocating anything: the inputs are ``FakeTensor`` s of the global shapes,
made under the ``FakeTensorMode`` it returns (``out["fake_mode"]``), and
each sharding is a ``(DeviceMesh, placements)`` pair from the specs of
``repro_torch.pshard``. ``place`` turns the two into DTensors (fake local
shards). Used by ``launch/dryrun.py``.

The reference's rules are kept as they are: the batch axes by sharding
mode, the serve-time FSDP drop when the TP-sharded params fit 12 GB a
device, the per-pod batch and the ``pod`` stacking.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import pshard, tree
from repro_torch.config import ModelConfig, ShapeConfig, shapes_for
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.encdec import src_len


def batch_axes(global_batch: int, mesh, multi_pod: bool):
    """Which mesh axes the batch dim shards over (per-pod batch when
    multi_pod: the leading stack dim takes 'pod')."""
    data = _sizes(mesh).get("data", 1)
    return ("data",) if global_batch % data == 0 and global_batch >= data \
        else ()


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _sharding(mesh, spec):
    """(mesh, placements) of a resolved spec."""
    return mesh, pshard.placements(spec, mesh)


def _ns(mesh, *spec):
    with pshard.use_mesh(mesh):
        return _sharding(mesh, pshard.resolve_spec(*spec))


def _stack(t, p: int):
    return tree.tree_map(
        lambda s: torch.empty((p,) + tuple(s.shape), dtype=s.dtype,
                              device=s.device), t)


def _stack_shardings(shardings, mesh):
    """Each (mesh, placements) of a pod's tree -> the stacked tree's:
    ``pod`` on the new leading dim, every other shard one dim later."""
    from torch.distributed.tensor import Shard
    names = tuple(mesh.mesh_dim_names)

    def one(sh):
        _, pl = sh
        sub = iter(pl)
        return mesh, tuple(
            Shard(0) if n == "pod" else
            (lambda q: Shard(q.dim + 1) if q.is_shard() else q)(next(sub))
            for n in names)
    return tree.tree_map(one, shardings)


def param_specs(model, cfg: ModelConfig, mesh):
    """Fake params (global shapes) + their (mesh, placements) under
    ``mesh``; under a ``pod`` axis the placements are the (data, model)
    ones (``_stack_shardings`` adds ``pod``)."""
    params = model.init(torch.Generator(), mesh.device_type)
    with pshard.use_mesh(mesh), pshard.manual_axes(("pod",)):
        specs = pshard.param_specs(params, model.param_rules())
    sub = pshard.submesh(mesh)
    shardings = tree.tree_map(
        lambda s: (sub, pshard.placements(s, sub)), specs)
    return params, shardings


def _batch_axis(B: int, mesh):
    """Largest prefix of the configured batch axes that divides B."""
    sizes = _sizes(mesh)
    axes = tuple(a for a in pshard.get_batch_axes()
                 if a in sizes and a != "pod")
    while axes:
        n = 1
        for a in axes:
            n *= sizes[a]
        if B % n == 0 and B >= n:
            break
        axes = axes[:-1]
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                per_pod_batch: Optional[int] = None):
    """Train/prefill batch (fake) + shardings (without any pod
    stacking)."""
    B = per_pod_batch or shape.global_batch
    S = shape.seq_len
    b_ax = _batch_axis(B, mesh)
    dev = mesh.device_type
    sub = pshard.submesh(mesh)
    toks = lambda: torch.empty((B, S), dtype=torch.int32, device=dev)
    batch = {"tokens": toks(), "targets": toks()}
    sh = {"tokens": _ns(sub, b_ax, None), "targets": _ns(sub, b_ax, None)}
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((B, src_len(S), cfg.d_model),
                                      dtype=torch.float32, device=dev)
        sh["frames"] = _ns(sub, b_ax, None, None)
    return batch, sh


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, model, *,
                 per_pod_batch: Optional[int] = None):
    B = per_pod_batch or shape.global_batch
    data = _sizes(mesh).get("data", 1)
    b_ax = "data" if B % data == 0 and B >= data else None
    dev = mesh.device_type
    sub = pshard.submesh(mesh)
    batch = {"token": torch.empty((B,), dtype=torch.int32, device=dev),
             "pos": torch.empty((), dtype=torch.int32, device=dev)}
    bsh = {"token": _ns(sub, b_ax), "pos": _ns(sub)}
    cache = model.init_cache(B, shape.seq_len, dev)
    with pshard.use_mesh(sub):
        cache_spec = model.cache_spec(B)
        csh = tree.tree_map(
            lambda s, c: _sharding(sub, pshard.size_filter(s, c.shape)),
            cache_spec, cache)
    return batch, bsh, cache, csh


def input_specs(arch: str, shape_name: str = "train_4k", *,
                multi_pod: bool = False, mesh=None,
                sharding: Optional[str] = None,
                shape: Optional[ShapeConfig] = None) -> Dict:
    """Everything the dry run needs for one cell: ``kwargs`` (fake global
    tensors), ``in_shardings`` ((mesh, placements) trees, in the order
    params, batch[, cache]) and the ``fake_mode`` they were made under.
    ``mesh`` defaults to the production mesh of the default process
    group; ``shape``, if given, replaces the named shape (a reduced
    cell under the same rules)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    if sharding:
        cfg = dataclasses.replace(cfg, sharding_mode=sharding)
    pshard.set_batch_axes(("pod", "data", "model")
                          if cfg.sharding_mode in ("fsdp", "dp")
                          else ("pod", "data"))
    shape = shape or {s.name: s for s in shapes_for(cfg)}[shape_name]
    if shape.kind != "train" and cfg.fsdp and sharding is None:
        # serve-time sharding != train-time sharding: FSDP param
        # all-gathers cost ~params bytes PER TOKEN in decode; drop the
        # data-axis shard whenever the TP-sharded params fit 12 GB a device
        if cfg.n_params() * 2 / 16 <= 12e9:
            cfg = dataclasses.replace(cfg, fsdp=False)
    mesh = mesh if mesh is not None else \
        make_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg)
    n_pods = _sizes(mesh).get("pod", 1)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    out = {"cfg": cfg, "shape": shape, "mesh": mesh, "model": model,
           "kind": shape.kind, "multi_pod": multi_pod,
           "fake_mode": fake_mode}
    with fake_mode:
        params, psh = param_specs(model, cfg, mesh)
        if shape.kind in ("train", "prefill"):
            per_pod = shape.global_batch // n_pods if multi_pod else None
            if multi_pod and shape.global_batch % n_pods:
                per_pod = max(1, shape.global_batch // n_pods)
            batch, bsh = batch_specs(cfg, shape, mesh, per_pod_batch=per_pod)
            if multi_pod:
                params, psh = _stack(params, n_pods), \
                    _stack_shardings(psh, mesh)
                batch, bsh = _stack(batch, n_pods), \
                    _stack_shardings(bsh, mesh)
            out.update(kwargs={"params": params, "batch": batch},
                       in_shardings=(psh, bsh))
        else:  # decode
            per_pod = max(1, shape.global_batch // n_pods) if multi_pod \
                else None
            batch, bsh, cache, csh = decode_specs(
                cfg, shape, mesh, model, per_pod_batch=per_pod)
            if multi_pod:
                params, psh = _stack(params, n_pods), \
                    _stack_shardings(psh, mesh)
                batch, bsh = _stack(batch, n_pods), \
                    _stack_shardings(bsh, mesh)
                cache, csh = _stack(cache, n_pods), \
                    _stack_shardings(csh, mesh)
            out.update(kwargs={"params": params, "batch": batch,
                               "cache": cache},
                       in_shardings=(psh, bsh, csh))
    return out


def place(t, shardings):
    """A tree of fake global tensors and its (mesh, placements) tree ->
    DTensors (each rank's fake local shard; nothing allocated, no
    communication)."""
    return tree.tree_map(
        lambda x, sh: pshard.from_replicated(x, sh[0], sh[1]), t, shardings)
