"""Production mesh construction (twin of ``repro.launch.mesh``).

Importing this module touches no device and no process group. The
production layout keeps the reference's axis names and sizes: (16, 16)
``data``, ``model`` for one pod; (2, 16, 16) ``pod``, ``data``, ``model``
for two, the ``pod`` axis being the UnifyFL silo. These are layout sizes
of the reference's pods, not a measurement.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Tuple[int, ...]] = None,
                         device_type: str = "cuda"):
    """A ``DeviceMesh`` over the default process group, which must already
    be initialised with exactly ``prod(shape)`` ranks. ``shape`` overrides
    the sizes for reduced runs (the axis names keep their layout)."""
    if multi_pod:
        shape = tuple(shape or (2, 16, 16))
        axes = ("pod", "data", "model")
    else:
        shape = tuple(shape or (16, 16))
        axes = ("data", "model")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not fit the axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh: no default process group; "
                           "call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"make_production_mesh: mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the process group has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
