"""Per-device op statistics of a step run under fake tensors on a fake
process group (twin of ``repro/launch/hlostats.py``).

The reference parses the partitioned, scheduled HLO of a compiled step.
Eager PyTorch has no such program: this module runs the step once under a
``TorchDispatchMode`` and counts what each rank would execute:

  - FLOPs of the **local** ops only: an op on DTensors is seen twice, once
    with the DTensors and once as the op on their local shards; only the
    second is counted (``FlopCounterMode`` counts both). Products and
    convolutions by ``torch.utils.flop_counter``'s formulas (2 M N K), as
    the reference counts dots and convolutions only; a hand-written
    kernel's fake op (``kernels/_build.FAKE_COSTS``) by the formulas of
    ``chip_smoke.bound``;
  - an HBM-traffic proxy: operand and output bytes of every local op that
    is not a view, eager's real traffic since nothing is fused (a kernel's
    fake op: its own bytes);
  - collective bytes and count by kind (all-reduce 2x, the others 1x, as
    ``_COLL_FACTOR``), each with the mesh axis of its group and the
    group's global ranks (``launch/dryrun.py`` prices each at the slowest
    link those ranks span);
  - the peak of live bytes, by ``MemTracker`` (``peak``).

Everything is per device; ``HloStats.to_dict``'s keys are kept.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

_COLL_FACTOR = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}

# op schema name -> collective kind
_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "broadcast",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "broadcast",
}

# ops that move no data of their own
_NO_TRAFFIC = {"aten::detach", "aten::lift_fresh", "aten::empty",
               "aten::empty_strided", "aten::_local_scalar_dense",
               "aten::_to_copy_meta", "aten::alias", "aten::_unsafe_view",
               "_c10d_functional::wait_tensor", "aten::set_",
               "aten::resize_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


@dataclass
class OpStats:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_cost_bytes: float = 0.0
    collective_count: int = 0
    flops_unscaled: float = 0.0
    top_collectives: List = field(default_factory=list)
    # per (kind, axis): [bytes, cost bytes, count, group ranks]
    by_axis: Dict = field(default_factory=dict)
    kernel_flops: float = 0.0
    peak_bytes: int = -1
    flops_by_op: Dict[str, float] = field(default_factory=dict)

    def to_dict(self):
        colls = sorted(self.top_collectives, reverse=True)
        return {"flops": self.flops, "traffic_bytes": self.traffic_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_cost_bytes": self.collective_cost_bytes,
                "collective_count": self.collective_count,
                "flops_unscaled": self.flops_unscaled,
                "top_collectives": [
                    {"bytes_total": b, "kind": k, "op": op, "times": 1}
                    for b, k, op in colls[:20]],
                "collectives_by_axis": [
                    {"kind": k, "axis": a, "bytes": v[0], "cost_bytes": v[1],
                     "count": v[2], "ranks": v[3]}
                    for (k, a), v in sorted(self.by_axis.items())],
                "kernel_flops": self.kernel_flops,
                "flops_by_op": dict(sorted(self.flops_by_op.items())),
                "peak_bytes": self.peak_bytes}


_PROPAGATING = threading.local()


def _skip_shape_propagation() -> None:
    """DTensor finds an op's output shape by running it once on fake
    tensors of the global shapes (``ShardingPropagator``); no rank runs
    that op. Wrap the propagator so that ops under it are not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError("opstats: this torch's ShardingPropagator has no "
                           f"{name}; its shape propagation would be counted")
    if getattr(orig, "_opstats", False):
        return

    def wrapped(self, *args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1
    wrapped._opstats = True
    setattr(ShardingPropagator, name, wrapped)


def mem_tracker():
    """A ``MemTracker`` that, like ``OpCounter``, skips DTensor's shape
    propagation (its global-shape fake tensors are no rank's memory)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if getattr(_PROPAGATING, "depth", 0):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    _skip_shape_propagation()
    return LocalMemTracker()


def group_axes(mesh) -> Dict[str, str]:
    """Process-group name -> the mesh axis it runs along."""
    out = {}
    for j, name in enumerate(mesh.mesh_dim_names):
        out[mesh.get_group(j).group_name] = name
    return out


class OpCounter(TorchDispatchMode):
    """Counts the local ops of whatever runs inside it into ``stats``
    (module docstring). ``axes``: group name -> mesh axis
    (``group_axes``)."""

    def __init__(self, axes: Optional[Dict[str, str]] = None):
        super().__init__()
        _skip_shape_propagation()
        self.stats = OpStats()
        self.axes = dict(axes or {})

    def _group(self, func, args, kwargs):
        """(group name, global ranks) of a collective's group."""
        name = None
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, str):
                name = a
            elif isinstance(a, torch.ScriptObject):
                try:
                    name = dist.ProcessGroup.unbox(a).group_name
                except Exception:  # noqa: BLE001 - not a process group
                    continue
        ranks = None
        if name is not None:
            try:
                pg = dist.distributed_c10d._resolve_process_group(name)
                ranks = dist.get_process_group_ranks(pg)
            except Exception:  # noqa: BLE001 - an unregistered name
                ranks = None
        return name, ranks

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor dispatches it, this mode still on: its local ops and
            # collectives come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "depth", 0):
            return out
        ins = _tensors((args, kwargs))
        st = self.stats
        name = func._schema.name
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            b = float(max(sum(map(_nbytes, _tensors(out))),
                          sum(map(_nbytes, ins))))
            group, ranks = self._group(func, args, kwargs)
            axis = self.axes.get(group, group)
            st.collective_bytes[kind] = st.collective_bytes.get(kind, 0.0) + b
            st.collective_cost_bytes += b * _COLL_FACTOR[kind]
            st.collective_count += 1
            key = (kind, str(axis))
            row = st.by_axis.setdefault(key, [0.0, 0.0, 0, ranks])
            row[0] += b
            row[1] += b * _COLL_FACTOR[kind]
            row[2] += 1
            st.top_collectives.append((b, kind, f"{name}@{axis}"))
            return out
        cost = _build.FAKE_COSTS.get(name)
        if cost is not None:
            f, b = cost(args, out)
            st.flops += f
            st.flops_unscaled += f
            st.kernel_flops += f
            st.flops_by_op[name] = st.flops_by_op.get(name, 0.0) + f
            st.traffic_bytes += b
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            st.flops += f
            st.flops_unscaled += f
            st.flops_by_op[name] = st.flops_by_op.get(name, 0.0) + f
        if name in _NO_TRAFFIC or any(r.alias_info is not None
                                      for r in func._schema.returns):
            return out
        st.traffic_bytes += sum(map(_nbytes, ins)) + \
            sum(map(_nbytes, _tensors(out)))
        return out


def nodes_spanned(ranks, per_node: int = 8) -> int:
    """How many nodes of ``per_node`` GPUs (ranks row-major) a group
    spans."""
    return len({r // per_node for r in ranks}) if ranks else 1

