"""Multi-pod dry run: every (arch x shape x mesh) cell on a fake process
group (twin of ``repro.launch.dryrun``).

For each cell the dry run:
  1. starts a fake process group of 256 ranks ((16, 16) ``data``,
     ``model``) or 512 ((2, 16, 16) ``pod``, ``data``, ``model``) and
     builds the production mesh on it (this process is rank 0),
  2. makes the cell's inputs as fake tensors (``launch/specs.py``: nothing
     allocated) and places them as DTensors,
  3. runs the cell's step once on them, under ``launch/opstats.py``'s
     counter and ``MemTracker``: a sharding the DTensor layer cannot
     propagate, or a shape it refuses, fails here,
  4. prints the argument, output and peak bytes a device (the reference's
     ``memory_analysis`` keys), the per-device FLOPs, HBM-traffic proxy and
     collective bytes by kind and mesh axis, and the roofline terms with
     NVIDIA H100 constants,
  5. writes a JSON record with the reference's schema
     (``build/dryrun_torch/`` by default; git-ignored).

Each collective is priced at the slowest link its group's ranks span,
ranks laid out row-major, 8 GPUs to a node: NVLink inside a node,
InfiniBand between nodes (at (16, 16) a ``model`` group spans two nodes).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \
      --mesh single --dev --device cpu
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import pshard
from repro_torch.config import ShapeConfig, shapes_for
from repro_torch.configs import get_config, list_archs
from repro_torch.core.exchange import (ExchangeConfig, make_pod_serve_step,
                                       make_train_step,
                                       make_unifyfl_round_step)
from repro_torch.launch import opstats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs, place

# NVIDIA H100 SXM5 80GB, 700 W, data-sheet figures (per GPU)
PEAK_FLOPS = 989.4e12   # dense bf16 tensor-core rate, FLOP/s
HBM_BW = 3.35e12        # HBM3, bytes/s
NVLINK_BW = 450e9       # NVLink 4, bytes/s per direction, inside a node
IB_BW = 50e9            # InfiniBand NDR (400 Gb/s), bytes/s a GPU, between
GPUS_PER_NODE = 8       # nodes

OUT_DIR = os.path.join("build", "dryrun_torch")
LR = 0.01               # the train and round steps' rate (the reference's)


def model_flops_per_device(cfg, shape, n_devices: int) -> float:
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens / n_devices
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch / n_devices


def build_step(si, ex_cfg: ExchangeConfig, lr: float = LR):
    """Returns (fn, donate) for the cell described by input_specs output.
    A decode step reads the last position of its cache (the reference's
    position is abstract; the work does not depend on it)."""
    model, mesh, kind, multi_pod = si["model"], si["mesh"], si["kind"], \
        si["multi_pod"]
    if kind == "train":
        if multi_pod:
            return make_unifyfl_round_step(model, mesh, ex_cfg, lr), (0,)
        return make_train_step(model, lr), (0,)
    if kind == "prefill":
        if multi_pod:
            return make_pod_serve_step(model, mesh, "prefill"), ()
        return (lambda params, batch: model.prefill(params, batch)), ()
    pos = si["shape"].seq_len - 1
    if multi_pod:
        step = make_pod_serve_step(model, mesh, "decode")
        return (lambda params, batch, cache: step(
            params, {**batch, "pos": pos}, cache)), (2,)
    return (lambda params, batch, cache: model.decode_step(
        params, {**batch, "pos": pos}, cache)), (2,)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0; destroyed
    on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def link_bw(ranks) -> float:
    """The slowest link a group of global ``ranks`` spans."""
    return NVLINK_BW if opstats.nodes_spanned(ranks, GPUS_PER_NODE) <= 1 \
        else IB_BW


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _leaves(t) -> list:
    from torch.utils._pytree import tree_leaves
    return [x for x in tree_leaves(t) if isinstance(x, torch.Tensor)]


def _bytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in map(_local, _leaves(t)))


def measure(fn, args, mesh, device):
    """Run ``fn(*args)`` once under the op counter and ``MemTracker``
    (the mesh installed) -> (outputs, OpStats with ``peak_bytes``)."""
    counter = opstats.OpCounter(opstats.group_axes(mesh))
    mt = opstats.mem_tracker()
    mt.track_external(*[_local(x) for x in _leaves(args)])
    with mt, counter, pshard.use_mesh(mesh), pshard.dtensor_context(
            [x for x in _leaves(args)]):
        out = fn(*args)
    snap = mt.get_tracker_snapshot("peak")
    kind = torch.device(device).type
    counter.stats.peak_bytes = int(sum(v["Total"] for k, v in snap.items()
                                       if torch.device(k).type == kind))
    return out, counter.stats


def roofline(st) -> dict:
    """The roofline terms of an OpStats (seconds a device), each
    collective at its group's slowest link."""
    coll = {}
    for (kind, axis), (b, cost, n, ranks) in st.by_axis.items():
        key = f"collective_{axis}_s"
        coll[key] = coll.get(key, 0.0) + cost / link_bw(ranks)
    terms = {"compute_s": st.flops / PEAK_FLOPS,
             "memory_s": st.traffic_bytes / HBM_BW,
             "collective_s": sum(coll.values())}
    return terms, coll


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             ex_policy: str = "top_k", compression: str = "none",
             mesh_shape=None, sharding=None, scorer: str = "loss",
             device: str = "cuda", shape: Optional[ShapeConfig] = None,
             verbose: bool = True) -> dict:
    """One cell on a fake process group of the mesh's size. ``shape``
    replaces the named shape's sizes (a reduced cell)."""
    t0 = time.time()
    shape_t = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    with fake_world(math.prod(shape_t)):
        mesh = make_production_mesh(multi_pod=multi_pod, shape=shape_t,
                                    device_type=device)
        si = input_specs(arch, shape_name, multi_pod=multi_pod, mesh=mesh,
                         sharding=sharding, shape=shape)
        cfg, shp = si["cfg"], si["shape"]
        ex_cfg = ExchangeConfig(policy=ex_policy, compression=compression,
                                scorer=scorer)
        fn, donate = build_step(si, ex_cfg)
        order = ["params", "batch", "cache"]
        with si["fake_mode"]:
            args = [place(si["kwargs"][k], sh) for k, sh in
                    zip([k for k in order if k in si["kwargs"]],
                        si["in_shardings"])]
            arg_bytes = sum(_bytes(a) for a in args)
            out, st = measure(fn, args, mesh, device)
            out_bytes = _bytes(out)
        n_dev = math.prod(shape_t)
    mf = model_flops_per_device(cfg, shp, n_dev)
    terms, coll = roofline(st)
    dominant = max(terms, key=terms.get)
    worst = max(terms.values())
    rec = {
        "arch": arch, "shape": shape_name, "kind": shp.kind,
        "mesh": "multi_pod_" + "x".join(map(str, shape_t)) if multi_pod
        else "single_pod_" + "x".join(map(str, shape_t)),
        "n_devices": n_dev,
        "policy": ex_policy if (multi_pod and shp.kind == "train") else None,
        "compression": compression if multi_pod else None,
        "params_total": cfg.n_params(),
        "params_active": cfg.n_active_params(),
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": st.peak_bytes - arg_bytes,
            "alias_bytes": -1,
        },
        "cost_analysis": {"flops": st.flops,
                          "bytes_accessed": st.traffic_bytes},
        "hlo": st.to_dict(),
        "roofline": {
            **terms, **coll,
            "dominant": dominant,
            "model_flops_per_dev": mf,
            "useful_flops_ratio": (mf / st.flops) if st.flops > 0 else 0.0,
            "roofline_frac": (mf / PEAK_FLOPS) / worst if worst > 0 else 0.0,
        },
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW, "ib_bw": IB_BW,
                      "gpus_per_node": GPUS_PER_NODE,
                      "source": "NVIDIA H100 SXM5 80GB, 700 W, data sheet"},
        "compile_wall_s": time.time() - t0,
    }
    if verbose:
        ma = rec["memory_analysis"]
        print(f"[{arch} x {shape_name} x {rec['mesh']}] OK "
              f"run={rec['compile_wall_s']:.1f}s")
        print(f"  memory_analysis: args={ma['argument_bytes']/1e9:.3f}GB "
              f"out={ma['output_bytes']/1e9:.3f}GB "
              f"temp={ma['temp_bytes']/1e9:.3f}GB (per device)")
        print(f"  ops/dev: flops={st.flops:.3e} "
              f"traffic={st.traffic_bytes:.3e}B "
              f"coll={st.collective_cost_bytes:.3e}B "
              f"({st.collective_count} ops)")
        print(f"  roofline terms (s): compute={terms['compute_s']:.4f} "
              f"memory={terms['memory_s']:.4f} "
              f"collective={terms['collective_s']:.4f} "
              f"-> dominant={dominant} "
              f"frac={rec['roofline']['roofline_frac']:.3f}", flush=True)
    return rec


def _run_jobs(cells, args) -> list:
    """Each cell in its own process, ``args.jobs`` at a time; returns the
    failures."""
    import subprocess
    pending, running, failures = list(cells), [], []
    while pending or running:
        while pending and len(running) < args.jobs:
            arch, shape, mp = pending.pop(0)
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            if os.path.exists(os.path.join(args.out, tag + ".json")) and \
                    not args.force:
                print(f"[{tag}] cached, skipping")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh",
                   "multi" if mp else "single", "--out", args.out,
                   "--policy", args.policy, "--compression",
                   args.compression, "--scorer", args.scorer, "--device",
                   args.device, "--force"]
            cmd += ["--dev"] if args.dev else []
            cmd += ["--sharding", args.sharding] if args.sharding else []
            running.append((tag, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        tag, proc = running.pop(0)
        out = proc.communicate()[0]
        sys.stdout.write(out[-1500:] if proc.returncode else
                         "".join(l + "\n" for l in out.splitlines()
                                 if l.startswith(("[", "  ")) and
                                 not l.startswith("[rank")))
        if proc.returncode != 0:
            failures.append((tag, f"exit {proc.returncode}: "
                                  f"{out.strip().splitlines()[-1:]}"))
    return failures


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="both")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default=OUT_DIR)
    p.add_argument("--policy", default="top_k")
    p.add_argument("--compression", default="none")
    p.add_argument("--sharding", default=None,
                   help="override cfg.sharding_mode: tp | fsdp | dp")
    p.add_argument("--scorer", default="loss")
    p.add_argument("--dev", action="store_true",
                   help="reduced dev meshes (2,4)/(2,2,4) for fast iteration")
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device type of the fake tensors and the mesh")
    p.add_argument("--jobs", type=int, default=0,
                   help="run each cell in its own process, this many at a "
                        "time (a failing cell then fails alone)")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    cells = [(arch, shape_name, mp) for arch in archs
             for shape_name in ([args.shape] if args.shape else
                                [s.name for s in shapes_for(get_config(arch))])
             for mp in meshes]
    if args.jobs:
        failures = _run_jobs(cells, args)
        cells = []
    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[{tag}] cached, skipping")
            continue
        try:
            mesh_shape = ((2, 2, 4) if mp else (2, 4)) if args.dev \
                else None
            rec = run_cell(arch, shape_name, mp,
                           ex_policy=args.policy,
                           compression=args.compression,
                           mesh_shape=mesh_shape,
                           sharding=args.sharding,
                           scorer=args.scorer, device=args.device)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        except Exception as e:  # noqa: BLE001 - recorded, reported
            failures.append((tag, repr(e)))
            print(f"[{tag}] FAILED: {e!r}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        sys.exit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
