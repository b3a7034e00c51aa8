"""``repro_torch.launch.dryrun`` at the reduced ``--dev`` meshes against
the reference's dry run, run in a subprocess (it sets ``XLA_FLAGS`` at
import): ``qwen3-1.7b`` ``train_4k`` and ``decode_32k`` and
``olmoe-1b-7b`` ``train_4k`` on the (2, 4) mesh. ``model_flops_per_dev``
and ``argument_bytes`` must be equal, the per-device FLOPs within FLOPS_REL.
(The multi-pod cell: ``test_torch_dryrun_multi.py``.)
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import dryrun

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLOPS_REL = 0.05
CELLS = [("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "decode_32k"),
         ("olmoe-1b-7b", "train_4k")]
KEYS = {"arch", "shape", "kind", "mesh", "n_devices", "policy",
        "compression", "params_total", "params_active", "memory_analysis",
        "cost_analysis", "hlo", "roofline", "compile_wall_s"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's records of CELLS, one subprocess a cell, all
    started together."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--dev", "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for arch, shape in CELLS]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    return {(a, s): json.load(open(out / f"{a}__{s}__single.json"))
            for a, s in CELLS}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dev_cell_matches_reference(reference, arch, shape):
    ref = reference[arch, shape]
    got = dryrun.run_cell(arch, shape, False, mesh_shape=(2, 4),
                          device="cpu", verbose=False)
    assert KEYS <= set(got)
    assert set(got["memory_analysis"]) == set(ref["memory_analysis"])
    assert set(ref["hlo"]) <= set(got["hlo"])
    assert got["roofline"]["model_flops_per_dev"] == \
        ref["roofline"]["model_flops_per_dev"]
    assert got["memory_analysis"]["argument_bytes"] == \
        ref["memory_analysis"]["argument_bytes"]
    assert got["memory_analysis"]["alias_bytes"] == -1
    rel = abs(got["hlo"]["flops"] - ref["hlo"]["flops"]) / ref["hlo"]["flops"]
    assert rel <= FLOPS_REL, (got["hlo"]["flops"], ref["hlo"]["flops"])
