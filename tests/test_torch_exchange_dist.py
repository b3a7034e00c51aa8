"""The process form of the pod exchange: 2 CPU processes on gloo, a (2, 1, 1)
mesh from ``make_production_mesh``, each rank one pod passing its own
block; every rank's merged params, loss and weight row equal the stacked
form's row for its pod (bit for bit expected; gated at GAP)."""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.core import exchange as tex
from repro_torch.models import build_model

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GAP = 1e-6
CONFIGS = {
    "all": dict(policy="all"),
    "top_k": dict(policy="top_k", k=1),
    "top_k-int8": dict(policy="top_k", k=1, compression="int8"),
    "above_average-multikrum": dict(policy="above_average",
                                    scorer="multikrum"),
}

# one rank: its pod's init (seed = rank) and batch row, the four rounds
WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, "tests")
    import test_torch_exchange_dist as T
    from repro_torch import tree
    from repro_torch.core import exchange as tex
    from repro_torch.launch.mesh import make_production_mesh

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_production_mesh(multi_pod=True, shape=(2, 1, 1),
                                    device_type="cpu")
        model, params, batch = T.pods()
        blk = lambda t: tree.tree_map(lambda x: x[rank:rank + 1], t)
        params = blk(params)
        res = {}
        for name, cfg in T.CONFIGS.items():
            info = {}
            step = tex.make_unifyfl_round_step(
                model, mesh, tex.ExchangeConfig(**cfg), lr=0.1)
            merged, loss = step(params, blk(batch), info)
            res[name] = (merged, loss, info.get("weights"))
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
""")


def pods():
    """The float32 qwen3 smoke preset, two pods drawn from seeds 0 and 1,
    stacked, and 4 x 32 tokens a pod."""
    model = build_model(replace(get_smoke_config("qwen3-1.7b"),
                                param_dtype="float32",
                                compute_dtype="float32"))
    inits = [model.init(torch.Generator().manual_seed(i), "cpu")
             for i in range(2)]
    params = tree.tree_map(lambda *x: torch.stack(x), *inits)
    toks = np.random.default_rng(3).integers(0, model.cfg.vocab_size,
                                             (2, 4, 32))
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, -1, axis=2))}
    return model, params, batch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pods")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                               str(out / f"rank{r}.pt")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_process_form_equals_the_stacked_rows(ranks, name):
    model, params, batch = pods()
    info = {}
    step = tex.make_unifyfl_round_step(
        model, None, tex.ExchangeConfig(**CONFIGS[name]), lr=0.1)
    merged, loss = step(params, batch, info)
    for r in range(2):
        got, got_loss, got_w = ranks[r][name]
        assert float((got_loss[0] - loss[r]).abs()) <= GAP
        if name == "all":
            assert got_w is None and "weights" not in info
        else:
            assert float((got_w - info["weights"][r]).abs().max()) <= GAP
        for (path, a), b in zip(tree.leaves_with_paths(got),
                                tree.leaves(merged)):
            assert a.shape == (1,) + b.shape[1:], path
            gap = float((a[0] - b[r]).abs().max())
            assert gap <= GAP * float(b[r].abs().max()), (path, gap)
