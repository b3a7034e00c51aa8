"""The DTensor-placed train step on 4 CPU processes (gloo, a (2, 2)
``data`` x ``model`` mesh from ``make_production_mesh``), under the ``tp``
and ``fsdp`` sharding modes, against the single-process step on plain
tensors: loss and new params within REL (float32), every gradient on its
param's placements.

``qwen3-1.7b`` and ``rwkv6-1.6b`` are held to one step on the whole batch.
``olmoe-1b-7b`` (EP, 2 experts a shard) routes each ``data`` shard's
tokens on their own, as the reference's shard_map does (capacity and the
load-balance loss per token block, the loss averaged over ``data``): it is
held to the mean of the single-process steps on the two half batches.

The same 4 ranks as a (2, 1, 2) ``pod`` x ``data`` x ``model`` mesh run
the DTensor round step of two ``qwen3-1.7b`` pods (``top_k``, with int8,
and ``above_average`` scored by MultiKRUM sketches): each pod trains on its
submesh and the exchange gathers local shards over ``pod``; held to the
stacked round step in one process.
"""
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
REL = 1e-5
LR = 0.1
ARCHS = ("qwen3-1.7b", "olmoe-1b-7b", "rwkv6-1.6b")
MODES = ("tp", "fsdp")
CASES = [(a, m) for a in ARCHS for m in MODES]
ROUNDS = {"top_k": dict(policy="top_k", k=1),
          "top_k-int8": dict(policy="top_k", k=1, compression="int8"),
          "above_average-multikrum": dict(policy="above_average",
                                          scorer="multikrum")}

WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, "tests")
    import test_torch_dtensor_dist as T
    from repro_torch import pshard, tree
    from repro_torch.core import exchange as tex
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
        res = {}
        for arch, mode in T.CASES:
            model, params, batch = T.setup(arch, mode)
            with pshard.use_mesh(mesh):
                dp = pshard.distribute_params(params, model.param_rules())
                db = {k: pshard.place(v, mesh, pshard.BATCH,
                                      *([None] * (v.dim() - 1)))
                      for k, v in batch.items()}
                info = {}
                new, metrics = tex.make_train_step(model, T.LR)(dp, db, info)
            same = [tuple(g.placements) == tuple(p.placements)
                    for g, p in zip(tree.leaves(info["grads"]),
                                    tree.leaves(dp))]
            res[arch, mode] = (
                tree.tree_map(lambda d: d.full_tensor(), new),
                metrics["loss"].full_tensor(), all(same))
        mesh3 = make_production_mesh(multi_pod=True, shape=(2, 1, 2),
                                     device_type="cpu")
        model, stack, batch, psh, bsh = T.pods(mesh3)
        for name, cfg in T.ROUNDS.items():
            step = tex.make_unifyfl_round_step(
                model, mesh3, tex.ExchangeConfig(**cfg), lr=T.LR)
            merged, loss = step(specs.place(stack, psh),
                                specs.place(batch, bsh))
            res[name] = (tree.tree_map(lambda d: d.full_tensor(), merged),
                         loss)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
""")


def setup(arch, mode):
    """The float32 smoke preset of ``arch`` under ``mode`` (its batch axes
    set as the dry run sets them), its seed-0 init and 4 x 16 tokens."""
    from repro_torch import pshard
    model = build_model(replace(get_smoke_config(arch), param_dtype="float32",
                                compute_dtype="float32", sharding_mode=mode))
    pshard.set_batch_axes(("pod", "data", "model") if mode in ("fsdp", "dp")
                          else ("pod", "data"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(5).integers(0, model.cfg.vocab_size, (4, 16))
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, -1, axis=1))}
    return model, params, batch


def pods(mesh=None):
    """Two float32 ``qwen3-1.7b`` smoke pods (seeds 0 and 1) stacked, 4 x
    16 tokens a pod; with ``mesh``, the stacks' (mesh, placements) too."""
    from repro_torch import pshard
    from repro_torch.launch import specs
    model, _, _ = setup("qwen3-1.7b", "tp")
    inits = [model.init(torch.Generator().manual_seed(i), "cpu")
             for i in range(2)]
    stack = tree.tree_map(lambda *x: torch.stack(x), *inits)
    toks = np.random.default_rng(6).integers(0, model.cfg.vocab_size,
                                             (2, 4, 16))
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, -1, axis=2))}
    if mesh is None:
        return model, stack, batch
    with pshard.use_mesh(mesh), pshard.manual_axes(("pod",)):
        psh = pshard.param_shardings(inits[0], model.param_rules())
        sub = pshard.submesh(mesh)
        b_pl = pshard.spec_placements((4, 16), sub, pshard.BATCH, None)
    bsh = {k: (sub, b_pl) for k in batch}
    return (model, stack, batch, specs._stack_shardings(psh, mesh),
            specs._stack_shardings(bsh, mesh))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dtensor")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                               str(out / f"rank{r}.pt")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    return [torch.load(out / f"rank{r}.pt") for r in range(4)]


def single_process(arch, mode):
    """(new params, loss) of the step on plain tensors in one process; for
    the MoE the mean over the two ``data`` shards' half batches."""
    model, params, batch = setup(arch, mode)
    step = tex.make_train_step(model, LR)
    if arch != "olmoe-1b-7b":
        new, metrics = step(params, batch)
        return new, metrics["loss"]
    halves = [step(params, tree.tree_map(lambda x: x[h:h + 2], batch))
              for h in (0, 2)]
    # SGD: p - lr * (g0 + g1) / 2 is the mean of the two steps' params
    new = tree.tree_map(lambda a, b: (a + b) * 0.5, halves[0][0],
                        halves[1][0])
    return new, (halves[0][1]["loss"] + halves[1][1]["loss"]) * 0.5


@pytest.mark.parametrize("arch,mode", CASES)
def test_dtensor_step_matches_one_process(ranks, arch, mode):
    want, want_loss = single_process(arch, mode)
    for r in range(4):
        got, got_loss, placed = ranks[r][arch, mode]
        assert placed, "a gradient is not on its param's placements"
        assert abs(float(got_loss) - float(want_loss)) <= \
            REL * abs(float(want_loss))
        for (path, a), b in zip(tree.leaves_with_paths(got),
                                tree.leaves(want)):
            assert a.shape == b.shape, path
            gap = float((a - b).abs().max())
            assert gap <= REL * max(float(b.abs().max()), 1e-30), (path, gap)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_dtensor_round_step_matches_the_stacked_round(ranks, name):
    model, stack, batch = pods()
    want, want_loss = tex.make_unifyfl_round_step(
        model, None, tex.ExchangeConfig(**ROUNDS[name]), lr=LR)(stack, batch)
    for r in range(4):
        got, loss = ranks[r][name]
        pod = r // 2                     # ranks row-major: pod, data, model
        assert abs(float(loss[0]) - float(want_loss[pod])) <= \
            REL * abs(float(want_loss[pod]))
        for (path, a), b in zip(tree.leaves_with_paths(got),
                                tree.leaves(want)):
            assert a.shape == b.shape, path
            gap = float((a - b).abs().max())
            assert gap <= REL * float(b.abs().max()), (path, gap)
