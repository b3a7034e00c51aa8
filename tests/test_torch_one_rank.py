"""One rank, a (1, 1) mesh over a real (gloo) process group: the
DTensor-placed ``make_train_step`` of the ``qwen3-1.7b`` smoke preset
(remat 'full', bf16) gives the plain step's new params and loss bit for
bit, and its local-op FLOPs (``launch/opstats``) equal the dry run's count
of the same cell at (1, 1) on a fake process group; its argument bytes are
the dry run's too. (``chip_smoke.py`` phase 9 runs it at full width on the
card, with the peak against the dry run's.)"""
import socket

import pytest
import torch
import torch.distributed as dist

import repro_torch.launch.specs as specs
from repro_torch import pshard, tree
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.exchange import make_train_step
from repro_torch.launch import dryrun, opstats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model

torch.set_num_threads(1)

B, S = 4, 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield make_production_mesh(shape=(1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_step_is_the_plain_step(one_rank, monkeypatch):
    mesh = one_rank
    model = build_model(get_smoke_config("qwen3-1.7b"))
    assert model.cfg.remat == "full"
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    step = make_train_step(model, dryrun.LR)
    plain, plain_m = step(params, batch)
    with pshard.use_mesh(mesh):
        dp = pshard.distribute_params(params, model.param_rules())
        db = {k: pshard.place(v, mesh, pshard.BATCH, None)
              for k, v in batch.items()}
    counter = opstats.OpCounter(opstats.group_axes(mesh))
    with counter, pshard.use_mesh(mesh), pshard.dtensor_context(dp):
        new, metrics = step(dp, db)
    for a, b in zip(tree.leaves(new), tree.leaves(plain)):
        assert torch.equal(a.to_local(), b)
    assert torch.equal(metrics["loss"].to_local(), plain_m["loss"])
    arg_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                    for a in (dp, db) for t in tree.leaves(a))
    dist.destroy_process_group()
    try:
        monkeypatch.setattr(specs, "get_config", get_smoke_config)
        rec = dryrun.run_cell("qwen3-1.7b", "train_4k", False,
                              mesh_shape=(1, 1), device="cpu",
                              shape=ShapeConfig("train_4k", S, B, "train"),
                              verbose=False)
    finally:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                                f"{_free_port()}", rank=0, world_size=1)
    assert counter.stats.flops == rec["hlo"]["flops"] > 0
    assert arg_bytes == rec["memory_analysis"]["argument_bytes"]
    assert rec["hlo"]["peak_bytes"] > arg_bytes
