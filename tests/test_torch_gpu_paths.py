"""The edge tier and the dense decoder on the card, against the same runs on
the CPU. Every test here needs a CUDA device (marker ``gpu``) and skips
without one; the file imports no JAX, so it runs where the card is:

  python -m pytest -m gpu tests/test_torch_gpu_paths.py

Tolerance of the decoder: GPU_REL = 1e-4 of each output's largest
magnitude, float32 with TF32 off (cuBLAS sums in another order than the
CPU's BLAS; ``chip_smoke.py`` holds the full width at depth 2 to the same).
"""
import pytest
import torch

from repro_torch import tree
from repro_torch.config import FedConfig, replace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.builder import build_image_experiment, resolve_device
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.tree import tree_map

GPU_REL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


def _edge(device):
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=2, local_epochs=1,
                    agg_policy="top_k", policy_k=2, edge_per_silo=8,
                    edge_participation=0.5)
    orch = build_image_experiment(get_config("paper-cnn"), fed, n_train=400,
                                  n_test=160, batch_size=8, seed=0,
                                  device=device)
    for s in orch.silos:
        s.time_scale = 0.0
    return orch


@pytest.mark.gpu
def test_gpu_edge_run_matches_the_cpu_and_launches_weighted_sum():
    """Two Sync rounds of 3 silos x 8 edge clients on the card: the CPU
    run's picks, ledger height and edge metrics, and one ``weighted_sum``
    launch a silo and round (``fedavg_up``), nothing else."""
    _cuda()
    card = _edge("cuda")
    _build.reset_launches()
    card.run(2)
    launches = _build.launch_counts()
    cpu = _edge("cpu")
    cpu.run(2)
    keys = ("edge_participants", "edge_trained", "edge_skipped",
            "edge_bytes", "edge_sim_s")
    assert [s.pick_log for s in card.silos] == [s.pick_log for s in cpu.silos]
    assert card.ledger.height == cpu.ledger.height
    assert [[[m[k] for k in keys] for m in s.metrics] for s in card.silos] \
        == [[[m[k] for k in keys] for m in s.metrics] for s in cpu.silos]
    ups = sum(m["edge_trained"] > 0 for s in card.silos for m in s.metrics)
    assert launches == {**{k: 0 for k in launches}, "weighted_sum": ups}
    assert all(t.is_cuda for s in card.silos
               for t in tree.leaves(s.cluster.params))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,over", [("qwen3-1.7b", {}),
                                       ("qwen1.5-110b", {}),
                                       ("qwen3-1.7b", {"attn_window": 32})])
def test_gpu_dense_decoder_matches_the_cpu(arch, over):
    """Smoke width in float32: prefill logits and cache, then 6 decode
    steps fed the card's greedy tokens, on the card and on the CPU; no
    ported kernel launches on this path."""
    _cuda()
    cfg = replace(get_smoke_config(arch), **F32, **over)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(1))

    def run(p, dev, feed=None):
        outs, fed = [], []
        with torch.inference_mode():
            logits, cache = model.prefill(p, {"tokens": prompts.to(dev)})
            outs += [logits, cache["k"].clone()]
            tok = logits[:, -1].argmax(-1)
            for i in range(6):
                tok = tok if feed is None else feed[i].to(dev)
                fed.append(tok)
                logits, cache = model.decode_step(
                    p, {"token": tok, "pos": 40 + i}, cache)
                outs.append(logits)
                tok = logits.argmax(-1)
        return [o.float().cpu() for o in outs], fed

    _build.reset_launches()
    card, feed = run(params, "cuda")
    assert not any(_build.launch_counts().values())
    cpu, _ = run(tree_map(lambda t: t.cpu(), params), "cpu", feed)
    for a, b in zip(card, cpu):
        assert (a - b).abs().max() <= GPU_REL * b.abs().max()
