"""Experiment assembly: datasets -> partitions -> clusters -> orchestrator.

Twin of ``repro.core.builder``: the image workload and federated LM
training. The entry points run on the CUDA device unless the caller asks
otherwise: ``device=None`` resolves to ``"cuda"`` and raises when no card is
visible — nothing falls back to the CPU. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from repro_torch.config import FedConfig, ModelConfig
from repro_torch.core import wire
from repro_torch.core.orchestrator import (AsyncOrchestrator,
                                           BaseOrchestrator, SiloPolicy,
                                           SyncOrchestrator)
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import make_image_dataset, make_lm_dataset
from repro_torch.edge.fleet import EdgeFleet
from repro_torch.fed.client import Client
from repro_torch.fed.cluster import Cluster
from repro_torch.models import build_model
from repro_torch.tree import tree_map


@dataclass
class SiloSpec:
    policy: Optional[SiloPolicy] = None
    server_opt: str = "fedavg"
    byzantine: Optional[str] = None
    extra_train_delay: float = 0.0
    extra_score_delay: float = 0.0


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device must exist; on it the float32
    convolutions and matmuls run in full float32 (TF32 off), as the
    reference computes (``paper_cnn.compute_dtype``), and bf16 matmuls
    reduce in float32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible: repro_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev


def _build_edge_tier(silo_id: str, model, x, y, fed: FedConfig, *,
                     edge_alpha: float, batch_size: int, lr: float,
                     seed: int, device):
    """Shard one silo's training data across its edge fleet.

    Each of ``fed.edge_per_silo`` edge clients holds a Dirichlet shard of
    the silo's own shard (``min_size=0``: a shard may be empty or smaller
    than a batch; the fleet skips such a client) and trains on the silo's
    device; the fleet FedAvgs up at the silo before the cross-silo round."""
    shards = dirichlet_partition(y, fed.edge_per_silo, edge_alpha,
                                 seed=seed + 31, min_size=0)
    clients = [Client(f"{silo_id}/edge{j}", model,
                      {"x": x[p], "y": y[p]}, device=device,
                      batch_size=batch_size, lr=lr, seed=seed * 1000 + j)
               for j, p in enumerate(shards)]
    fleet = EdgeFleet(silo_id, clients,
                      participation=fed.edge_participation,
                      epochs=fed.edge_epochs, seed=seed)
    return clients, fleet


def build_image_experiment(model_cfg: ModelConfig, fed: FedConfig, *,
                           partition: str = "niid", alpha: float = 0.5,
                           edge_alpha: float = 1.0,
                           n_train: int = 3000, n_test: int = 600,
                           batch_size: int = 32, lr: float = 0.01,
                           silo_specs: Optional[Sequence[SiloSpec]] = None,
                           seed: int = 0, device=None):
    """The paper's CIFAR-like workload: one model config, n_silos clusters of
    clients_per_silo clients each, IID or Dirichlet-NIID partitioned, on
    ``device`` (default: the CUDA device).

    With ``fed.edge_per_silo > 0`` each silo's shard is instead
    Dirichlet-split (``edge_alpha``) across an
    :class:`~repro_torch.edge.fleet.EdgeFleet` of that many simulated edge
    devices — the hierarchical (multilevel) mode."""
    wire.resolve_method(fed.compression)   # fail before building anything
    dev = resolve_device(device)
    data = make_image_dataset(n_classes=model_cfg.vocab_size, n_train=n_train,
                              n_test=n_test, seed=seed)
    x, y = data["train"]
    xt, yt = data["test"]
    # NIID skew is a *silo-level* property (paper: each org's fleet sees its
    # own distribution); clients within a silo split their silo's shard IID
    if partition == "iid":
        silo_parts = iid_partition(len(x), fed.n_silos, seed=seed)
    else:
        silo_parts = dirichlet_partition(y, fed.n_silos, alpha, seed=seed)
    parts = []
    for sp in silo_parts:
        sub = iid_partition(len(sp), fed.clients_per_silo, seed=seed + 7)
        parts.extend([sp[s] for s in sub])
    # each silo also gets a private test shard (its scoring set)
    test_parts = iid_partition(len(xt), fed.n_silos, seed=seed + 1)

    orch_cls = SyncOrchestrator if fed.mode == "sync" else AsyncOrchestrator
    orch = orch_cls(fed)
    specs = list(silo_specs or [SiloSpec() for _ in range(fed.n_silos)])
    model = build_model(model_cfg)
    for i in range(fed.n_silos):
        spec = specs[i]
        sp = silo_parts[i]
        fleet = None
        if fed.edge_per_silo > 0:
            clients, fleet = _build_edge_tier(
                f"silo{i}", model, x[sp], y[sp], fed,
                edge_alpha=edge_alpha, batch_size=batch_size, lr=lr,
                seed=seed * 100 + i, device=dev)
        else:
            clients = []
            for j in range(fed.clients_per_silo):
                p = parts[i * fed.clients_per_silo + j]
                clients.append(Client(
                    f"silo{i}/client{j}", model, {"x": x[p], "y": y[p]},
                    device=dev, batch_size=batch_size, lr=lr,
                    seed=seed * 100 + i * 10 + j))
        tp = test_parts[i]
        # common init across silos (seed) — FedAvg across independently
        # initialized nets is destructive (permutation misalignment)
        cluster = Cluster(f"silo{i}", model, clients,
                          test_data={"x": xt[tp], "y": yt[tp]}, device=dev,
                          server_opt=spec.server_opt,
                          local_epochs=fed.local_epochs,
                          byzantine=spec.byzantine, seed=seed,
                          edge_fleet=fleet)
        orch.add_silo(cluster, policy=spec.policy,
                      extra_train_delay=spec.extra_train_delay,
                      extra_score_delay=spec.extra_score_delay)
    # the shared global test set for reporting 'global accuracy'
    orch.global_test = {"x": xt, "y": yt}
    return orch


def build_lm_experiment(model_cfg: ModelConfig, fed: FedConfig, *,
                        seq_len: int = 128, batch_size: int = 8,
                        steps_per_epoch: int = 8, lr: float = 0.05,
                        stream_len: int = 60_000,
                        silo_specs: Optional[Sequence[SiloSpec]] = None,
                        seed: int = 0, device=None):
    """Federated LM training: per-silo Markov 'dialects' (NIID streams), on
    ``device`` (default: the CUDA device)."""
    wire.resolve_method(fed.compression)   # fail before building anything
    dev = resolve_device(device)
    streams = make_lm_dataset(vocab=model_cfg.vocab_size, length=stream_len,
                              n_dialects=fed.n_silos, seed=seed)
    return _lm_experiment(model_cfg, fed, streams, seq_len=seq_len,
                          batch_size=batch_size,
                          steps_per_epoch=steps_per_epoch, lr=lr,
                          silo_specs=silo_specs, seed=seed, device=dev)


def _lm_experiment(model_cfg: ModelConfig, fed: FedConfig, streams, *,
                   seq_len: int, batch_size: int, steps_per_epoch: int,
                   lr: float, silo_specs, seed: int, device,
                   init_generator=None):
    """The LM silos over given token ``streams``, one a silo: each
    stream's first 90 % split evenly across the silo's clients, the rest
    its test stream. Every silo starts from one common init, drawn once
    from ``init_generator`` (default: a CPU generator seeded with
    ``seed``, as ``Cluster`` draws) and copied to each silo."""
    dev = resolve_device(device)
    orch_cls = SyncOrchestrator if fed.mode == "sync" else AsyncOrchestrator
    orch = orch_cls(fed)
    specs = list(silo_specs or [SiloSpec() for _ in range(fed.n_silos)])
    model = build_model(model_cfg)
    init = model.init(init_generator or torch.Generator().manual_seed(seed),
                      dev)
    for i in range(fed.n_silos):
        spec = specs[i]
        stream = streams[i]
        cut = int(len(stream) * 0.9)
        shard = cut // fed.clients_per_silo
        clients = []
        for j in range(fed.clients_per_silo):
            sub = stream[j * shard:(j + 1) * shard]
            clients.append(Client(
                f"silo{i}/client{j}", model,
                {"tokens": sub, "seq_len": seq_len,
                 "steps_per_epoch": steps_per_epoch},
                device=dev, batch_size=batch_size, lr=lr,
                seed=seed * 100 + i * 10 + j))
        cluster = Cluster(f"silo{i}", model, clients,
                          test_data={"tokens": stream[cut:],
                                     "seq_len": seq_len}, device=dev,
                          server_opt=spec.server_opt,
                          local_epochs=fed.local_epochs,
                          byzantine=spec.byzantine, seed=seed,
                          init=init if i == 0 else tree_map(torch.clone,
                                                            init))
        orch.add_silo(cluster, policy=spec.policy,
                      extra_train_delay=spec.extra_train_delay,
                      extra_score_delay=spec.extra_score_delay)
    return orch


def global_eval(orch: BaseOrchestrator) -> Dict[str, Dict[str, float]]:
    """Evaluate each silo's current model on the shared global test set."""
    out = {}
    gt = getattr(orch, "global_test", None)
    for s in orch.silos:
        if gt is not None:
            saved = s.cluster.test_data
            s.cluster.test_data = gt
            out[s.silo_id] = s.cluster.evaluate()
            s.cluster.test_data = saved
        else:
            out[s.silo_id] = s.cluster.evaluate()
    return out
