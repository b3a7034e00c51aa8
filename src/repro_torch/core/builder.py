"""Experiment assembly: datasets -> partitions -> clusters -> orchestrator.

Twin of ``repro.core.builder`` (the image workload). The entry point runs on
the CUDA device unless the caller asks otherwise: ``device=None`` resolves to
``"cuda"`` and raises when no card is visible — nothing falls back to the
CPU. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from repro_torch.config import FedConfig, ModelConfig
from repro_torch.core.orchestrator import (BaseOrchestrator, SiloPolicy,
                                           SyncOrchestrator, check_ported)
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fed.client import Client
from repro_torch.fed.cluster import Cluster
from repro_torch.models import build_model


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
    reference computes (``paper_cnn.compute_dtype``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible: repro_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def build_image_experiment(model_cfg: ModelConfig, fed: FedConfig, *,
                           partition: str = "niid", alpha: float = 0.5,
                           n_train: int = 3000, n_test: int = 600,
                           batch_size: int = 32, lr: float = 0.01,
                           silo_specs: Optional[Sequence[SiloSpec]] = None,
                           seed: int = 0, device=None):
    """The paper's CIFAR-like workload: one model config, n_silos clusters of
    clients_per_silo clients each, IID or Dirichlet-NIID partitioned, on
    ``device`` (default: the CUDA device)."""
    check_ported(fed)
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

    orch = SyncOrchestrator(fed)
    specs = list(silo_specs or [SiloSpec() for _ in range(fed.n_silos)])
    model = build_model(model_cfg)
    for i in range(fed.n_silos):
        spec = specs[i]
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
                          byzantine=spec.byzantine, seed=seed)
        orch.add_silo(cluster, policy=spec.policy,
                      extra_train_delay=spec.extra_train_delay,
                      extra_score_delay=spec.extra_score_delay)
    # the shared global test set for reporting 'global accuracy'
    orch.global_test = {"x": xt, "y": yt}
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
