"""An FL cluster (= silo = organization): one aggregator + its clients.

This is the unit UnifyFL coordinates. The cluster runs single-level FL
internally (clients -> FedAvg), evaluates on its private test set (which also
serves as its scoring set when the silo acts as a scorer), and may be
byzantine (submitting poisoned models — paper Figure 7).

Its init draws from its own ``torch.Generator(seed)``: the reference draws
from ``jax.random``, which no other framework reproduces, so parity tests
install the reference's init (``repro_torch.interop``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.fed import scorebatch
from repro_torch.fed.aggregator import SiloAggregator
from repro_torch.fed.client import Client, validate_byzantine
from repro_torch.models.api import Model
from repro_torch.tree import tree_map


class Cluster:
    def __init__(self, silo_id: str, model: Model, clients: List[Client], *,
                 test_data: Dict[str, np.ndarray], device,
                 server_opt: str = "fedavg", local_epochs: int = 2,
                 byzantine: Optional[str] = None, seed: int = 0):
        self.silo_id = silo_id
        self.model = model
        self.clients = clients
        self.test_data = test_data
        self.device = torch.device(device)
        self.aggregator = SiloAggregator(silo_id, server_opt)
        self.local_epochs = local_epochs
        self.byzantine = validate_byzantine(byzantine, silo_id)
        self.params = model.init(torch.Generator().manual_seed(seed),
                                 self.device)
        self.round = 0

    # ------------------------------------------------------------------ #
    def train_round(self) -> Dict:
        """One local FL round: fan out to clients, FedAvg their results.
        Returns metrics; updates self.params (the silo 'local model')."""
        t0 = time.perf_counter()
        results = [c.local_train(self.params, self.local_epochs)
                   for c in self.clients]
        self.params = self.aggregator.aggregate_clients(results)
        self._perturb()
        self.round += 1
        wall = time.perf_counter() - t0
        mean_loss = float(np.mean([r[2] for r in results]))
        return {"round": self.round, "client_loss": mean_loss, "wall_s": wall}

    def _perturb(self) -> None:
        """Silo-level byzantine poisoning of the aggregated model."""
        if self.byzantine == "signflip":
            self.params = tree_map(lambda p: -p, self.params)
        elif self.byzantine == "noise":
            rng = np.random.default_rng((self.round, 13))
            self.params = tree_map(
                lambda p: p + torch.as_tensor(rng.normal(0, 0.5, p.shape),
                                              dtype=p.dtype, device=p.device),
                self.params)

    # ------------------------------------------------------------------ #
    def evaluate(self, params=None) -> Dict[str, float]:
        """Accuracy/loss of a model on this silo's private test set, through
        the batched scoring engine with K=1 (one host transfer)."""
        params = self.params if params is None else params
        return scorebatch.evaluate_params(self, params)
