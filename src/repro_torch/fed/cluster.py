"""An FL cluster (= silo = organization): one aggregator + its clients.

This is the unit UnifyFL coordinates. The cluster runs single-level FL
internally (clients -> FedAvg), evaluates on its private test set (which also
serves as its scoring set when the silo acts as a scorer), and may be
byzantine (submitting poisoned models — paper Figure 7).

Its init draws from its own ``torch.Generator(seed)``, unless the caller
hands it ``init`` (the LM builder draws one common init for every silo, on
the card at full width): the reference draws from ``jax.random``, which no
other framework reproduces, so parity tests install the reference's init
(``repro_torch.interop``).
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
                 byzantine: Optional[str] = None, seed: int = 0,
                 edge_fleet=None, init=None):
        self.silo_id = silo_id
        self.model = model
        self.clients = clients
        self.test_data = test_data
        self.device = torch.device(device)
        self.aggregator = SiloAggregator(silo_id, server_opt)
        self.local_epochs = local_epochs
        self.byzantine = validate_byzantine(byzantine, silo_id)
        self.params = (model.init(torch.Generator().manual_seed(seed),
                                  self.device) if init is None else init)
        self.round = 0
        # hierarchical mode (repro_torch.edge): when set, the silo's trainer
        # population is an EdgeFleet — train_round delegates to it
        self.edge_fleet = edge_fleet

    # ------------------------------------------------------------------ #
    def train_round(self) -> Dict:
        """One local FL round: fan out to clients, FedAvg their results.
        Returns metrics; updates self.params (the silo 'local model').

        With an ``edge_fleet`` attached this is the *edge tier* instead:
        sampled edge clients train on their device profiles and FedAvg up
        here, charged on the fabric when one is wired."""
        t0 = time.perf_counter()
        if self.edge_fleet is not None:
            self.params, m = self.edge_fleet.train_round(self.params)
            self._perturb()
            self.round += 1
            m["round"] = self.round
            m["wall_s"] = time.perf_counter() - t0
            return m
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

    # ------------------------------------------------------------------ #
    def score_model(self, params, method: str = "accuracy") -> float:
        """Score a peer model on the silo's private test set (paper §2.6:
        accuracy scoring works in both sync and async modes)."""
        m = self.evaluate(params)
        if method == "accuracy":
            return m["accuracy"]
        if method == "loss":
            return -m["loss"]
        raise ValueError(method)
