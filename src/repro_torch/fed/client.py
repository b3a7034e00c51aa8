"""FL client: local training over a private data shard (paper: standard
Flower clients — SGD, 2 local epochs). Clients are unaware of UnifyFL; they
receive a global model and return locally-trained weights + sample count.

Batch order and byzantine noise come from the client's numpy ``rng``, drawn
exactly as ``repro.fed.client`` draws them, so both packages see the same
batches and the same noise from the same seed.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.models.api import Model
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_map

# the only byzantine client behaviours that exist; anything else (e.g. a
# typo like 'sign_flip') would silently train honestly — fail fast instead
BYZANTINE_MODES = (None, "signflip", "noise")


def validate_byzantine(mode: Optional[str], who: str) -> Optional[str]:
    if mode not in BYZANTINE_MODES:
        raise ValueError(f"{who}: unknown byzantine mode {mode!r} "
                         f"(choose from {BYZANTINE_MODES})")
    return mode


def make_train_step(model: Model, opt_name: str = "sgd",
                    momentum: float = 0.0):
    opt = make_optimizer(opt_name, momentum=momentum)
    grad_fn = grad_and_value(model.loss, has_aux=True)

    def step(params, opt_state, batch, lr):
        grads, (_, metrics) = grad_fn(params, batch)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, metrics

    return step, opt


class Client:
    """One FL client with a private image shard {'x', 'y'}."""

    def __init__(self, client_id: str, model: Model, data: Dict[str, np.ndarray],
                 *, device, batch_size: int = 32, lr: float = 0.01,
                 optimizer: str = "sgd", seed: int = 0,
                 byzantine: Optional[str] = None):
        if "x" not in data:
            raise NotImplementedError(
                "token-stream clients are not ported yet (ROADMAP.md, "
                "queue 1 item 5: LM training)")
        self.client_id = client_id
        self.model = model
        self.data = data
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.lr = lr
        self.rng = np.random.default_rng(seed)
        self.byzantine = validate_byzantine(byzantine, client_id)
        self._step, self._opt = make_train_step(model, optimizer)

    @property
    def n_samples(self) -> int:
        return len(self.data["x"])

    def _batches(self, epochs: int):
        n = len(self.data["x"])
        for _ in range(epochs):
            order = self.rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                sel = order[i:i + self.batch_size]
                yield {"image": torch.as_tensor(self.data["x"][sel],
                                                device=self.device),
                       "label": torch.as_tensor(self.data["y"][sel],
                                                device=self.device)}

    def local_train(self, params, epochs: int = 2):
        """Returns (trained params, n_samples, mean loss)."""
        opt_state = self._opt.init(params)
        losses = []
        for batch in self._batches(epochs):
            params, opt_state, metrics = self._step(params, opt_state, batch,
                                                    self.lr)
            losses.append(metrics["loss"])
        if self.byzantine == "signflip":
            params = tree_map(lambda p: -p, params)
        elif self.byzantine == "noise":
            params = tree_map(
                lambda p: p + torch.as_tensor(self.rng.normal(0, 1.0, p.shape),
                                              dtype=p.dtype, device=p.device),
                params)
        # one device->host copy for the epoch's losses, not one per step
        mean = float(torch.stack(losses).double().mean()) if losses else 0.0
        return params, self.n_samples, mean
