"""Uniform model API (twin of ``repro.models.api``), ``cnn`` family only.

``build_model(cfg)`` returns a ``Model`` whose methods are plain functions
of (params, batch), suitable for ``torch.func.grad_and_value`` / ``vmap``:

  init(generator, device)  -> params (nested dict of tensors)
  loss(params, batch)      -> (scalar loss, metrics dict)

CNN batches: {'image' [B,32,32,3] f32, 'label' [B] int}.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import cnn


class Model:
    def __init__(self, cfg: ModelConfig, mod):
        self.cfg = cfg
        self._m = mod

    def init(self, generator, device):
        return self._m.init_params(generator, self.cfg, device)

    def loss(self, params, batch):
        return self._m.loss_fn(params, batch, self.cfg)


_FAMILY_MOD = {"cnn": cnn}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY_MOD:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet "
            "(ROADMAP.md, queue 1 item 9: the LM families)")
    return Model(cfg, _FAMILY_MOD[cfg.family])
