"""Uniform model API (twin of ``repro.models.api``): the ``cnn``, the
``ssm`` (RWKV-6) and the ``dense`` / ``vlm`` decoder families.

``build_model(cfg)`` returns a ``Model`` whose methods are plain functions
of (params, batch), suitable for ``torch.func.grad_and_value`` / ``vmap``:

  init(generator, device)            -> params (nested dict of tensors)
  loss(params, batch)                -> (scalar loss, metrics dict)
  prefill(params, batch)             -> (logits [B,S,V], cache)
  init_cache(batch, seq_len, device) -> cache (nested dict of tensors)
  decode_step(params, batch, cache)  -> (logits [B,V], cache)

Batches:
  LM train:  {'tokens' [B,S] int, 'targets' [B,S] int}
  decode:    {'token' [B] int, 'pos' int}
  CNN:       {'image' [B,32,32,3] f32, 'label' [B] int}
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import cnn, rwkv6, transformer


class Model:
    def __init__(self, cfg: ModelConfig, mod, *, kind: str):
        self.cfg = cfg
        self._m = mod
        self.kind = kind  # 'decoder' | 'ssm' | 'cnn'

    def init(self, generator, device):
        return self._m.init_params(generator, self.cfg, device)

    def loss(self, params, batch):
        return self._m.loss_fn(params, batch, self.cfg)

    # -- serving ------------------------------------------------------------ #
    def init_cache(self, batch: int, seq_len: int, device):
        if self.kind == "cnn":
            raise ValueError("cnn has no decode path")
        if self.kind == "ssm":
            return rwkv6.init_state(self.cfg, batch, device)
        return self._m.init_cache(self.cfg, batch, seq_len, device)

    def prefill(self, params, batch):
        return self._m.prefill(params, batch["tokens"], self.cfg)

    def decode_step(self, params, batch, cache):
        return self._m.decode_step(params, batch["token"], batch["pos"],
                                   cache, self.cfg)


_FAMILY_MOD = {
    "dense": (transformer, "decoder"),
    "vlm": (transformer, "decoder"),
    "ssm": (rwkv6, "ssm"),
    "cnn": (cnn, "cnn"),
}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY_MOD:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
            "queue 1 item 5: moe.py, rglru.py, encdec.py)")
    mod, kind = _FAMILY_MOD[cfg.family]
    return Model(cfg, mod, kind=kind)
