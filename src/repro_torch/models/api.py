"""Uniform model API (twin of ``repro.models.api``) over every family in
``configs/``: the ``cnn``; the ``dense``, ``vlm`` and ``moe`` decoders
(``transformer``); the ``ssm`` (RWKV-6); the ``hybrid`` (RecurrentGemma,
``rglru``); the ``encdec`` (SeamlessM4T, ``encdec``).

``build_model(cfg)`` returns a ``Model`` whose methods are plain functions
of (params, batch), suitable for ``torch.func.grad_and_value`` / ``vmap``:

  init(generator, device)            -> params (nested dict of tensors)
  loss(params, batch)                -> (scalar loss, metrics dict)
  prefill(params, batch)             -> (logits [B,S,V], cache)
  init_cache(batch, seq_len, device) -> cache (nested dict of tensors)
  decode_step(params, batch, cache)  -> (logits [B,V], cache)

Batches:
  LM train:  {'tokens' [B,S] int, 'targets' [B,S] int}
  encdec adds 'frames' [B,S/4,D] f32 (audio frontend stub).
  decode:    {'token' [B] int, 'pos' int}
  CNN:       {'image' [B,32,32,3] f32, 'label' [B] int}
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models import cnn, encdec, rglru, rwkv6, transformer


class Model:
    def __init__(self, cfg: ModelConfig, mod, *, kind: str):
        self.cfg = cfg
        self._m = mod
        self.kind = kind  # 'decoder' | 'encdec' | 'ssm' | 'hybrid' | 'cnn'

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
        if self.kind == "encdec":
            return encdec.prefill(params, batch, self.cfg)
        return self._m.prefill(params, batch["tokens"], self.cfg)

    def decode_step(self, params, batch, cache):
        return self._m.decode_step(params, batch["token"], batch["pos"],
                                   cache, self.cfg)


_FAMILY_MOD = {
    "dense": (transformer, "decoder"),
    "vlm": (transformer, "decoder"),
    "moe": (transformer, "decoder"),
    "ssm": (rwkv6, "ssm"),
    "hybrid": (rglru, "hybrid"),
    "encdec": (encdec, "encdec"),
    "cnn": (cnn, "cnn"),
}


def build_model(cfg: ModelConfig) -> Model:
    mod, kind = _FAMILY_MOD[cfg.family]
    return Model(cfg, mod, kind=kind)
