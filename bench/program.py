"""The system under test, the PyTorch and CUDA port ``repro_torch``, driven
through its normal entry points: ``models.build_model`` on a
``ModelConfig`` made from the configuration file, and
``core.exchange.make_unifyfl_round_step(model, None, ExchangeConfig(...),
lr)``, the multi-pod round step with its pods stacked on one device.

The JAX package is never imported: ``repro_torch`` is found under
``src/`` of the checkout, which ``path()`` puts first on ``sys.path``.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: every key of the
    file that names one of its fields."""
    path()
    from repro_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    mc = ModelConfig(**{k: v for k, v in cfg.items() if k in names})
    if mc.padded_vocab() != cfg["padded_vocab"]:
        raise ValueError(f"{cfg['arch_id']}: the program pads the vocabulary "
                         f"to {mc.padded_vocab()}, the file says "
                         f"{cfg['padded_vocab']}")
    return mc


def round_step(cfg: dict, mix: dict):
    """The port's round step for this configuration and mix."""
    path()
    from repro_torch.core.exchange import (ExchangeConfig,
                                           make_unifyfl_round_step)
    from repro_torch.models import build_model
    return make_unifyfl_round_step(build_model(model_config(cfg)), None,
                                   ExchangeConfig(**mix["exchange"]),
                                   cfg["lr"])


class Spans:
    """Wall time inside the round step's layers, from wrappers around the
    module attributes the round step reaches: ``make_train_step`` (its
    steps; wrapped before the round step is built) and
    ``exchange_stacked``. Each span is closed by a synchronize of the
    device at both ends; none is taken while ``active`` is off.
    ``install`` before building the round step; ``remove`` restores the
    attributes."""

    def __init__(self, sync):
        self.sync = sync
        self.times = {"train": [], "exchange": []}
        self.active = True
        self._saved = []

    def _timed(self, key, fn):
        def call(*a, **kw):
            if not self.active:
                return fn(*a, **kw)
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.sync()
            self.times[key].append(time.perf_counter() - t0)
            return out
        return call

    def install(self) -> None:
        path()
        from repro_torch.core import exchange
        mts, xs = exchange.make_train_step, exchange.exchange_stacked
        self._saved = [(exchange, "make_train_step", mts),
                       (exchange, "exchange_stacked", xs)]
        exchange.make_train_step = \
            lambda model, lr=0.01: self._timed("train", mts(model, lr))
        exchange.exchange_stacked = self._timed("exchange", xs)

    def remove(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []

    def reset(self) -> None:
        for v in self.times.values():
            v.clear()


class CallLog:
    """Shapes and dtypes of the tensor arguments of each call to the
    module attributes a per-layer metric names (``CALLS`` in its reader),
    while ``on``: {"module.attr": [[(shape, dtype) or value, ...], ...]}."""

    def __init__(self, names):
        import importlib
        self.calls = {n: [] for n in names}
        self.on = False
        self._saved = []
        for name in names:
            mod_name, attr = name.rsplit(".", 1)
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._logged(name, fn))

    def _logged(self, name, fn):
        def call(*a, **kw):
            if self.on:
                self.calls[name].append(
                    [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
                     if hasattr(x, "shape") else x for x in a])
            return fn(*a, **kw)
        return call

    def remove(self) -> None:
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []
