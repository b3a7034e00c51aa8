"""Synthetic datasets (offline container: no CIFAR/TinyImageNet downloads).

``make_image_dataset`` produces a class-conditional Gaussian-mixture image
task with CIFAR-like geometry (32x32x3, configurable class count). Each class
has a fixed random template; samples are template * signal + noise. The task
is learnable by the paper's CNN and exhibits the paper's central phenomenon:
under NIID (Dirichlet) partitioning a silo sees few classes, so non-collab
silo accuracy saturates low while collaborative aggregation recovers the full
class set.

``make_lm_dataset`` produces Markov-chain token streams with per-silo
transition "dialects" over a shared base chain (the LM analogue of NIID).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def make_image_dataset(n_classes: int = 10, n_train: int = 6000,
                       n_test: int = 1000, *, noise: float = 0.6,
                       img_hw: int = 32, seed: int = 0):
    """Returns dict(train=(x, y), test=(x, y)) with x in NHWC float32."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0.0, 1.0, (n_classes, img_hw, img_hw, 3)).astype(np.float32)

    def sample(n, r):
        y = r.integers(0, n_classes, n).astype(np.int32)
        x = templates[y] + r.normal(0.0, noise, (n, img_hw, img_hw, 3)).astype(np.float32)
        return x.astype(np.float32), y

    return {"train": sample(n_train, rng), "test": sample(n_test, rng),
            "n_classes": n_classes}


def make_lm_dataset(vocab: int = 256, length: int = 200_000, *,
                    n_dialects: int = 1, dialect_strength: float = 0.5,
                    seed: int = 0) -> List[np.ndarray]:
    """Markov token streams, one per dialect. Shared base transition matrix
    plus per-dialect sparse perturbation => silo data is NIID but related."""
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(np.ones(vocab) * 0.3, size=vocab)
    streams = []
    for d in range(n_dialects):
        pert = rng.dirichlet(np.ones(vocab) * 0.1, size=vocab)
        trans = (1 - dialect_strength) * base + dialect_strength * pert
        trans = trans / trans.sum(axis=1, keepdims=True)
        cum = np.cumsum(trans, axis=1)
        toks = np.empty(length, np.int32)
        t = rng.integers(0, vocab)
        u = rng.random(length)
        for i in range(length):
            t = int(np.searchsorted(cum[t], u[i]))
            t = min(t, vocab - 1)
            toks[i] = t
        streams.append(toks)
    return streams


def batch_lm(stream: np.ndarray, batch: int, seq: int, step: int, *,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic batch slicer: windows are drawn by a counter-seeded rng
    so any worker can reproduce batch ``step`` without coordination."""
    rng = np.random.default_rng((seed, step))
    starts = rng.integers(0, len(stream) - seq - 1, batch)
    toks = np.stack([stream[s:s + seq] for s in starts])
    tgts = np.stack([stream[s + 1:s + seq + 1] for s in starts])
    return {"tokens": toks.astype(np.int32), "targets": tgts.astype(np.int32)}
