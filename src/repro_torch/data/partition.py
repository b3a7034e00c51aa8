"""IID and Dirichlet non-IID partitioners (paper section 4.1.2)."""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(n_samples: int, n_parts: int, *, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_samples)
    return [np.sort(p) for p in np.array_split(idx, n_parts)]


def dirichlet_partition(labels: np.ndarray, n_parts: int, alpha: float, *,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Label-skewed NIID split: per class, proportions ~ Dirichlet(alpha).
    Lower alpha => more skew (paper uses alpha in {0.1, 0.5})."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        parts: List[List[int]] = [[] for _ in range(n_parts)]
        for c in range(n_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(n_parts, alpha))
            cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
            for p, chunk in enumerate(np.split(idx, cuts)):
                parts[p].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_size:
            return [np.sort(np.array(p, dtype=np.int64)) for p in parts]
    raise RuntimeError("dirichlet partition failed to satisfy min_size")


def label_distribution(labels: np.ndarray, parts: List[np.ndarray]) -> np.ndarray:
    n_classes = int(labels.max()) + 1
    out = np.zeros((len(parts), n_classes), np.int64)
    for i, p in enumerate(parts):
        for c, n in zip(*np.unique(labels[p], return_counts=True)):
            out[i, c] = n
    return out
