"""Carry parameters across frameworks as nested dicts of numpy arrays.

``params_from_numpy(jax.tree.map(np.asarray, ref_params), device)`` installs
a reference init in the port (whose ``torch.Generator`` cannot reproduce
``jax.random``); ``params_to_numpy`` goes the other way. Every leaf keeps
its dtype. bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses) cross as their 16 bits, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)       # a contiguous, writable host copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes    # numpy's bfloat16; only this direction needs it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    return tree_map(lambda a: _to_tensor(a).to(device), tree)


def params_to_numpy(params):
    """Nested dict of tensors -> nested dict of numpy arrays (host copies)."""
    return tree_map(_to_numpy, params)
