"""Carry parameters across frameworks as nested dicts of numpy arrays.

``params_from_numpy(jax.tree.map(np.asarray, ref_params), device)`` installs
a reference init in the port (whose ``torch.Generator`` cannot reproduce
``jax.random``); ``params_to_numpy`` goes the other way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def params_to_numpy(params):
    """Nested dict of tensors -> nested dict of numpy arrays (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
