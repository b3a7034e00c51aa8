"""Architecture config registry.

Each assigned architecture lives in its own module exporting:
  CONFIG        -- the exact public-literature full configuration
  smoke_config  -- a reduced same-family config for CPU smoke tests
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

_ARCHS = {
    "chameleon-34b": "chameleon_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "gemma-2b": "gemma_2b",
    "minicpm-2b": "minicpm_2b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen1.5-110b": "qwen1_5_110b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    # the paper's own edge workload
    "paper-cnn": "paper_cnn",
}


def list_archs(include_paper: bool = False) -> List[str]:
    out = [a for a in _ARCHS if a != "paper-cnn"]
    if include_paper:
        out.append("paper-cnn")
    return out


def _module(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
