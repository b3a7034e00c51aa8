"""The one generator of every traffic mix (``bench/traffic/<mix>.json``).

A mix of the round step states its pods, the rows a pod trains on in a
step and their length, how the tokens are drawn, and the exchange the
round runs. ``Feed`` draws each step's batch on the device from the
seed: every step new rows, the same rows for the same seed.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from bench.weights import generator

HERE = Path(__file__).resolve().parent
KEYS = {"pods", "rows", "seq_len", "tokens", "exchange", "checked_steps",
        "profiled_steps"}


def load(name: str) -> dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    missing = KEYS - set(mix)
    if missing:
        raise ValueError(f"traffic {name}: missing {sorted(missing)}")
    if mix["tokens"] != "uniform":
        raise ValueError(f"traffic {name}: tokens {mix['tokens']!r}")
    return mix


def tokens_a_step(mix: dict) -> int:
    """Training tokens of all pods in one round step."""
    return mix["pods"] * mix["rows"] * mix["seq_len"]


def scored_a_step(mix: dict) -> int:
    """Tokens the scoring forwards read in one round step: every pod
    scores every pod's model on its scoring rows, unless the policy needs
    no scores."""
    ex = mix["exchange"]
    if ex.get("policy") in ("all", "self") or ex.get("scorer") == "multikrum":
        return 0
    return mix["pods"] ** 2 * ex.get("score_batch", 2) * mix["seq_len"]


class Feed:
    """Batches {'tokens', 'targets'} [pods, rows, seq_len] (int64): rows of
    seq_len + 1 tokens drawn uniformly from the vocabulary, targets the
    tokens shifted by one."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.shape = (mix["pods"], mix["rows"], mix["seq_len"] + 1)
        self.vocab = vocab
        self.device = device
        self.g = generator(seed, "batches", device)

    def next(self) -> dict:
        x = torch.randint(0, self.vocab, self.shape, generator=self.g,
                          device=self.device)
        return {"tokens": x[..., :-1].contiguous(),
                "targets": x[..., 1:].contiguous()}
