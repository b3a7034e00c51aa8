"""Aggregation + score policies (paper §3.4.4).

Score policies collapse the per-model list of scorer outputs into one scalar
(robust to malicious/badly-split scorers). Aggregation policies pick which
peer models join the aggregate. Both are pure functions, so silos can swap
them per-round (the paper's 'unparalleled flexibility').
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------- #
# Score policies: List[float] -> float
# ---------------------------------------------------------------------------- #

def score_median(scores: Sequence[float]) -> float:
    return float(np.median(scores)) if len(scores) else float("-inf")


def score_mean(scores: Sequence[float]) -> float:
    return float(np.mean(scores)) if len(scores) else float("-inf")


def score_min(scores: Sequence[float]) -> float:
    return float(np.min(scores)) if len(scores) else float("-inf")


def score_max(scores: Sequence[float]) -> float:
    return float(np.max(scores)) if len(scores) else float("-inf")


SCORE_POLICIES = {"median": score_median, "mean": score_mean,
                  "min": score_min, "max": score_max}


def weighted_collapse(scores: Dict[str, float], policy: str,
                      reputation: Dict[str, float],
                      default_rep: float = 1.0) -> float:
    """Reputation-weighted collapse of a per-model {scorer: score} map.

    Zero-reputation (fully slashed) scorers are excluded outright; if no
    trusted scorer remains the model collapses to ``-inf`` (unscored).
    ``median`` is the weighted median (smallest value whose cumulative
    weight reaches half the total — deterministic under ties), ``mean``
    the weighted mean; ``min``/``max`` ignore weights beyond exclusion.
    """
    if not scores:
        return float("-inf")
    pairs = [(v, reputation.get(s, default_rep))
             for s, v in sorted(scores.items())]
    pairs = [(v, w) for v, w in pairs if w > 0.0]
    if not pairs:
        return float("-inf")
    vals = np.array([v for v, _ in pairs], dtype=np.float64)
    wts = np.array([w for _, w in pairs], dtype=np.float64)
    if policy == "mean":
        return float(np.sum(vals * wts) / np.sum(wts))
    if policy == "median":
        order = np.argsort(vals, kind="stable")
        vals, wts = vals[order], wts[order]
        cum = np.cumsum(wts)
        idx = int(np.searchsorted(cum, cum[-1] / 2.0))
        return float(vals[min(idx, len(vals) - 1)])
    if policy == "min":
        return float(np.min(vals))
    if policy == "max":
        return float(np.max(vals))
    raise KeyError(policy)


# ---------------------------------------------------------------------------- #
# Aggregation policies
# ---------------------------------------------------------------------------- #

@dataclass
class Candidate:
    cid: str
    owner: str
    score: float  # collapsed via a score policy; higher = better


def pick_all(cands: List[Candidate], self_score: float, *, k: int = 0,
             rng: Optional[random.Random] = None) -> List[Candidate]:
    return list(cands)


def pick_self(cands: List[Candidate], self_score: float, *, k: int = 0,
              rng=None) -> List[Candidate]:
    return []


def pick_random_k(cands: List[Candidate], self_score: float, *, k: int = 2,
                  rng=None) -> List[Candidate]:
    rng = rng or random.Random(0)
    pool = list(cands)
    rng.shuffle(pool)
    return pool[:k]


def pick_top_k(cands: List[Candidate], self_score: float, *, k: int = 2,
               rng=None) -> List[Candidate]:
    # CID tie-break pins the selection under equal scores: every silo (and
    # every rerun) picks the same winners, keeping aggregation reorg- and
    # replay-deterministic
    return sorted(cands, key=lambda c: (-c.score, c.cid))[:k]


def pick_above_average(cands: List[Candidate], self_score: float, *, k: int = 0,
                       rng=None) -> List[Candidate]:
    if not cands:
        return []
    avg = float(np.mean([c.score for c in cands]))
    return [c for c in cands if c.score >= avg]


def pick_above_median(cands: List[Candidate], self_score: float, *, k: int = 0,
                      rng=None) -> List[Candidate]:
    if not cands:
        return []
    med = float(np.median([c.score for c in cands]))
    return [c for c in cands if c.score >= med]


def pick_above_self(cands: List[Candidate], self_score: float, *, k: int = 0,
                    rng=None) -> List[Candidate]:
    return [c for c in cands if c.score >= self_score]


AGG_POLICIES = {
    "all": pick_all,
    "self": pick_self,
    "random_k": pick_random_k,
    "top_k": pick_top_k,
    "above_average": pick_above_average,
    "above_median": pick_above_median,
    "above_self": pick_above_self,
}


def select_models(entries: List[Dict], *, agg_policy: str, score_policy: str,
                  k: int = 2, self_score: float = float("-inf"),
                  rng: Optional[random.Random] = None,
                  reputation: Optional[Dict[str, float]] = None
                  ) -> List[Candidate]:
    """entries: contract.get_latest_models_with_scores() output.
    Collapses score lists then applies the aggregation policy. With
    ``reputation`` (silo -> on-chain reputation) the collapse is
    reputation-weighted: slashed scorers stop moving the aggregate."""
    if reputation is not None:
        cands = [Candidate(e["cid"], e["owner"],
                           weighted_collapse(e["scores"], score_policy,
                                             reputation))
                 for e in entries]
    else:
        sp = SCORE_POLICIES[score_policy]
        cands = [Candidate(e["cid"], e["owner"],
                           sp(list(e["scores"].values())))
                 for e in entries]
    # unscored models are only eligible under sampling-based policies
    if agg_policy in ("top_k", "above_average", "above_median", "above_self"):
        cands = [c for c in cands if c.score != float("-inf")]
    return AGG_POLICIES[agg_policy](cands, self_score, k=k, rng=rng)
