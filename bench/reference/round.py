"""The multi-pod UnifyFL round step, written plainly, over a family's
reference: each pod's SGD step on its rows (the gradient in float32,
the update rounded to the parameter's dtype), then the exchange
(``exchange.py``): under 'all' the mean of the pods; under a scored
policy each model coded as the mix says, every pod scoring every model
on its first ``score_batch`` rows (minus the loss), the weight rows and
each pod's merge.

``faults`` plants one of the faults the benchmark's check must catch, in
the reference put in the program's place: 'half_batch' (each pod trains
on the first half of its rows), 'no_exchange' (each pod keeps its own
trained model), 'unchanged' (each pod's train step returns the model it
was given, with its loss). Nothing here imports the program.
"""
from __future__ import annotations

import torch

from bench.reference import exchange as ex_ref

FAULTS = ("half_batch", "no_exchange", "unchanged")


def train(pod: dict, batch: dict, family, cfg: dict, lr: float, num):
    """-> (loss, the pod's parameters after one SGD step)."""
    paths = list(pod)
    leaves = [pod[p].detach().to(torch.float32).requires_grad_()
              for p in paths]
    with torch.enable_grad():
        loss = family.loss(dict(zip(paths, leaves)), batch, cfg, num)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    new = {p: (x.detach() - lr * g).to(pod[p].dtype)
           for p, x, g in zip(paths, leaves, grads)}
    return float(loss.detach()), new


def rows(batch: dict, i: int, n=None) -> dict:
    return {k: v[i, :n] for k, v in batch.items()}


def round_step(pods: list, batch: dict, family, cfg: dict, mix: dict,
               lr: float, num, fault=None):
    """pods: one {path: tensor} a pod; batch leaves [P, rows, S]. Returns
    (the pods after the round, a record: losses, trained, gathered,
    scores [scorer, model], weights [P, P])."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    ex = mix["exchange"]
    P = len(pods)
    n_rows = batch["tokens"].shape[1]
    keep = n_rows // 2 if fault == "half_batch" else None
    losses, trained = [], []
    for i, pod in enumerate(pods):
        loss, new = train(pod, rows(batch, i, keep), family, cfg, lr, num)
        losses.append(loss)
        trained.append(pod if fault == "unchanged" else new)
    rec = {"losses": losses, "trained": trained, "gathered": None,
           "scores": None, "weights": None}
    if fault == "no_exchange" or ex["policy"] == "self" or P == 1:
        return trained, rec
    if ex.get("scorer", "loss") != "loss":
        raise NotImplementedError(f"scorer {ex['scorer']!r}")
    if ex["policy"] == "all":
        return ex_ref.mean(trained), rec
    gathered = ex_ref.gather(trained, ex.get("compression", "none"))
    sb = ex.get("score_batch", 2)
    with torch.no_grad():
        scores = torch.tensor(
            [[-float(family.loss(g, rows(batch, b, sb), cfg, num))
              for g in gathered] for b in range(P)], dtype=torch.float32)
    coll = ex_ref.collapse(scores, ex.get("score_policy", "median"))
    W = torch.stack([ex_ref.policy_row(coll, i, ex) for i in range(P)])
    rec.update(gathered=gathered, scores=scores, weights=W)
    return ex_ref.merge(gathered, W), rec
