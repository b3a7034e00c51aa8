"""What decides ``correct``: the readings of the round step's first
steps, taken alike from the program and from the plain reference that
follows them, and the comparison of the two.

A step's record (``step_digest``): each pod's loss; each leaf's norm of
its change in the local step (trained - the step's input; in the first
step the gradient as SGD applied it, times the learning rate); under
int8 each leaf's norm of its coding error (gathered - trained); the score
matrix and the weight rows. After the checked steps, each leaf's norm of
its change since the start (``norms`` of the stack against the start).

The numbers compared (``compare``), each against its limit in
``bench/limits/<workload>.json``:

- ``loss``: the largest relative gap of a pod's loss over the steps;
- ``grad``: the first step's change, by the worst leaf: |program's norm -
  reference's| over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- ``grad_median``: the median of the same gaps over the leaves and pods:
  steady from seed to seed where the worst leaf is one whose update
  bf16 mostly rounds away;
- ``change``: the same of the change since the start, as the step after
  the checked ones receives the stack;
- ``q8``: the same of the int8 coding error, over the steps;
- ``scores``: the largest relative gap of a score over the steps;
- ``weights``: the largest gap of a weight (exact: limit 0).

Leaves whose first-step change in the reference is under a thousandth
of the median moved leaf's, 0 included (a gradient that is nought to
rounding), are left out of ``grad`` and ``change`` (of ``q8``: those
whose coding error is); the median leaf is that of the leaves compared.
A number that one side has and the other lacks reads infinite. A
number that the limits give as null is read and not compared: it has no
upper reading (``PERF.md`` names it with its readings).
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CHUNK = 1 << 26
NOUGHT = 1e-3


def dist(a, b) -> float:
    """||a - b|| in float32 chunks, summed in float64."""
    a, b = a.reshape(-1), b.reshape(-1)
    tot = 0.0
    for lo in range(0, a.numel(), CHUNK):
        d = a[lo:lo + CHUNK].float() - b[lo:lo + CHUNK].float()
        tot += float(torch.dot(d, d))
    return math.sqrt(tot)


def norms(after: list, before: list) -> dict:
    """{path: [||after_i - before_i|| for each pod i]}."""
    return {p: [dist(a[p], b[p]) for a, b in zip(after, before)]
            for p in after[0]}


def step_digest(before, trained, gathered, losses, scores, weights) -> dict:
    """One step's readings; pods as lists of {path: tensor}."""
    return {"losses": [float(x) for x in losses],
            "train": norms(trained, before),
            "q8": norms(gathered, trained) if gathered is not None else None,
            "scores": None if scores is None else
            [[float(x) for x in row] for row in scores],
            "weights": None if weights is None else
            [[float(x) for x in row] for row in weights]}


def limits(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


def _finite(x: float) -> float:
    """A gap that is not a number reads infinite."""
    return math.inf if math.isnan(x) else x


def _rel(a, b) -> float:
    return _finite(abs(a - b) / max(abs(b), 1e-30))


def _median(values) -> float:
    return float(torch.tensor(values).median()) if values else 0.0


def _kept(ref: dict) -> set:
    """The leaves compared: those that every pod's reference moves by a
    thousandth of its median moved leaf or more (the rest, 0 included,
    are nought to rounding)."""
    keep = set(ref)
    for i in range(len(next(iter(ref.values())))):
        med = _median([v[i] for v in ref.values() if v[i] > 0])
        keep -= {p for p, v in ref.items() if not v[i] > NOUGHT * med}
    return keep


def _leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """Each kept leaf and pod's |prog - ref| / max(ref, the median kept
    leaf of ref)."""
    gaps = []
    for i in range(len(next(iter(ref.values())))):
        med = _median([ref[p][i] for p in keep])
        for p in keep:
            got = prog.get(p, [math.inf] * (i + 1))[i]
            gaps.append(_finite(abs(got - ref[p][i])
                                / max(ref[p][i], med, 1e-30)))
    return gaps


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst of ``_leaf_gaps``."""
    return max(_leaf_gaps(prog, ref, keep), default=0.0)


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared, from the program's and the reference's
    readings: {"steps": [step_digest...], "change": norms}."""
    ps, rs = prog["steps"], ref["steps"]
    first = rs[0]["train"]
    keep = _kept(first)
    gaps = _leaf_gaps(ps[0]["train"], first, keep)
    out = {"loss": max(_rel(a, b) for p, r in zip(ps, rs)
                       for a, b in zip(p["losses"], r["losses"])),
           "grad": max(gaps, default=0.0),
           "grad_median": _median(gaps),
           "change": _leaf_gap(prog["change"], ref["change"], keep)}
    if any(r["q8"] is not None for r in rs):
        out["q8"] = max(_leaf_gap(p["q8"] or {}, r["q8"], _kept(r["q8"]))
                        for p, r in zip(ps, rs))
    gap = lambda a, b: _finite(abs(a - b))
    for key, fn in (("scores", _rel), ("weights", gap)):
        if any(r[key] is not None for r in rs):
            out[key] = max(
                (fn(a, b) for p, r in zip(ps, rs) if p[key] is not None
                 for ra, rb in zip(p[key], r[key]) for a, b in zip(ra, rb)),
                default=math.inf)
            if any(p[key] is None for p in ps):
                out[key] = math.inf
    return out


def compare(values: dict, lims: dict) -> dict:
    """{name: {"value", "limit"}} of every number read, and whether each
    holds; a number that the limits give as null is not compared; a
    number that they do not name, or a limit without a number, fails."""
    checks = {}
    for name in sorted(set(values) | set(lims)):
        v = values.get(name, math.inf)
        lim = lims.get(name)
        if name in lims and lim is None:
            ok = name in values
        else:
            ok = lim is not None and v <= lim and not math.isnan(v)
        checks[name] = {"value": v, "limit": lim, "ok": ok}
    return checks
