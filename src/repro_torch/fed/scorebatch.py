"""Batched scoring engine: vmapped multi-model evaluation, q8-direct ingest.

Twin of ``repro.fed.scorebatch``. Every round each scorer silo evaluates
every pulled peer model on its private test set (paper §2.6):

  * **Stack, don't loop.** All K peer models of a round stack along a
    leading axis into ONE params dict (leaves ``[K, ...]``) and evaluate in
    one pass: for an image test set a loop over test batches, each a
    ``torch.func.vmap`` over the K models; for a token stream a loop over
    the K models and the stream's W windows (at most 4 of ``seq_len``),
    one window a forward as the reference's ``lax.scan`` takes them (a
    batch of one: a MoE's capacity depends on the batch). The ``[2, K]``
    (loss, accuracy or ``exp(-loss)``) result comes back with a **single**
    device->host copy (``BatchedScorer.host_syncs``).

  * **q8-direct ingest.** A round's packed int8 payloads are expanded by ONE
    batched dequantize kernel launch per padded length into a ``[K, n]``
    matrix of the n values kept; ``ops.unflatten_batch`` slices it into the
    stacked params.

``Cluster.evaluate`` shares the engine with K=1.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch import tree
from repro_torch.kernels import ops

BATCH_SIZE = 256          # eval batch width
MAX_PREPARED = 8          # device-resident test-set layouts kept process-wide

# test-set layouts shared across scorers: builder.global_eval swaps the SAME
# global test dict into every silo — keying on (id(td), batch_size, device)
# means S silos evaluating one shared test set hold ONE device copy, not S
_PREPARED: "OrderedDict" = OrderedDict()


# --------------------------------------------------------------------------- #
# Wire -> stacked models (the q8-direct ingest path)
# --------------------------------------------------------------------------- #

def stack_decoded_vecs(decoded: Sequence, n: int, device):
    """A round's ``DecodedModel``s -> one [K, n] f32 matrix on ``device``.

    int8 payloads are grouped by padded length and expanded by ONE batched
    dequantize launch per group; other envelopes contribute their cached
    vectors."""
    K = len(decoded)
    if K == 0:
        return torch.zeros((0, n), dtype=torch.float32, device=device)
    rows: List = [None] * K
    groups: Dict[int, List[int]] = {}
    for i, d in enumerate(decoded):
        if d.is_q8:
            groups.setdefault(int(d.q.shape[0]), []).append(i)
        else:
            rows[i] = d.vec().to(device=device, dtype=torch.float32)[:n]
    for idxs in groups.values():
        q = torch.stack([decoded[i].q for i in idxs]).to(device)
        s = torch.stack([decoded[i].scales for i in idxs]).to(device)
        mat = ops.dequantize_batch(q, s, n)
        if len(idxs) == K:  # uniform int8 round: the batch IS the answer
            return mat
        for j, i in enumerate(idxs):
            rows[i] = mat[j]
    return torch.stack(rows)


def stack_decoded(decoded: Sequence, spec, device):
    """Wire payloads -> stacked params dict (leaves [K, *shape])."""
    n = ops.spec_length(spec)
    return ops.unflatten_batch(stack_decoded_vecs(decoded, n, device), spec)


# --------------------------------------------------------------------------- #
# Batched eval (loop over batches x vmap over models)
# --------------------------------------------------------------------------- #

def _eval_image(model, stacked, xb, yb, xr, yr):
    """(stacked, xb [nb,bs,...], yb, xr [r,...], yr) -> [2, K] (loss, acc).

    Full batches are weighted by the batch size and the partial remainder
    batch by its true count, accumulated on the device."""
    nb, bs = int(xb.shape[0]), int(xb.shape[1])
    r = int(xr.shape[0])

    def metrics(params, x, y):
        _, m = model.loss(params, {"image": x, "label": y})
        return m["loss"], m["accuracy"]

    per_model = vmap(metrics, in_dims=(0, None, None))
    K = int(tree.leaves(stacked)[0].shape[0])
    loss = torch.zeros((K,), dtype=torch.float32, device=xr.device)
    acc = torch.zeros_like(loss)
    for i in range(nb):
        ls, ac = per_model(stacked, xb[i], yb[i])
        loss = loss + ls * bs
        acc = acc + ac * bs
    if r:
        ls, ac = per_model(stacked, xr, yr)
        loss = loss + ls * r
        acc = acc + ac * r
    n = nb * bs + r
    return torch.stack([loss / n, acc / n])


def _eval_lm(model, stacked, tok, tgt):
    """(stacked, tok [W, S], tgt [W, S]) -> [2, K] (loss, exp(-loss)): each
    model's mean loss over the W windows, summed in window order in float32
    as the reference's scan sums them."""
    K = int(tree.leaves(stacked)[0].shape[0])
    losses = []
    for k in range(K):
        params = tree.tree_map(lambda a: a[k], stacked)
        total = torch.zeros((), dtype=torch.float32, device=tok.device)
        for w in range(int(tok.shape[0])):
            _, m = model.loss(params, {"tokens": tok[w:w + 1],
                                       "targets": tgt[w:w + 1]})
            total = total + m["loss"].to(torch.float32)
        losses.append(total / tok.shape[0])
    loss = torch.stack(losses)
    return torch.stack([loss, torch.exp(-loss)])


# --------------------------------------------------------------------------- #
# Per-cluster scorer
# --------------------------------------------------------------------------- #

class BatchedScorer:
    """One per scorer cluster: evaluates K stacked models on the cluster's
    private test set wholly on its device, one host transfer per call."""

    def __init__(self, cluster, batch_size: int = BATCH_SIZE):
        self.cluster = cluster
        self.batch_size = batch_size
        self.host_syncs = 0          # device->host transfers issued

    def _prepare(self, td, device) -> Dict:
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if "x" not in td:
            # the reference's windows: starts every seq_len tokens, at most 4
            stream = np.asarray(td["tokens"])
            seq = int(td.get("seq_len", 128))
            starts = list(range(0, min(len(stream) - seq - 1, 4 * seq), seq))
            if not starts:
                return {"td": td, "kind": "empty", "args": None}
            win = np.stack([stream[i:i + seq + 1] for i in starts])
            win = dev(win.astype(np.int64))
            return {"td": td, "kind": "lm",
                    "args": (win[:, :-1], win[:, 1:])}
        x = np.asarray(td["x"])
        y = np.asarray(td["y"])
        bs = self.batch_size
        nb, _ = divmod(len(x), bs)
        cut = nb * bs
        return {"td": td, "kind": "image",
                "args": (dev(x[:cut].reshape(nb, bs, *x.shape[1:])),
                         dev(y[:cut].reshape(nb, bs)),
                         dev(x[cut:]), dev(y[cut:]))}

    def _prep(self) -> Dict:
        td = self.cluster.test_data
        device = self.cluster.device
        key = (id(td), self.batch_size, str(device))
        p = _PREPARED.get(key)
        if p is None or p["td"] is not td:
            p = self._prepare(td, device)
            _PREPARED[key] = p       # p["td"] pins td, keeping id(td) valid
            while len(_PREPARED) > MAX_PREPARED:
                _PREPARED.popitem(last=False)
        else:
            _PREPARED.move_to_end(key)
        return p

    @torch.no_grad()
    def evaluate_stacked(self, stacked) -> np.ndarray:
        """stacked: params with leaves [K, ...] -> host [2, K] (loss, acc)
        via exactly ONE device->host transfer."""
        p = self._prep()
        if p["kind"] == "empty":
            # a stream shorter than one window: the reference's fallback
            K = int(tree.leaves(stacked)[0].shape[0])
            return np.stack([np.zeros(K), np.ones(K)])
        run = _eval_image if p["kind"] == "image" else _eval_lm
        out = run(self.cluster.model, stacked, *p["args"])
        host = out.cpu().numpy()     # the single device->host transfer
        self.host_syncs += 1
        return host


def get_scorer(cluster) -> BatchedScorer:
    """The cluster's (cached) batched scorer."""
    sc = getattr(cluster, "_batched_scorer", None)
    if sc is None or sc.cluster is not cluster:
        sc = BatchedScorer(cluster)
        cluster._batched_scorer = sc
    return sc


# --------------------------------------------------------------------------- #
# Public entry points
# --------------------------------------------------------------------------- #

def evaluate_params(cluster, params) -> Dict[str, float]:
    """Self/peer evaluation of ONE model through the engine (K=1)."""
    stacked = tree.tree_map(lambda a: a[None], params)
    host = get_scorer(cluster).evaluate_stacked(stacked)
    return {"loss": float(host[0, 0]), "accuracy": float(host[1, 0])}


def score_round_batch(cluster, decoded: Sequence, spec, *,
                      method: str = "accuracy") -> List[float]:
    """Score a round's K pulled peer models on ``cluster``'s private test
    set in ONE batched pass (higher = better for every method), with a
    single device->host transfer for the whole [K] score vector."""
    if not decoded:
        return []
    stacked = stack_decoded(decoded, spec, cluster.device)
    host = get_scorer(cluster).evaluate_stacked(stacked)
    if method == "accuracy":
        return [float(a) for a in host[1]]
    if method == "loss":
        return [float(-l) for l in host[0]]
    raise ValueError(f"per-model scorer {method!r} unknown")
