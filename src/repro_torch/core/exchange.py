"""Cross-silo UnifyFL exchange over the ``pod`` axis (twin of
``repro.core.exchange``).

When silos are pods on a shared fabric, the paper's pull + score +
policy-select + re-aggregate round becomes collectives over the ``pod``
axis, after each silo's local train step:

  round_step(params, batch):
    1. local train step (client SGD on the silo's batch)
    2. exchange:
       'all' policy  -> mean over the pods (no gather, no scoring)
       scored policy -> gather the models over the pods (optionally int8:
                        one scale a leaf), score each gathered model on
                        the pod's scoring microbatch (the paper's scorer,
                        loss as the accuracy proxy) or on sketches
                        (MultiKRUM), gather the score matrix, collapse it
                        by the score policy, weight by the aggregation
                        policy, and merge: per leaf ``sum_j W[i, j] g_j``,
                        one call of the ``weighted_sum`` kernel.

The pod axis takes two forms, which share ``exchange_gathered``, every line
of the policy and merge arithmetic:

- across processes: a ``DeviceMesh`` with a ``pod`` dimension, one rank a
  pod (``exchange``; gloo on the CPU, NCCL across cards). The round step
  takes the rank's block ``[1, ...]``;
- on one device: P pods stacked on the leading dimension
  (``exchange_stacked``), the counterpart of the reference's exchange
  under ``jax.vmap(axis_name="pod")``: the gathered models are the stack
  itself, the score matrix each pod's row of scores stacked.

With DTensor params on a (pod, data, model) mesh the process form is the
reference's shard_map, manual over ``pod`` and automatic over ``data`` /
``model``: each pod's block runs on the (data, model) submesh as DTensors
(the train step's collectives are DTensor's), and the exchange gathers each
rank's local shards over its ``pod`` group only and merges them with
``weighted_sum``, shard by shard.

The control-plane path (ledger + store) in ``core/orchestrator.py`` is the
WAN variant of the same round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import pshard, tree
from repro_torch.kernels.wsum import weighted_sum
from repro_torch.models.api import Model

F32 = torch.float32


@dataclass(frozen=True)
class ExchangeConfig:
    policy: str = "top_k"          # 'all' | 'self' | 'top_k' | 'above_average'
    score_policy: str = "median"   # 'median' | 'mean' | 'min' | 'max'
    k: int = 1
    scorer: str = "loss"           # 'loss' (accuracy proxy) | 'multikrum'
    compression: str = "none"      # 'none' | 'int8'
    score_batch: int = 2           # rows of the local batch used for scoring
    sketch_dim: int = 2048         # multikrum sketch width
    mix_rate: float = 0.5          # self-weight when merging peers


# --------------------------------------------------------------------------- #
# Compression: one scale a leaf
# --------------------------------------------------------------------------- #

def _q8(leaf):
    """-> (int8 codes, float32 scale): ``amax * f32(1/127)``, round half to
    even, clipped to +-127. The reference writes ``amax / 127.0``; XLA
    compiles a division by a constant into that product, eager and
    jitted alike, and the two differ in the last bit for some leaves."""
    x = leaf.to(F32)
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax * (1.0 / 127.0),
                        torch.ones_like(amax))
    q = torch.round(x / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _dq8(q, scale, dtype):
    return (q.to(F32) * scale).to(dtype)


# --------------------------------------------------------------------------- #
# Score -> weights
# --------------------------------------------------------------------------- #

def _mean(rows):
    """The mean of a sequence of tensors as XLA compiles the reference's
    ``jnp.mean`` / ``pmean``: summed in order, times ``f32(1/n)``."""
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc * (1.0 / len(rows))


def _collapse_scores(mat, how: str):
    """mat: [scorer, model] -> [model]. The median of an even count is the
    mean of its two middle values (``jnp.median``, not ``torch.median``)."""
    if how == "median":
        n = mat.shape[0]
        s = torch.sort(mat, dim=0).values
        med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
        return torch.where(torch.isnan(mat).any(dim=0),
                           torch.full_like(med, float("nan")), med)
    if how == "mean":
        return _mean(list(mat))
    if how == "min":
        return torch.amin(mat, dim=0)
    if how == "max":
        return torch.amax(mat, dim=0)
    raise ValueError(how)


def _policy_weights(scores, my_idx: int, cfg: ExchangeConfig, n: int):
    """scores: [n] higher = better -> normalised weights [n] incl. self.
    ``top_k`` keeps every peer scoring at least the k-th best peer, so
    ties keep more than k."""
    dev = scores.device
    idx = torch.arange(n, device=dev)
    me = (idx == my_idx).to(F32)
    if cfg.policy == "all":
        return torch.full((n,), 1.0 / n, dtype=F32, device=dev)
    if cfg.policy == "self":
        return me
    if cfg.policy == "top_k":
        k = min(cfg.k, n - 1)
        peer_scores = torch.where(idx == my_idx,
                                  torch.full_like(scores, -float("inf")),
                                  scores)
        thresh = torch.sort(peer_scores).values[-k]
        mask = (peer_scores >= thresh).to(F32)
    elif cfg.policy == "above_average":
        peer_mask = idx != my_idx
        avg = torch.sum(torch.where(peer_mask, scores,
                                    torch.zeros_like(scores))) \
            / torch.clamp(peer_mask.sum(), min=1)
        mask = ((scores >= avg) & peer_mask).to(F32)
    else:
        raise ValueError(cfg.policy)
    n_pick = torch.sum(mask)
    self_w = torch.where(n_pick > 0, cfg.mix_rate, 1.0)
    peer_w = torch.where(n_pick > 0,
                         (1.0 - self_w) / torch.clamp(n_pick, min=1.0), 0.0)
    return mask * peer_w + me * self_w


def _sketch(params, dim: int):
    """Linear sketch of a parameter tree -> [dim] f32: each leaf (in
    sorted-key order) summed over all but its first axis, its leading
    profile added into the accumulator, the sum over ``sqrt(#leaves)``.
    Pairwise L2 distances of sketches keep the krum ranking. A DTensor
    leaf's profile is summed over its shards and made whole on every rank
    of its mesh, as the reference's sketch runs automatic over ``data`` /
    ``model`` inside its shard_map."""
    leaves = tree.leaves(params)
    acc = torch.zeros(dim, dtype=F32, device=leaves[0].device)
    for leaf in leaves:
        s = _full(leaf.sum(dim=tuple(range(1, leaf.dim())), dtype=F32)
                  if leaf.dim() > 1 else leaf.to(F32))
        take = min(s.shape[0], dim)
        acc[:take] += s[:take]
    return acc / torch.sqrt(torch.tensor(float(len(leaves)), dtype=F32,
                                         device=acc.device))


def _krum_scores(sketches):
    """[n, dim] gathered sketches -> [n] scores (higher = better): minus
    each sketch's summed squared distance to its m nearest others."""
    n = sketches.shape[0]
    d = torch.sum((sketches[:, None, :] - sketches[None, :, :]) ** 2, dim=-1)
    d = d + torch.where(torch.eye(n, dtype=torch.bool, device=d.device),
                        float("inf"), 0.0)
    m = max(1, min(n - 1, 2))
    return -torch.sum(torch.sort(d, dim=1).values[:, :m], dim=1)


def _score_row(gathered, score_fn: Callable, score_batch):
    """This pod's scores of every gathered model on its scoring
    microbatch: [n] (minus the loss)."""
    n = int(tree.leaves(gathered)[0].shape[0])
    with torch.no_grad():
        return torch.stack([-score_fn(_pod(gathered, i), score_batch)
                            for i in range(n)])


# --------------------------------------------------------------------------- #
# The exchange
# --------------------------------------------------------------------------- #

def exchange_gathered(gathered, my_idx: int, cfg: ExchangeConfig, *,
                      score_mat=None, sketches=None):
    """The exchange once its inputs are gathered, both forms alike:
    gathered models (leaves [n, ...]), this pod's index and the score
    matrix [scorer, model] (under MultiKRUM the gathered sketches
    [n, dim]) -> (merged params, this pod's weight row [n]). Each leaf
    merges in one ``weighted_sum`` call over its [n, numel] view: float32
    sums in order 0..n-1, cast to the leaf's dtype."""
    n = int(tree.leaves(gathered)[0].shape[0])
    if cfg.scorer == "multikrum":
        scores = _krum_scores(sketches)
    else:
        scores = _collapse_scores(score_mat, cfg.score_policy)
    w = _policy_weights(scores, my_idx, cfg, n)
    merged = tree.tree_map(
        lambda g: weighted_sum(g.reshape(n, -1), w).reshape(g.shape[1:]),
        gathered)
    return merged, w


def _all_gather(t, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _shards(params):
    """(local shards, lift): a tree of DTensors -> each rank's local
    shards and the function that makes such a tree of shards DTensors
    again (same mesh and placements); plain tensors pass through."""
    if not pshard._is_dtensor(tree.leaves(params)[0]):
        return params, lambda t: t
    from torch.distributed.tensor import DTensor
    meta = tree.tree_map(lambda d: (d.device_mesh, tuple(d.placements),
                                    d.shape, d.stride()), params)
    paths = [p for p, _ in tree.leaves_with_paths(params)]

    def lift(t):
        return tree.unflatten(paths, [
            DTensor.from_local(x, mesh, pl, run_check=False, shape=shape,
                               stride=stride)
            for x, (mesh, pl, shape, stride) in zip(tree.leaves(t),
                                                    tree.leaves(meta))])
    return tree.tree_map(lambda d: d.to_local(), params), lift


def _full(x):
    return x.full_tensor() if pshard._is_dtensor(x) else x


def exchange(params, score_fn: Callable, score_batch, cfg: ExchangeConfig,
             group, info: Optional[dict] = None):
    """Process form: this rank is one pod of ``group`` (the mesh's ``pod``
    group). params: the pod's tree, plain tensors or DTensors on the pod's
    (data, model) submesh, whose local shards are what is gathered and
    merged (int8: one scale a whole leaf); score_fn(params, batch) ->
    scalar loss. Returns the merged params; ``info``, if given, receives
    the weight row, the score matrix or sketches, and the gathered models
    (local shards)."""
    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    if cfg.policy == "self" or n == 1:
        return params
    params_dt = params
    params, lift = _shards(params_dt)
    if cfg.policy == "all" and cfg.scorer != "multikrum":
        # no scoring needed: one all-reduce, no gather of whole models
        def mean(p):
            s = p.to(F32, copy=True)
            dist.all_reduce(s, group=group)
            return (s * (1.0 / n)).to(p.dtype)
        return lift(tree.tree_map(mean, params))

    def gather(p, p_dt):
        if cfg.compression != "int8":
            return _all_gather(p, group)
        q, s = _q8(p_dt)      # a DTensor's scale: its whole leaf's amax
        q, s = (q.to_local(), _full(s)) if pshard._is_dtensor(q) else (q, s)
        return _dq8(_all_gather(q, group),
                    _all_gather(s.reshape(1), group)
                    .reshape((n,) + (1,) * p.dim()), p.dtype)

    gathered = tree.tree_map(gather, params, params_dt)
    score_mat = sketches = None
    if cfg.scorer == "multikrum":
        sketches = _all_gather(_sketch(params_dt, cfg.sketch_dim), group)
    else:
        with pshard.dtensor_context(params_dt):
            row = _score_row(gathered,
                             lambda p, b: _full(score_fn(lift(p), b)),
                             score_batch)
        score_mat = _all_gather(row, group)
    merged, w = exchange_gathered(gathered, my_idx, cfg, score_mat=score_mat,
                                  sketches=sketches)
    if info is not None:
        info.update(weights=w, scores=score_mat, sketches=sketches,
                    gathered=gathered)
    return lift(merged)


def exchange_stacked(stack, score_fn: Callable, score_batches,
                     cfg: ExchangeConfig, info: Optional[dict] = None):
    """Stacked form: ``stack`` leaves [P, ...], one pod a row, all on one
    device; ``score_batches`` each pod's scoring microbatch. Returns the
    merged stack; ``info`` as in ``exchange``, with the weight matrix
    W [P, P] (row i: pod i's weights)."""
    P = int(tree.leaves(stack)[0].shape[0])
    if cfg.policy == "self" or P == 1:
        return stack
    if cfg.policy == "all" and cfg.scorer != "multikrum":
        def mean(s):
            m = _mean([s[i].to(F32) for i in range(P)]).to(s.dtype)
            return m.expand(s.shape).contiguous()
        return tree.tree_map(mean, stack)

    def gather(s):
        if cfg.compression != "int8":
            return s
        q, sc = zip(*(_q8(s[i]) for i in range(P)))
        return _dq8(torch.stack(q), torch.stack(sc)
                    .reshape((P,) + (1,) * (s.dim() - 1)), s.dtype)

    gathered = tree.tree_map(gather, stack)
    score_mat = sketches = None
    if cfg.scorer == "multikrum":
        sketches = torch.stack([_sketch(_pod(stack, i), cfg.sketch_dim)
                                for i in range(P)])
    else:
        score_mat = torch.stack([_score_row(gathered, score_fn, b)
                                 for b in score_batches])
    out = tree.tree_map(torch.empty_like, gathered)
    rows = []
    for i in range(P):
        merged, w = exchange_gathered(gathered, i, cfg, score_mat=score_mat,
                                      sketches=sketches)
        tree.tree_map(lambda o, m: o[i].copy_(m), out, merged)
        del merged
        rows.append(w)
    if info is not None:
        info.update(weights=torch.stack(rows), scores=score_mat,
                    sketches=sketches, gathered=gathered)
    return out


# --------------------------------------------------------------------------- #
# Round-step builders
# --------------------------------------------------------------------------- #

def _pod(t, i: int):
    """Pod ``i``'s block of a stacked tree; a leaf without a pod dim (a
    decode position) is shared."""
    return tree.tree_map(
        lambda x: x[i] if isinstance(x, torch.Tensor) and x.dim() > 0 else x,
        t)


def make_train_step(model: Model, lr: float = 0.01):
    """Single-silo train step: SGD on model.loss (the paper's client opt),
    the parameter dtype kept: ``(p.f32 - lr * g.f32).to(p.dtype)`` (not
    ``optim/local.py``'s float32 promotion). The gradient is
    ``torch.autograd.grad``, which frees each saved activation once the
    backward has used it. DTensor params run under
    ``pshard.dtensor_context`` and their gradients are pinned to their
    placements. ``train_step(params, batch, info)`` puts the gradients in
    ``info["grads"]``, if given."""

    def train_step(params, batch, info=None):
        paths, leaves = zip(*tree.leaves_with_paths(params))
        leaves = [p.detach().requires_grad_() for p in leaves]
        with pshard.dtensor_context(leaves):
            loss, metrics = model.loss(tree.unflatten(list(paths), leaves),
                                       batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            # pin each gradient to its parameter's placements (the
            # reference's constraint, exchange.py:224-230): under fsdp the
            # Partial -> Shard redistribute is the reduce-scatter
            grads = [_pin(g, p) for g, p in zip(grads, leaves)]
            new = [(p.detach().to(F32) - lr * g.to(F32)).to(p.dtype)
                   for p, g in zip(leaves, grads)]
        if info is not None:
            info["grads"] = tree.unflatten(list(paths), grads)
        del grads
        return (tree.unflatten(list(paths), new),
                {k: v.detach() for k, v in metrics.items()})

    return train_step


def _pin(g, p):
    if not pshard._is_dtensor(p) or tuple(g.placements) == \
            tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _pod_block(x):
    """A leaf stacked [P, ...] on a (pod, data, model) mesh, ``pod`` on
    its leading dim -> this rank's pod's block as a DTensor on the (data,
    model) submesh (no communication)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh, names = x.device_mesh, tuple(x.device_mesh.mesh_dim_names)
    pl = [Shard(p.dim - 1) if p.is_shard() else p
          for n, p in zip(names, x.placements) if n != "pod"]
    shape = tuple(x.shape[1:])
    return DTensor.from_local(x.to_local()[0], pshard.submesh(mesh), pl,
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _pod_stack(d, mesh):
    """Inverse of ``_pod_block``: a pod's DTensor on the submesh -> its
    block of the [P, ...] stack on ``mesh``."""
    from torch.distributed.tensor import DTensor, Shard
    names = tuple(mesh.mesh_dim_names)
    sub = iter(d.placements)
    pl = [Shard(0) if n == "pod" else
          (lambda p: Shard(p.dim + 1) if p.is_shard() else p)(next(sub))
          for n in names]
    shape = (mesh.size(names.index("pod")),) + tuple(d.shape)
    return DTensor.from_local(d.to_local()[None], mesh, pl, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _contiguous_stride(shape):
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def make_unifyfl_round_step(model: Model, mesh, ex_cfg: ExchangeConfig,
                            lr: float = 0.01):
    """Multi-pod round: params stacked on a leading pod dim, batch leaves
    [P, B, ...]; returns (merged params [P, ...], losses [P]).

    ``mesh`` None: the stacked form, all P pods on one device. A
    ``DeviceMesh`` with a ``pod`` dimension: the process form, each rank
    passing its block (P = 1) and the exchange running over the pod
    group. ``round_step(params, batch, info)`` fills ``info``, if given,
    with the trained stack ("trained") and what ``exchange_stacked`` /
    ``exchange`` put there."""
    train_step = make_train_step(model, lr)

    def score_fn(p, b):
        return model.loss(p, b)[0]

    def score_rows(b):
        return tree.tree_map(lambda x: x[:ex_cfg.score_batch], b)

    def train_pods(params, batch):
        trained = tree.tree_map(torch.empty_like, params)
        losses = []
        for i in range(int(tree.leaves(params)[0].shape[0])):
            new, metrics = train_step(_pod(params, i), _pod(batch, i))
            tree.tree_map(lambda o, p: o[i].copy_(p), trained, new)
            del new
            losses.append(metrics["loss"])
        return trained, torch.stack(losses)

    if mesh is None:
        def round_step(params, batch, info=None):
            trained, losses = train_pods(params, batch)
            if info is not None:
                info["trained"] = trained
            out = exchange_stacked(
                trained, score_fn,
                [score_rows(_pod(batch, i)) for i in range(losses.shape[0])],
                ex_cfg, info)
            return out, losses
        return round_step

    group = mesh.get_group("pod")

    def round_step_dtensor(params, batch, info=None):
        """params, batch: [P, ...] DTensors on ``mesh``, ``pod`` on the
        leading dim; each rank's pod trains and exchanges its block."""
        blocks = tree.tree_map(_pod_block, params)
        b = tree.tree_map(_pod_block, batch)
        with pshard.use_mesh(mesh), pshard.manual_axes(("pod",)):
            trained, metrics = train_step(blocks, b)
            if info is not None:
                info["trained"] = trained
            merged = exchange(trained, score_fn, score_rows(b), ex_cfg,
                              group, info)
        return (tree.tree_map(lambda d: _pod_stack(d, mesh), merged),
                _full(metrics["loss"])[None])

    def round_step(params_blk, batch_blk, info=None):
        if pshard._is_dtensor(tree.leaves(params_blk)[0]):
            return round_step_dtensor(params_blk, batch_blk, info)
        _one_block(params_blk)
        trained, losses = train_pods(params_blk, batch_blk)
        if info is not None:
            info["trained"] = trained
        merged = exchange(_pod(trained, 0), score_fn,
                          score_rows(_pod(batch_blk, 0)), ex_cfg, group, info)
        return tree.tree_map(lambda x: x[None], merged), losses

    return round_step


def _one_block(params) -> None:
    n = int(tree.leaves(params)[0].shape[0])
    if n != 1:
        raise ValueError(f"a rank of the pod mesh passes its own block "
                         f"[1, ...], got {n} pods")


def make_pod_serve_step(model: Model, mesh, kind: str):
    """Multi-pod serving: each pod serves its own silo model (no cross-pod
    collectives). kind 'prefill': (params, batch) -> (logits, cache);
    'decode': (params, batch {'token' [P, B], 'pos'}, cache) -> (logits,
    cache), every output stacked [P, ...]. ``mesh`` as in
    ``make_unifyfl_round_step``: with one, the blocks are the rank's
    own."""

    def per_pod(params, step):
        if pshard._is_dtensor(tree.leaves(params)[0]):
            return per_pod_dtensor(params, step)
        if mesh is not None:
            _one_block(params)
        outs = [step(i) for i in range(int(tree.leaves(params)[0].shape[0]))]
        return (torch.stack([o[0] for o in outs]),
                tree.tree_map(lambda *c: torch.stack(c), *[o[1] for o in outs]))

    def per_pod_dtensor(params, step):
        """Each rank serves its own pod's block on the (data, model)
        submesh; the outputs restacked on ``mesh``."""
        with pshard.use_mesh(mesh), pshard.manual_axes(("pod",)), \
                pshard.dtensor_context(params):
            logits, cache = step(None)
        return (_pod_stack(logits, mesh),
                tree.tree_map(lambda d: _pod_stack(d, mesh), cache))

    def block(t, i):
        """Pod ``i``'s block, or under DTensors (i None) this rank's; a
        plain int (a decode position) is shared."""
        if i is not None:
            return _pod(t, i)
        return tree.tree_map(
            lambda x: _pod_block(x) if pshard._is_dtensor(x) else x, t)

    if kind == "decode":
        def serve_step(params, batch, cache):
            return per_pod(params, lambda i: model.decode_step(
                block(params, i), block(batch, i), block(cache, i)))
    else:
        def serve_step(params, batch):
            return per_pod(params, lambda i: model.prefill(
                block(params, i), block(batch, i)))
    return serve_step
