"""The stacked multi-pod round step (``repro_torch.core.exchange``) against
the reference's ``make_train_step`` + ``exchange`` under
``jax.vmap(axis_name="pod")``, on one device, at the float32 ``qwen3-1.7b``
smoke preset with the reference's pods installed through ``interop``.

The configurations of the reference's own test at P = 2, and ``top_k``
k = 1 and ``above_average`` at P = 3, where the policy chooses between
peers. Gates: W within W_TOL, every merged leaf within MERGED_REL of its
largest entry, losses within LOSS_TOL. The reference's W is its own
functions (``_q8``, ``_dq8``, ``_sketch``, ``_collapse_scores``,
``_policy_weights``) composed as its ``exchange`` composes them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.core import exchange as jex
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import exchange as tex
from repro_torch.interop import params_from_numpy
from repro_torch.launch.serve import pad_cache
from repro_torch.models import build_model as tbuild

torch.set_num_threads(1)

ARCH = "qwen3-1.7b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
LR = 0.1
W_TOL = 1e-6
MERGED_REL = 1e-5
LOSS_TOL = 1e-5

CONFIGS = {
    "all": dict(policy="all"),
    "top_k": dict(policy="top_k", k=1),
    "top_k-int8": dict(policy="top_k", k=1, compression="int8"),
    "above_average-multikrum": dict(policy="above_average",
                                    scorer="multikrum"),
    "above_average": dict(policy="above_average"),
}


class Pods:
    """P reference inits of the smoke preset, stacked, and a batch of 4 x
    32 tokens a pod (targets rolled by one), on both sides."""

    def __init__(self, P):
        self.P = P
        self.jm = jbuild(jreplace(jsmoke(ARCH), **F32))
        self.tm = tbuild(treplace(tsmoke(ARCH), **F32))
        keys = jax.random.split(jax.random.PRNGKey(0), P)
        self.jparams = jax.jit(jax.vmap(self.jm.init))(keys)
        toks = np.random.default_rng(3).integers(
            0, self.jm.cfg.vocab_size, (P, 4, 32))
        tgts = np.roll(toks, -1, axis=2)
        self.jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
                       "targets": jnp.asarray(tgts, jnp.int32)}
        self.tbatch = {"tokens": torch.from_numpy(toks),
                       "targets": torch.from_numpy(tgts)}
        self._trained = None

    def trained(self):
        """The reference's pods after one ``make_train_step``."""
        if self._trained is None:
            self._trained = jax.jit(jax.vmap(jex.make_train_step(
                self.jm, lr=LR)))(self.jparams, self.jbatch)[0]
        return self._trained

    def tparams(self):
        return params_from_numpy(jax.tree.map(np.asarray, self.jparams),
                                 "cpu")


_PODS = {}


def pods(P):
    if P not in _PODS:
        _PODS[P] = Pods(P)
    return _PODS[P]


def ref_round(pd, cfg):
    """The reference's round under vmap over 'pod': (merged, losses)."""
    ts = jex.make_train_step(pd.jm, lr=LR)

    def per_pod(p, b):
        new, metrics = ts(p, b)
        sb = jax.tree.map(lambda x: x[:cfg.score_batch], b)
        merged = jex.exchange(new, lambda q, c: pd.jm.loss(q, c)[0], sb, cfg,
                              n_pods=pd.P)
        return merged, metrics["loss"]

    return jax.jit(jax.vmap(per_pod, axis_name="pod"))(pd.jparams, pd.jbatch)


def ref_weights(pd, cfg):
    """W [P, P] of the reference's exchange, from its own functions on its
    trained pods: the gathered models (int8 round trip, one scale a leaf),
    the score matrix [scorer, model] or the sketch distances, the
    collapse and the policy, row i for pod i."""
    P = pd.P

    def weights(trained, batch):
        if cfg.compression == "int8":
            gathered = jax.tree.map(jax.vmap(
                lambda s: jex._dq8(*jex._q8(s), s.dtype)), trained)
        else:
            gathered = trained
        if cfg.scorer == "multikrum":
            sks = jax.vmap(lambda t: jex._sketch(t, cfg.sketch_dim))(trained)
            d = jnp.sum((sks[:, None, :] - sks[None, :, :]) ** 2, axis=-1)
            d = d + jnp.where(jnp.eye(P, dtype=bool), jnp.inf, 0.0)
            m = max(1, min(P - 1, 2))
            scores = -jnp.sum(jnp.sort(d, axis=1)[:, :m], axis=1)
        else:
            rows = jax.tree.map(lambda x: x[:, :cfg.score_batch], batch)
            mat = jax.vmap(lambda b: jax.vmap(
                lambda g: -pd.jm.loss(g, b)[0])(gathered))(rows)
            scores = jex._collapse_scores(mat, cfg.score_policy)
        return jnp.stack([jex._policy_weights(scores, jnp.int32(i), cfg, P)
                          for i in range(P)])

    return np.asarray(jax.jit(weights)(pd.trained(), pd.jbatch))


@pytest.mark.parametrize("P,name", [(2, "all"), (2, "top_k"),
                                    (2, "top_k-int8"),
                                    (2, "above_average-multikrum"),
                                    (3, "top_k"), (3, "above_average")])
def test_stacked_round_step_is_the_references_under_vmap(P, name):
    pd = pods(P)
    jcfg = jex.ExchangeConfig(**CONFIGS[name])
    tcfg = tex.ExchangeConfig(**CONFIGS[name])
    jout, jloss = ref_round(pd, jcfg)
    info = {}
    step = tex.make_unifyfl_round_step(pd.tm, None, tcfg, lr=LR)
    tout, tloss = step(pd.tparams(), pd.tbatch, info)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=0,
                               atol=LOSS_TOL)
    got = tree.leaves_with_paths(tout)
    want = jax.tree.leaves(jout)
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, path
        err = np.abs(a - b).max()
        assert err <= MERGED_REL * np.abs(b).max(), (path, err)
    if name == "all":
        assert "weights" not in info    # the fast path gathers nothing
        return
    w = info["weights"].numpy()
    np.testing.assert_allclose(w, ref_weights(pd, jcfg), rtol=0, atol=W_TOL)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=0, atol=1e-6)
    if P == 3:      # each pod chose between its two peers
        assert all((row == 0).sum() >= 1 for row in w), w


def test_int8_round_stays_near_the_uncompressed_one():
    """The reference test's bound: every leaf of the int8 round within
    0.05 of the uncompressed ``top_k`` round."""
    pd = pods(2)
    outs = [tex.make_unifyfl_round_step(
        pd.tm, None, tex.ExchangeConfig(**CONFIGS[n]), lr=LR)(
            pd.tparams(), pd.tbatch)[0] for n in ("top_k", "top_k-int8")]
    err = max(float((a - b).abs().max())
              for a, b in zip(*(tree.leaves(o) for o in outs)))
    assert err < 0.05, err


def test_all_is_the_mean_of_the_pods_trained_apart():
    """The reference test's first gate, bit for bit here: each pod's merged
    leaves are the f32 mean of the two pods' ``make_train_step`` outputs,
    and the pods agree."""
    pd = pods(2)
    params = pd.tparams()
    out, _ = tex.make_unifyfl_round_step(
        pd.tm, None, tex.ExchangeConfig(policy="all"), lr=LR)(params,
                                                              pd.tbatch)
    ts = tex.make_train_step(pd.tm, lr=LR)
    apart = [ts(tex._pod(params, i), tex._pod(pd.tbatch, i))[0]
             for i in range(2)]
    for o, a, b in zip(tree.leaves(out), *(tree.leaves(t) for t in apart)):
        assert torch.equal(o[0], (a + b) * 0.5)
        assert torch.equal(o[0], o[1])


def test_bf16_train_step_is_the_references():
    """One SGD step of a bf16 model keeps bf16 (the float32 promotion of
    ``optim/local.py`` is not this step's), within one bf16 ulp of each
    leaf's largest entry. (float32: the round-step tests.)"""
    pd = pods(2)
    dtype = "bfloat16"
    over = dict(param_dtype=dtype, compute_dtype=dtype)
    jm = jbuild(jreplace(jsmoke(ARCH), **over))
    tm = tbuild(treplace(tsmoke(ARCH), **over))
    ref = jax.jit(jm.init)(jax.random.PRNGKey(1))
    b = {k: v[0] for k, v in pd.jbatch.items()}
    jnew, jmet = jax.jit(jex.make_train_step(jm, lr=LR))(ref, b)
    tnew, tmet = tex.make_train_step(tm, lr=LR)(
        params_from_numpy(jax.tree.map(np.asarray, ref), "cpu"),
        {k: v[0] for k, v in pd.tbatch.items()})
    rel = 2.0 ** -7
    for (path, a), w in zip(tree.leaves_with_paths(tnew),
                            jax.tree.leaves(jnew)):
        assert str(a.dtype).endswith(dtype), path
        a = a.to(torch.float32).numpy()
        w = np.asarray(w, np.float32)
        assert np.abs(a - w).max() <= rel * np.abs(w).max(), path
    want = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - want) <= rel * abs(want)


def test_pod_serve_step_is_each_pods_own_serving():
    """``make_pod_serve_step``: prefill 2 x 12 tokens a pod, the cache
    padded to 14 as ``serve`` pads it, two decode steps; each pod's logits
    and cache are the reference model's on that pod's params alone."""
    pd = pods(2)
    S, steps = 12, 2
    toks = np.random.default_rng(5).integers(0, pd.jm.cfg.vocab_size,
                                             (2, 2, S))
    ids = np.random.default_rng(6).integers(0, pd.jm.cfg.vocab_size,
                                            (2, 2, steps))
    prefill = jax.jit(pd.jm.prefill)
    decode = jax.jit(pd.jm.decode_step)
    want = []
    for i in range(2):
        p = jax.tree.map(lambda x: x[i], pd.jparams)
        logits, cache = prefill(p, {"tokens": jnp.asarray(toks[i])})
        row = [logits]
        full = pd.jm.init_cache(2, S + steps)
        cache = jax.tree.map(
            lambda f, g: jax.lax.dynamic_update_slice(f, g.astype(f.dtype),
                                                      (0,) * f.ndim)
            if f.shape != g.shape else g, full, cache)
        for s in range(steps):
            logits, cache = decode(p, {"token": jnp.asarray(ids[i, :, s]),
                                       "pos": jnp.int32(S + s)}, cache)
            row += [logits, *jax.tree.leaves(cache)]
        want.append(row)
    params = pd.tparams()
    pre = tex.make_pod_serve_step(pd.tm, None, "prefill")
    dec = tex.make_pod_serve_step(pd.tm, None, "decode")
    with torch.inference_mode():
        logits, cache = pre(params, {"tokens": torch.from_numpy(toks)})
        got = [[logits[i]] for i in range(2)]
        cache = pad_cache(tree.tree_map(
            lambda c: torch.zeros((2,) + tuple(c.shape), dtype=c.dtype),
            pd.tm.init_cache(2, S + steps, "cpu")), cache)
        for s in range(steps):
            logits, cache = dec(params, {"token": torch.from_numpy(
                ids[:, :, s]), "pos": S + s}, cache)
            for i in range(2):    # decode writes the cache in place
                got[i] += [logits[i], *[c[i].clone()
                                        for c in tree.leaves(cache)]]
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= MERGED_REL * np.abs(w).max()
