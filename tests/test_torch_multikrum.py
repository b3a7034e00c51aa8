"""MultiKRUM in the port against the JAX reference, on the same numpy inputs:
the ops layer (``pairwise_dists``, ``multikrum_scores`` and their int8
twins) and ``core/scoring.py``. The reference runs its Pallas kernels in
interpret mode.

Tolerances scale with the norms, not with the distances: a distance is
``sq_i + sq_j - 2 G_ij`` and cancels, so both packages' float32 sums (taken
in other orders) leave an absolute error of a few ulps of ``‖x_i‖·‖x_j‖``
in it, whatever its size. Gram entries agree within ``RTOL·‖x_i‖·‖x_j‖``
and distances within ``4·RTOL·max‖x‖²``, RTOL = 2^-16 (the float32 epsilon
times a margin of 2^8 for sums over up to 131,072 terms).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import scoring as jscoring
from repro.core import wire as jwire
from repro.kernels import ops as jops
from repro.kernels import q8agg as jq8
from repro.models import build_model as jbuild
from repro_torch.core import scoring as tscoring
from repro_torch.core import wire as twire
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import q8agg as tq8

RTOL = 2.0 ** -16


def _models(m, n, seed, spread=0.02):
    """m models around a common centre: small distances, large norms (the
    cancelling case MultiKRUM sees in a round)."""
    rng = np.random.default_rng(seed)
    centre = rng.standard_normal(n).astype(np.float32) * 0.05
    return np.stack([centre + rng.standard_normal(n).astype(np.float32)
                     * spread * (1 + i) for i in range(m)])


def _q8(m, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (m, n)).astype(np.int8)
    s = rng.uniform(1e-4, 1e-3, (m, n // 1024)).astype(np.float32)
    return q, s


def _dequant(q, s):
    m, n = q.shape
    return (q.reshape(m, -1, 1024).astype(np.float64)
            * s[:, :, None]).reshape(m, n)


def _assert_dists(got, want, x):
    sq = (np.asarray(x, np.float64) ** 2).sum(1)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= 4 * RTOL * sq.max(), (err.max(), sq.max())


def _assert_scores(got, want, x, m):
    sq = (np.asarray(x, np.float64) ** 2).sum(1)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= 4 * RTOL * sq.max() * m, (err.max(), sq.max())


@pytest.mark.parametrize("m,n", [(2, 4096), (3, 62_006), (5, 10_000)])
def test_pairwise_dists_and_scores_match(m, n):
    x = _models(m, n, m + n)
    got = tops.pairwise_dists(torch.from_numpy(x))
    assert got.shape == (m, m) and got.dtype == torch.float32
    _assert_dists(got.numpy(), jops.pairwise_dists(jnp.asarray(x)), x)
    for k in (1, 2, m + 3):
        _assert_scores(tops.multikrum_scores(torch.from_numpy(x), k).numpy(),
                       jops.multikrum_scores(jnp.asarray(x), k), x,
                       min(k, m - 1))


@pytest.mark.parametrize("m,n", [(3, 131_072), (4, 5_120)])
def test_gram_q8_and_q8_scores_match(m, n):
    q, s = _q8(m, n, m * n)
    x = _dequant(q, s)
    norms = np.sqrt((x ** 2).sum(1))
    qp, sp = (np.pad(q, ((0, 0), (0, -n % 4096))),
              np.pad(s, ((0, 0), (0, (-n % 4096) // 1024))))
    g_j, sq_j = jq8.gram_q8(jnp.asarray(qp), jnp.asarray(sp), interpret=True)
    g_t, sq_t = tq8.gram_q8(torch.from_numpy(qp), torch.from_numpy(sp))
    bound = RTOL * np.outer(norms, norms)
    assert (np.abs(g_t.numpy() - np.asarray(g_j)) <= bound).all()
    assert (np.abs(sq_t.numpy()[:, 0] - np.asarray(sq_j)[:, 0])
            <= RTOL * norms ** 2).all()
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    _assert_dists(tops.pairwise_dists_q8(qt, st).numpy(),
                  jops.pairwise_dists_q8(jnp.asarray(q), jnp.asarray(s)), x)
    _assert_scores(tops.multikrum_scores_q8(qt, st, 2).numpy(),
                   jops.multikrum_scores_q8(jnp.asarray(q), jnp.asarray(s), 2),
                   x, 2)


@pytest.mark.parametrize("seed", [0, 11, 1688, 4242])
@pytest.mark.parametrize("m", [2, 4])
def test_pairwise_dists_metric_properties(m, seed):
    """Symmetric, non-negative, and a diagonal that is 0 up to the
    cancellation error of ‖x_i‖² - ‖x_i‖² (not a fixed atol: at N = 513 the
    reference's own diagonal reaches 1e-3)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, 513)).astype(np.float32) * rng.uniform(0.1, 10)
    d = tops.pairwise_dists(torch.from_numpy(x)).numpy()
    sq = (x.astype(np.float64) ** 2).sum(1)
    assert (d >= 0).all()
    np.testing.assert_array_equal(d, d.T)
    assert (np.abs(np.diag(d)) <= 4 * RTOL * sq).all()
    exact = ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    assert np.abs(d - exact).max() <= 4 * RTOL * sq.max()


# --------------------------------------------------------------------------- #
# core/scoring.py
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def round_models():
    import jax
    base = jax.tree.map(np.asarray, jbuild(get_config("paper-cnn")).init(
        jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    return [jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(
        a.dtype) * 0.01 * (1 + i), base) for i in range(4)]


def _flat(models):
    return np.stack([np.concatenate([np.ravel(p[k][w]) for k in sorted(p)
                                     for w in sorted(p[k])]) for p in models])


def test_multikrum_scores_for_round_matches(round_models):
    got = tscoring.multikrum_scores_for_round(
        [params_from_numpy(p, "cpu") for p in round_models], 2)
    want = jscoring.multikrum_scores_for_round(
        [{k: {w: jnp.asarray(a) for w, a in v.items()} for k, v in p.items()}
         for p in round_models], 2)
    assert isinstance(got, list) and len(got) == 4
    assert all(g < 0 for g in got)                 # negated: higher = better
    _assert_scores(got, want, _flat(round_models), 2)
    assert np.argmax(got) == np.argmax(want)


def _decoded(vecs, methods, pkg):
    """One model per method, through each package's own wire codec."""
    out = []
    for v, method in zip(vecs, methods):
        if pkg == "t":
            env = twire.encode_vec(torch.from_numpy(v), method)
            out.append(twire.decode_store(
                {f"['{k}']": a for k, a in env.to_store().items()}, "cpu"))
        else:
            env = jwire.encode_vec(jnp.asarray(v), method)
            out.append(jwire.decode_flat(
                {f"['{k}']": a for k, a in env.to_store().items()}))
    return out


@pytest.mark.parametrize("methods", [("int8",) * 3, ("raw",) * 3,
                                     ("int8", "raw", "int8")],
                         ids=["q8-fused", "raw", "mixed"])
def test_multikrum_scores_for_decoded_matches(round_models, methods):
    vecs = list(_flat(round_models[:3]))
    got = tscoring.multikrum_scores_for_decoded(
        _decoded(vecs, methods, "t"), 2)
    want = jscoring.multikrum_scores_for_decoded(
        _decoded(vecs, methods, "j"), 2)
    _assert_scores(got, want, np.stack(vecs), 2)


def test_multikrum_sketched_matches_and_caches(round_models):
    tscoring._JL_CACHE.clear()
    models_t = [params_from_numpy(p, "cpu") for p in round_models]
    models_j = [{k: {w: jnp.asarray(a) for w, a in v.items()}
                 for k, v in p.items()} for p in round_models]
    got = tscoring.multikrum_sketched(models_t, 2, sketch_dim=512, seed=5)
    want = jscoring.multikrum_sketched(models_j, 2, sketch_dim=512, seed=5)
    # projections of the same draws; float32 products in another order
    np.testing.assert_allclose(got, want, rtol=1e-4)
    idx_t, proj_t = tscoring._JL_CACHE[(62_006, 512, 5)]
    idx_j, proj_j = jscoring._jl_projection(62_006, 512, 5)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(proj_t.numpy(), np.asarray(proj_j))
    assert tscoring.multikrum_sketched(models_t, 2, sketch_dim=512,
                                       seed=5) == got
    assert len(tscoring._JL_CACHE) == 1
    for seed in range(tscoring.MAX_JL_CACHE + 2):
        tscoring._jl_projection(1000, 16, seed)
    assert len(tscoring._JL_CACHE) == tscoring.MAX_JL_CACHE
