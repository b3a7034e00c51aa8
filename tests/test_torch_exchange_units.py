"""The pure functions of the pod exchange, port against reference, on the
same numpy inputs: the score collapse, the policy weights, the one-scale
int8 round trip (bit for bit) and the MultiKRUM sketch (1e-6 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exchange as jex
from repro_torch.core import exchange as tex

torch.set_num_threads(1)

SKETCH_REL = 1e-6
HOWS = ("median", "mean", "min", "max")


def _scores(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    if ties:     # few distinct values: ties at the threshold and the average
        return rng.integers(0, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("scorers", [1, 2, 3, 4, 5])
def test_collapse_scores_matches_the_reference(how, scorers):
    """Odd and even scorer counts: an even median averages the two middle
    values, as ``jnp.median`` does."""
    for seed in range(4):
        mat = _scores(seed, (scorers, 5), ties=seed % 2 == 1)
        want = np.asarray(jex._collapse_scores(jnp.asarray(mat), how))
        got = tex._collapse_scores(torch.from_numpy(mat), how).numpy()
        np.testing.assert_array_equal(got, want)


def test_collapse_median_of_two_is_their_mean():
    mat = torch.tensor([[1.0, 4.0], [2.0, 8.0]])
    assert tex._collapse_scores(mat, "median").tolist() == [1.5, 6.0]


@pytest.mark.parametrize("policy", ["all", "self", "top_k", "above_average"])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_policy_weights_match_the_reference(policy, n):
    """Every ``my_idx``, k from 1 to n, random scores and tied ones."""
    for seed in range(6):
        scores = _scores(seed, (n,), ties=seed % 2 == 1)
        for k in range(1, n + 1):
            jcfg = jex.ExchangeConfig(policy=policy, k=k, mix_rate=0.5)
            tcfg = tex.ExchangeConfig(policy=policy, k=k, mix_rate=0.5)
            for my_idx in range(n):
                want = np.asarray(jex._policy_weights(
                    jnp.asarray(scores), jnp.int32(my_idx), jcfg, n))
                got = tex._policy_weights(torch.from_numpy(scores), my_idx,
                                          tcfg, n).numpy()
                np.testing.assert_array_equal(got, want, err_msg=str(
                    (policy, seed, k, my_idx, scores)))


def test_top_k_ties_keep_more_than_k():
    cfg = tex.ExchangeConfig(policy="top_k", k=1, mix_rate=0.5)
    w = tex._policy_weights(torch.tensor([0.0, 0.7, 0.7, 0.1]), 0, cfg, 4)
    assert w.tolist() == [0.5, 0.25, 0.25, 0.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 32), (7,), (3, 5, 11)])
def test_q8_round_trip_is_the_references_bit_for_bit(dtype, shape):
    """Codes, the scale and the dequantized leaf, eager and jitted, with
    a leaf of zeros (scale 1) among them."""
    for seed in range(3):
        x = np.random.default_rng(seed).standard_normal(shape) * 3
        if seed == 2:
            x = np.zeros(shape)
        jx = jnp.asarray(x, dtype)
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            getattr(torch, dtype))
        q, s = tex._q8(tx)
        back = tex._dq8(q, s, tx.dtype)
        for fn in (lambda v: jex._q8(v), jax.jit(jex._q8)):
            jq, js = fn(jx)
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            assert s.item() == float(js)
            jb = jex._dq8(jq, js, jx.dtype)
            np.testing.assert_array_equal(back.to(torch.float32).numpy(),
                                          np.asarray(jb, np.float32))
        # the codes' round trip, before the cast to the leaf's dtype
        amax = float(tx.to(torch.float32).abs().max())
        err = (tex._dq8(q, s, torch.float32) - tx.to(torch.float32)).abs()
        assert float(err.max()) <= amax / 127 * 0.51 + 1e-6


def test_q8_scale_is_the_compiled_product_not_the_division():
    """XLA turns the reference's ``amax / 127.0`` into ``amax * f32(1/127)``;
    on 300 random leaves the two differ in 11, and the port gives the
    reference's scale on every one."""
    rng = np.random.default_rng(0)
    leaves = [(rng.standard_normal(16) * rng.uniform(0.1, 10)).astype(
        np.float32) for _ in range(300)]
    q8 = jax.jit(jex._q8)
    want = np.array([float(q8(jnp.asarray(x))[1]) for x in leaves],
                    np.float32)
    got = np.array([tex._q8(torch.from_numpy(x))[1].item() for x in leaves],
                   np.float32)
    np.testing.assert_array_equal(got, want)
    divided = np.array([np.abs(x).max() / np.float32(127) for x in leaves])
    assert (divided != want).sum() > 0


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((40, 3, 4)).astype(np.float32),
                  "bias": rng.standard_normal((40,)).astype(np.float32)},
            "a": rng.standard_normal((5000, 2)).astype(np.float32) * 2,
            "z": rng.standard_normal((9, 17)).astype(np.float32)}


@pytest.mark.parametrize("dim", [16, 256, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sketch_matches_the_reference(dim, dtype):
    """Leaves in sorted-key order (``1/sqrt(#leaves)`` and the order the
    profiles add in), leading dims shorter and longer than ``dim``."""
    tree = _tree(dim, dtype)
    jt = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    tt = jax.tree.map(lambda a: torch.from_numpy(
        np.array(jnp.asarray(a, dtype).astype(jnp.float32))).to(
            getattr(torch, dtype)), tree)
    want = np.asarray(jex._sketch(jt, dim))
    got = tex._sketch(tt, dim).numpy()
    assert got.shape == want.shape == (dim,)
    assert np.abs(got - want).max() <= SKETCH_REL * np.abs(want).max()


def test_krum_scores_match_the_references_formula():
    """The sketch distances and scores as the reference's exchange writes
    them inline (``repro/core/exchange.py:176-181``)."""
    for n in (2, 3, 5):
        sks = _scores(n, (n, 64))
        d = jnp.sum((sks[:, None, :] - sks[None, :, :]) ** 2, axis=-1)
        d = d + jnp.where(jnp.eye(n, dtype=bool), jnp.inf, 0.0)
        m = max(1, min(n - 1, 2))
        want = np.asarray(-jnp.sum(jnp.sort(d, axis=1)[:, :m], axis=1))
        got = tex._krum_scores(torch.from_numpy(sks)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
