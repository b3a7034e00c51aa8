"""Port kernel layer vs the JAX reference: the plain versions (the port's CPU
path) against ``repro.kernels.ops`` running its Pallas kernels in interpret
mode, on the same numpy inputs.

quantize / dequantize are bit-exact; the weighted sums agree to 1e-6
relative (float32 sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.configs import get_config
from repro.models import build_model as jbuild
from repro_torch.kernels import ops as tops
from repro_torch.interop import params_from_numpy

RTOL = 1e-6


def _vec(n, seed, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def _with_edge_tiles(x):
    """An all-zero tile and a tile of exact .5 ties (scale exactly 1.0)."""
    x = x.copy()
    x[:1024] = 0.0
    if len(x) >= 2048:
        ties = (np.arange(1024) % 200 - 100.5).astype(np.float32)
        ties[0] = 127.0
        x[1024:2048] = ties
    return x


def _q8(m, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (m, n)).astype(np.int8)
    s = rng.uniform(1e-4, 0.05, (m, n // 1024)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, m).astype(np.float32)
    return q, s, w


def _rel_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= RTOL * scale


@pytest.mark.parametrize("n", [1000, 62_006, 131_072 + 5])
def test_quantize_bit_exact_with_wire_padding(n):
    x = _with_edge_tiles(_vec(n, n))
    jq, js, jn = jops.quantize(jnp.asarray(x))
    tq, ts, tn = tops.quantize(torch.from_numpy(x))
    assert jn == tn == n
    assert tq.shape[0] % tops.QUANT_BLOCK == 0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dequantize_and_batch_bit_exact():
    q, s, _ = _q8(3, 131_072, 1)
    n = 100_000
    one_j = jops.dequantize(jnp.asarray(q[0]), jnp.asarray(s[0]), n)
    one_t = tops.dequantize(torch.from_numpy(q[0]), torch.from_numpy(s[0]), n)
    np.testing.assert_array_equal(one_t.numpy(), np.asarray(one_j))
    bj = jops.dequantize_batch(jnp.asarray(q), jnp.asarray(s), n)
    bt = tops.dequantize_batch(torch.from_numpy(q), torch.from_numpy(s), n)
    assert bt.shape == (3, n)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("m,n", [(2, 62_006), (5, 4096)])
def test_weighted_sum_matches(m, n):
    x = np.stack([_vec(n, 10 + i, 1.0) for i in range(m)])
    w = np.random.default_rng(m).uniform(0.1, 1, m).astype(np.float32)
    _rel_close(tops.weighted_sum(torch.from_numpy(x), torch.from_numpy(w)),
               jops.weighted_sum(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("m,np_,n", [(2, 131_072, 62_006), (3, 5120, 5000)])
def test_weighted_sum_q8_matches(m, np_, n):
    q, s, w = _q8(m, np_, m)
    got = tops.weighted_sum_q8(torch.from_numpy(q), torch.from_numpy(s),
                               torch.from_numpy(w), n)
    want = jops.weighted_sum_q8(jnp.asarray(q), jnp.asarray(s),
                                jnp.asarray(w), n)
    assert got.shape == (n,)
    _rel_close(got, want)


def test_flatten_follows_jax_leaf_order():
    """Sorted keys, recursively (conv1.b, conv1.w, conv2.b, ...), never
    insertion order: flat vectors, and with them wire bytes, match."""
    ref = jax.tree.map(np.asarray,
                       jbuild(get_config("paper-cnn")).init(
                           jax.random.PRNGKey(0)))
    # insertion order deliberately reversed
    shuffled = {k: dict(reversed(list(v.items())))
                for k, v in reversed(list(ref.items()))}
    tp = params_from_numpy(shuffled, "cpu")
    tv, spec = tops.flatten_pytree(tp)
    jv, jspec = jops.flatten_pytree(jax.tree.map(jnp.asarray, ref))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tops.spec_length(spec) == jops.spec_length(jspec) == 62_006
    back = tops.unflatten_pytree(tv, spec)
    for (p, a), (_, b) in zip(tops.tree.leaves_with_paths(back),
                              tops.tree.leaves_with_paths(tp)):
        assert torch.equal(a, b), p
    batch, _ = tops.flatten_batch([tp, tp])
    jb, _ = jops.flatten_batch([ref, ref])
    np.testing.assert_array_equal(batch.numpy(), np.asarray(jb))
    stacked = tops.unflatten_batch(batch, spec)
    assert stacked["conv1"]["w"].shape == (2, 5, 5, 3, 6)


@pytest.mark.parametrize("name", ["pairwise_dists", "multikrum_scores",
                                  "pairwise_dists_q8", "multikrum_scores_q8",
                                  "add_q8_delta", "wkv6"])
def test_later_slice_kernels_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(tops, name)(torch.zeros(2, 4))
