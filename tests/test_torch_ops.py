"""Port kernel layer vs the JAX reference: the plain versions (the port's CPU
path) against ``repro.kernels.ops`` running its Pallas kernels in interpret
mode, on the same numpy inputs.

quantize / dequantize are bit-exact; the weighted sums agree to 1e-6
relative (float32 sums taken in another order), and the int8 merge is also
bit for bit the reference's and the FMA chain of the port's kernel.
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
from repro_torch.kernels import ref as tref
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


@pytest.mark.parametrize("n", [1, 1000, 1023, 1024, 62_006, 131_072,
                               131_072 + 1, 131_072 + 5, 3 * 131_072 - 5])
def test_quantize_bit_exact_with_wire_padding(n):
    """The payload of x zero-padded to the next QUANT_BLOCK, at ragged n
    and at whole blocks (an all-zero tile and a tile of ties from n =
    2048 on; below, random values)."""
    x = _vec(n, n)
    if n >= 2048:
        x = _with_edge_tiles(x)
    jq, js, jn = jops.quantize(jnp.asarray(x))
    tq, ts, tn = tops.quantize(torch.from_numpy(x))
    assert jn == tn == n
    assert tq.shape[0] == n + (-n) % tops.QUANT_BLOCK
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


def _bits(a):
    """Bit patterns of a torch or JAX array (f32 or bf16)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("n", [1, 5_000, 62_006, 131_072])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3])
def test_dequantize_unpadded_bit_exact(k, dtype, n):
    """n columns kept of 131,072-padded payloads: ``dequantize`` (row 0) and
    ``dequantize_batch`` (k rows) give the reference's bits, unpadded,
    [n] and [k, n]."""
    q, s, _ = _q8(k, 131_072, 7 + k)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    one_j = jops.dequantize(jnp.asarray(q[0]), jnp.asarray(s[0]), n, jd)
    one_t = tops.dequantize(torch.from_numpy(q[0]), torch.from_numpy(s[0]),
                            n, td)
    assert one_t.shape == (n,) and one_t.dtype == td
    np.testing.assert_array_equal(_bits(one_t), _bits(one_j))
    bj = jops.dequantize_batch(jnp.asarray(q), jnp.asarray(s), n, jd)
    bt = tops.dequantize_batch(torch.from_numpy(q), torch.from_numpy(s), n,
                               td)
    assert bt.shape == (k, n) and bt.dtype == td
    np.testing.assert_array_equal(_bits(bt), _bits(bj))


@pytest.mark.parametrize("m,n", [(2, 62_006), (5, 4096)])
def test_weighted_sum_matches(m, n):
    x = np.stack([_vec(n, 10 + i, 1.0) for i in range(m)])
    w = np.random.default_rng(m).uniform(0.1, 1, m).astype(np.float32)
    _rel_close(tops.weighted_sum(torch.from_numpy(x), torch.from_numpy(w)),
               jops.weighted_sum(jnp.asarray(x), jnp.asarray(w)))


def _laid_out(x, layout):
    """numpy [M, N] -> a contiguous tensor, or the [:, :N] view of a zero
    [M, 131072] buffer (the strided operand a padded dequantize hands on)."""
    t = torch.from_numpy(x)
    if layout == "strided":
        buf = torch.zeros((x.shape[0], 131_072))
        buf[:, :x.shape[1]] = t
        t = buf[:, :x.shape[1]]
        assert not t.is_contiguous()
    return t


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_weighted_sum_takes_unpadded_views(layout):
    """The paper CNN's N = 62,006, unpadded (the port) against the
    reference, which pads inside its ops: 1e-6 relative."""
    m, n = 3, 62_006
    x = np.stack([_vec(n, 30 + i, 1.0) for i in range(m)])
    w = np.random.default_rng(7).uniform(0.1, 1, m).astype(np.float32)
    got = tops.weighted_sum(_laid_out(x, layout), torch.from_numpy(w))
    assert got.shape == (n,)
    _rel_close(got, jops.weighted_sum(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_pairwise_dists_take_unpadded_views(layout):
    """Distances cancel: within 4 * 2^-16 of the largest squared norm, the
    bound of test_gpu_ops_match_the_cpu_path."""
    m, n = 3, 62_006
    x = np.stack([_vec(n, 40 + i, 1.0) for i in range(m)])
    got = tops.pairwise_dists(_laid_out(x, layout)).numpy()
    want = np.asarray(jops.pairwise_dists(jnp.asarray(x)), np.float64)
    sq = (x.astype(np.float64) ** 2).sum(1)
    assert np.abs(got - want).max() <= 4 * 2.0 ** -16 * sq.max()


def test_pairwise_dists_q8_takes_unpadded_payloads(monkeypatch):
    """N = 61 x 1024 (the paper CNN's 62,006 in whole tiles), not a whole
    number of the reference's 4096-wide blocks: ops hands the payload to
    the Gram wrapper as it is (no pad), and the distances match the
    reference's on the zero-padded payload (zero codes add exactly 0) to
    4 * 2^-16 of the largest squared norm."""
    from repro_torch.kernels import q8agg as tq8

    def refuse(*a, **k):
        raise AssertionError("ops padded an operand")

    seen = []
    gram = tq8.gram_q8
    monkeypatch.setattr(torch.nn.functional, "pad", refuse)
    monkeypatch.setattr(tops._q8, "gram_q8",
                        lambda q, s: seen.append((q, s)) or gram(q, s))
    m, n = 3, 61 * 1024
    q, s, _ = _q8(m, n, 61)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    got = tops.pairwise_dists_q8(qt, st).numpy()
    assert [(a.data_ptr(), a.shape) for a in seen[0]] == \
        [(qt.data_ptr(), qt.shape), (st.data_ptr(), st.shape)]
    qp = np.pad(q, ((0, 0), (0, 3 * 1024)))
    sp = np.pad(s, ((0, 0), (0, 3)), constant_values=1.0)
    want = np.asarray(jops.pairwise_dists_q8(jnp.asarray(qp), jnp.asarray(sp)),
                      np.float64)
    x = q.astype(np.float64) * np.repeat(s.astype(np.float64), 1024, axis=1)
    sq = (x ** 2).sum(1)
    assert got.shape == (m, m)
    assert np.abs(got - want).max() <= 4 * 2.0 ** -16 * sq.max()


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("m,np_,n", [(2, 131_072, 62_006), (3, 5120, 5000),
                                     (9, 8192, 7000)])
def test_weighted_sum_q8_matches(m, np_, n, layout):
    """Bit for bit the reference's merge (its Pallas kernel in interpret
    mode), within RTOL of it too, and bit for bit the kernel's FMA chain
    (``w_m s_m`` rounded once, then fma over m from 0); "strided": the
    payloads as the [:, :Np] view of a wider [M, Np + 1024] buffer."""
    q, s, w = _q8(m, np_, m)
    qt = torch.from_numpy(q)
    if layout == "strided":
        qt = torch.zeros((m, np_ + 1024), dtype=torch.int8)[:, :np_]
        qt.copy_(torch.from_numpy(q))
    st, wt = torch.from_numpy(s), torch.from_numpy(w)
    got = tops.weighted_sum_q8(qt, st, wt, n)
    want = jops.weighted_sum_q8(jnp.asarray(q), jnp.asarray(s),
                                jnp.asarray(w), n)
    assert got.shape == (n,)
    _rel_close(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fw = (wt[:, None] * st).repeat_interleave(1024, 1)
    chain = tref.weighted_sum_ordered(torch.from_numpy(q).float(), fw)[:n]
    assert torch.equal(got, chain)


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
