"""Port ``ops.wkv6`` (on the CPU: the plain token scan ``ref.wkv6_naive``)
against the JAX reference on the same numpy inputs: its token scan
(``repro.kernels.ref.wkv6_naive``), its Pallas kernel in interpret mode
(``repro.kernels.ops.wkv6``, as ``tests/test_kernels.py`` runs it) and its
model's chunked form (``repro.models.rwkv6.wkv_chunked``). The CUDA
kernel's sub-chunked arithmetic (``ref.wkv6_subchunks``: decays as products
of w from sub-chunk boundaries, the state stepped once a chunk) is held
against the same three, and against the token scan at extreme decays
(w = 0, w = 1, w down to 1e-30) where the Pallas kernel and the chunked
form, which clip w at 1e-6, are no yardstick.

Tolerances: against the reference's token scan, 1e-5 of max|y| and of
max|S| (float32 sums in another order); against the Pallas kernel, the
3e-3 of ``test_kernels.py`` (it sums 32-token chunks through cumulative
decays). With a bf16 output, one bf16 ulp (2^-7 of |y|) more: the two
sides may round a float32 value to either side of a bf16 boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

REL = 1e-5
PALLAS_TOL = 3e-3
SHAPES = [(1, 32, 1, 8), (2, 64, 2, 16), (1, 96, 4, 32), (3, 33, 2, 16)]


def _inputs(B, T, H, hs, seed, w_lo=0.45, w_hi=0.95):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = (n(B, T, H, hs) * 0.5 for _ in range(3))
    w = (w_lo + (w_hi - w_lo) / (1.0 + np.exp(-n(B, T, H, hs)))
         ).astype(np.float32)
    u = n(H, hs) * 0.3
    s0 = n(B, H, hs, hs) * 0.1
    return r, k, v, w, u, s0


def _port(args, dtype=torch.float32):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in args)
    r, k, v = (a.to(dtype) for a in (r, k, v))
    return tops.wkv6(r, k, v, w, u, s0)


def _jax(fn, args, dtype=jnp.float32):
    r, k, v, w, u, s0 = (jnp.asarray(a) for a in args)
    y, s = fn(*(a.astype(dtype) for a in (r, k, v)), w, u, s0)
    return np.asarray(y.astype(jnp.float32)), np.asarray(s)


def _assert_close(got, want, rel, y_ulps=0.0):
    """|dy| <= rel*max|y| (+ y_ulps of |y|), |dS| <= rel*max|S|."""
    gy, gs = (np.asarray(t.to(torch.float32)) for t in got)
    wy, ws = want
    assert np.all(np.abs(gy - wy) <= rel * np.abs(wy).max()
                  + y_ulps * np.abs(wy)), np.abs(gy - wy).max()
    assert np.abs(gs - ws).max() <= rel * np.abs(ws).max()


@pytest.mark.parametrize("B,T,H,hs", SHAPES + [(2, 1, 2, 16)])
def test_wkv6_matches_the_reference_token_scan(B, T, H, hs):
    args = _inputs(B, T, H, hs, seed=B * T + H)
    got = _port(args)
    assert got[0].shape == (B, T, H, hs) and got[0].dtype == torch.float32
    assert got[1].shape == (B, H, hs, hs) and got[1].dtype == torch.float32
    _assert_close(got, _jax(jref.wkv6_naive, args), REL)


@pytest.mark.parametrize("B,T,H,hs", SHAPES)
def test_wkv6_matches_the_pallas_kernel(B, T, H, hs):
    args = _inputs(B, T, H, hs, seed=B * T + H + 1)
    got = [np.asarray(t) for t in _port(args)]
    want = _jax(jops.wkv6, args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=PALLAS_TOL, atol=PALLAS_TOL)


@pytest.mark.parametrize("B,T,H,hs", [(2, 64, 2, 16), (1, 33, 4, 64)])
def test_wkv6_bf16_rkv_with_f32_decay(B, T, H, hs):
    """The model's dtypes: bf16 r, k, v, f32 w; y comes back in bf16."""
    args = _inputs(B, T, H, hs, seed=3 * T + hs)
    y, s = _port(args, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _assert_close((y, s), _jax(jref.wkv6_naive, args, jnp.bfloat16), REL,
                  y_ulps=2.0 ** -7)


def test_wkv6_state_chaining():
    """[0:T] in one call equals [0:T/2] then [T/2:T] with the state carried:
    bit for bit, as the same token steps run in the same order."""
    args = _inputs(2, 64, 2, 16, seed=7)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in args)
    y_all, s_all = tops.wkv6(r, k, v, w, u, s0)
    h = 32
    y1, s1 = tops.wkv6(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0)
    y2, s2 = tops.wkv6(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1)
    assert torch.equal(torch.cat([y1, y2], 1), y_all)
    assert torch.equal(s2, s_all)


def test_wkv6_zero_inputs_give_zero_outputs():
    z = torch.zeros((2, 5, 2, 16))
    y, s = tops.wkv6(z, z, z, torch.full_like(z, 0.9), torch.zeros((2, 16)),
                     torch.zeros((2, 2, 16, 16)))
    assert not torch.any(y) and not torch.any(s)


def test_wkv6_strong_decay_is_exact_where_the_pallas_kernel_clips():
    """Decays in [0.2, 0.5]: a 32-token chunk of one channel decays past
    e^-25, where the Pallas kernel clips its cumulative log-decay
    (repro/kernels/rwkv6.py:45). The port computes the exact recurrence, as
    the reference's token scan and chunked jnp form do; the Pallas kernel
    departs from all three by more than 1."""
    args = _inputs(1, 64, 2, 16, seed=0, w_lo=0.2, w_hi=0.5)
    got = _port(args)
    naive = _jax(jref.wkv6_naive, args)
    chunked = _jax(wkv_chunked, args)
    _assert_close(got, naive, REL)
    _assert_close(got, chunked, REL)
    pallas_y = _jax(jops.wkv6, args)[0]
    assert np.abs(pallas_y - naive[0]).max() > 1.0
    assert np.abs(pallas_y - np.asarray(got[0])).max() > 1.0


# --------------------------------------------------------------------------- #
# The kernel's sub-chunked arithmetic (ref.wkv6_subchunks)
# --------------------------------------------------------------------------- #

def _sub(args, dtype=torch.float32):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in args)
    r, k, v = (a.to(dtype) for a in (r, k, v))
    return tref.wkv6_subchunks(r, k, v, w, u, s0)


@pytest.mark.parametrize("B,T,H,hs", SHAPES + [(2, 1, 2, 16),
                                              (1, 1000, 2, 16)])
def test_subchunk_form_matches_the_reference_token_scan(B, T, H, hs):
    args = _inputs(B, T, H, hs, seed=B * T + H + 2)
    got = _sub(args)
    assert got[0].shape == (B, T, H, hs) and got[1].shape == (B, H, hs, hs)
    _assert_close(got, _jax(jref.wkv6_naive, args), REL)


@pytest.mark.parametrize("B,T,H,hs", SHAPES)
def test_subchunk_form_matches_the_pallas_kernel(B, T, H, hs):
    args = _inputs(B, T, H, hs, seed=B * T + H + 3)
    for g, w in zip(_sub(args), _jax(jops.wkv6, args)):
        np.testing.assert_allclose(np.asarray(g), w, rtol=PALLAS_TOL,
                                   atol=PALLAS_TOL)


@pytest.mark.parametrize("B,T,H,hs", [s for s in SHAPES if s[1] % 32 == 0])
def test_subchunk_form_matches_the_chunked_form(B, T, H, hs):
    """``wkv_chunked`` takes whole 32-token chunks (its caller pads)."""
    args = _inputs(B, T, H, hs, seed=B * T + H + 4)
    _assert_close(_sub(args), _jax(wkv_chunked, args), REL)


def test_subchunk_form_is_exact_where_the_pallas_kernel_clips():
    """The strong-decay inputs of the test above: exact to REL."""
    args = _inputs(1, 64, 2, 16, seed=0, w_lo=0.2, w_hi=0.5)
    _assert_close(_sub(args), _jax(jref.wkv6_naive, args), REL)


@pytest.mark.parametrize("T", [33, 100])
def test_subchunk_form_takes_w_of_zero_and_one_exactly(T):
    """Channels that forget at once (w = 0) and never (w = 1): plain cases
    of the products, no log of 0 and no special path."""
    r, k, v, w, u, s0 = _inputs(2, T, 2, 16, seed=T)
    w[..., :3] = 0.0
    w[..., 3:6] = 1.0
    w[0, :, 1, 6] = 0.0                 # one channel of one head and batch
    args = (r, k, v, w, u, s0)
    _assert_close(_sub(args), _jax(jref.wkv6_naive, args), REL)


def test_subchunk_form_takes_decays_down_to_1e_30():
    rng = np.random.default_rng(30)
    r, k, v, _, u, s0 = _inputs(1, 96, 2, 16, seed=31)
    w = (10.0 ** rng.uniform(-30.0, 0.0, r.shape)).astype(np.float32)
    args = (r, k, v, w, u, s0)
    _assert_close(_sub(args), _jax(jref.wkv6_naive, args), REL)


def test_subchunk_form_chains_state_across_calls():
    """[0:T] in one call against [0:40] then [40:T] with the state carried
    (40 is not a whole number of chunks), and both against the scan."""
    args = _inputs(2, 100, 2, 16, seed=8)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in args)
    y1, s1 = tref.wkv6_subchunks(r[:, :40], k[:, :40], v[:, :40],
                                 w[:, :40], u, s0)
    y2, s2 = tref.wkv6_subchunks(r[:, 40:], k[:, 40:], v[:, 40:],
                                 w[:, 40:], u, s1)
    want = _jax(jref.wkv6_naive, args)
    _assert_close((torch.cat([y1, y2], 1), s2), want, REL)
    _assert_close(tref.wkv6_subchunks(r, k, v, w, u, s0), want, REL)


def test_subchunk_form_with_bf16_rkv():
    args = _inputs(2, 70, 2, 16, seed=9)
    y, s = _sub(args, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    _assert_close((y, s), _jax(jref.wkv6_naive, args, jnp.bfloat16), REL,
                  y_ulps=2.0 ** -7)
