"""The gradient of WKV6: the port's plain reverse scan
(``ref.wkv6_backward_naive``, the yardstick of the ``wkv6_backward`` CUDA
kernel) against the reference's ``jax.vjp`` of its token scan
(``repro.kernels.ref.wkv6_naive``) and of its chunked form
(``repro.models.rwkv6.wkv_chunked``), against torch autograd of the port's
scan, and the ``WKV6`` autograd Function on the CPU under
``torch.autograd.grad`` and ``torch.func.grad_and_value``. The kernel itself
is held to the same plain version on the card (``test_torch_gpu_paths.py``,
``chip_smoke.py``).

Tolerance: REL = 1e-5 of each gradient's max|.| (float32 sums in another
order: the reverse scan's explicit sums against the vjp's and autograd's).
The chunked form clips w at 1e-6 before its log and divides by cumulative
decays, so it is a yardstick only for decays that stay well inside float32
over a 32-token chunk (w in [0.2, 1]) and T a multiple of 32; at w = 0,
w = 1 and w = 1e-30 the token scan is the yardstick.

The kernel's own chunked arithmetic (``ref.wkv6_backward_chunks``: chunk
states from two serial passes, the per-chunk products and the decay scans)
is held to the plain reverse scan and to the reference's ``jax.vjp`` at the
same REL, ragged T, w = 0, 1 and 1e-30 and bf16 operands included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.kernels import ref as jref
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rwkv6 import WKV6

REL = 1e-5
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def _inputs(B, T, H, hs, seed, w_lo=0.45, w_hi=0.95):
    """r, k, v, w, u, state and the cotangents dy and dstate, seeded."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = (n(B, T, H, hs) * 0.5 for _ in range(3))
    w = (w_lo + (w_hi - w_lo) / (1.0 + np.exp(-n(B, T, H, hs)))
         ).astype(np.float32)
    u = n(H, hs) * 0.3
    s0 = n(B, H, hs, hs) * 0.1
    return (r, k, v, w, u, s0), n(B, T, H, hs), n(B, H, hs, hs)


def _jax_vjp(fn, args, dy, dstate):
    """The six cotangents of ``fn`` at ``args``; dstate None: zeros (the
    final state discarded)."""
    (y, s), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    ds = jnp.zeros_like(s) if dstate is None else jnp.asarray(dstate)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), ds))]


def _plain(args, dy, dstate, dtype=torch.float32):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in args)
    r, k, v = (a.to(dtype) for a in (r, k, v))
    return tref.wkv6_backward_naive(
        r, k, v, w, u, s0, torch.from_numpy(dy).to(dtype),
        None if dstate is None else torch.from_numpy(dstate))


def _chunks(args, dy, dstate, dtype=torch.float32):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in args)
    r, k, v = (a.to(dtype) for a in (r, k, v))
    return tref.wkv6_backward_chunks(
        r, k, v, w, u, s0, torch.from_numpy(dy).to(dtype),
        None if dstate is None else torch.from_numpy(dstate))


def _extreme_decays(case, args):
    """w = 0 and 1 on whole channels and one channel of one batch and head
    ("zero-one"), or log-uniform down to 1e-30 ("1e-30")."""
    w = args[3].copy()
    if case == "zero-one":
        w[..., :3] = 0.0
        w[..., 3:6] = 1.0
        w[0, :, 1, 6] = 0.0
    else:
        rng = np.random.default_rng(30)
        w = (10.0 ** rng.uniform(-30.0, 0.0, w.shape)).astype(np.float32)
    return (*args[:3], w, *args[4:])


def _assert_close(got, want, rel=REL):
    for name, g, w in zip(NAMES, got, want):
        g = np.asarray(g.to(torch.float32)) if torch.is_tensor(g) else g
        w = np.asarray(w.to(torch.float32)) if torch.is_tensor(w) else w
        assert g.shape == w.shape, name
        assert np.all(np.isfinite(g)), name
        top = np.abs(w).max()
        assert np.abs(g - w).max() <= rel * top, (name, np.abs(g - w).max(),
                                                  top)


@pytest.mark.parametrize("with_dstate", [True, False])
@pytest.mark.parametrize("B,T,H,hs", [(2, 1, 2, 16), (1, 31, 2, 64),
                                      (2, 33, 2, 16), (1, 70, 1, 64)])
def test_plain_backward_matches_the_vjp_of_the_reference_scan(
        B, T, H, hs, with_dstate):
    args, dy, ds = _inputs(B, T, H, hs, seed=B * T + hs)
    ds = ds if with_dstate else None
    _assert_close(_plain(args, dy, ds),
                  _jax_vjp(jref.wkv6_naive, args, dy, ds))


@pytest.mark.parametrize("w_lo,w_hi", [(0.45, 0.95), (0.2, 1.0)])
def test_plain_backward_matches_the_vjp_of_the_chunked_form(w_lo, w_hi):
    args, dy, ds = _inputs(2, 64, 2, 16, seed=64, w_lo=w_lo, w_hi=w_hi)
    _assert_close(_plain(args, dy, ds), _jax_vjp(wkv_chunked, args, dy, ds))


def _autograd_of_the_scan(args, dy, dstate):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = tref.wkv6_naive(*leaves)
    outs, cots = [y], [torch.from_numpy(dy)]
    if dstate is not None:
        outs.append(s)
        cots.append(torch.from_numpy(dstate))
    return torch.autograd.grad(outs, leaves, cots)


@pytest.mark.parametrize("with_dstate", [True, False])
def test_plain_backward_matches_torch_autograd_of_the_scan(with_dstate):
    args, dy, ds = _inputs(3, 45, 2, 16, seed=45)
    ds = ds if with_dstate else None
    _assert_close(_plain(args, dy, ds), _autograd_of_the_scan(args, dy, ds))


def test_plain_backward_takes_w_of_zero_and_one_exactly():
    """Channels that forget at once (w = 0) and never (w = 1): the states
    are recomputed forward, never divided out of w, so every gradient is
    finite and equal to autograd's of the scan."""
    args, dy, ds = _inputs(2, 70, 2, 16, seed=70)
    w = args[3]
    w[..., :3] = 0.0
    w[..., 3:6] = 1.0
    w[0, :, 1, 6] = 0.0
    _assert_close(_plain(args, dy, ds), _autograd_of_the_scan(args, dy, ds))


def test_plain_backward_takes_decays_down_to_1e_30():
    args, dy, ds = _inputs(1, 96, 2, 16, seed=96)
    rng = np.random.default_rng(30)
    args = (*args[:3], (10.0 ** rng.uniform(-30.0, 0.0, args[0].shape))
            .astype(np.float32), *args[4:])
    _assert_close(_plain(args, dy, ds), _autograd_of_the_scan(args, dy, ds))


def test_plain_backward_of_bf16_rkv_gives_bf16_gradients():
    """bf16 r, k, v and dy: dr, dk and dv come back bf16, the rest f32;
    each within one bf16 ulp (2^-7) of max|.| of the float32 vjp at the
    same bf16 values."""
    args, dy, ds = _inputs(2, 40, 2, 16, seed=40)
    got = _plain(args, dy, ds, torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    bf = lambda a: np.asarray(torch.from_numpy(a).to(torch.bfloat16)
                              .to(torch.float32))
    want = _jax_vjp(jref.wkv6_naive, (*map(bf, args[:3]), *args[3:]),
                    bf(dy), ds)
    _assert_close(got[:3], want[:3], 2.0 ** -7)
    _assert_close(got[3:], want[3:], REL)


def test_function_under_autograd_grad_is_the_plain_backward():
    """``WKV6.apply`` on CPU tensors: the plain backward's gradients, bit
    for bit; the backward sees which inputs need a gradient, returns None
    for the others (v and the state), and gets None for the discarded
    final state."""
    args, dy, _ = _inputs(2, 33, 2, 16, seed=33)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in args)
    leaves = [a.clone().requires_grad_() for a in (r, k, w, u)]
    y, _ = WKV6.apply(leaves[0], leaves[1], v, leaves[2], leaves[3], s0)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = tref.wkv6_backward_naive(r, k, v, w, u, s0, torch.from_numpy(dy))
    for g, i in zip(got, (0, 1, 3, 4)):
        assert torch.equal(g, want[i]), NAMES[i]
    seen = []

    class Spy(WKV6):
        @staticmethod
        def backward(ctx, dy_, ds_):
            out = WKV6.backward(ctx, dy_, ds_)
            seen.append((tuple(ctx.needs_input_grad), ds_,
                         [g is None for g in out]))
            return out

    y, _ = Spy.apply(leaves[0], leaves[1], v, leaves[2], leaves[3], s0)
    torch.autograd.grad(y.sum(), leaves)
    assert seen == [((True, True, False, True, True, False), None,
                     [False, False, True, False, False, True])]


def test_function_under_torch_func_is_the_plain_backward():
    """``torch.func.grad_and_value`` goes through the Function (a
    ``setup_context`` Function), with the final state fed to the loss: the
    plain backward's gradients of both outputs."""
    args, dy, ds = _inputs(1, 40, 2, 16, seed=41)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in args)
    dyt, dst = torch.from_numpy(dy), torch.from_numpy(ds)

    def loss(*a):
        y, s = WKV6.apply(*a)
        return (y * dyt).sum() + (s * dst).sum()

    got, value = grad_and_value(loss, argnums=tuple(range(6)))(
        r, k, v, w, u, s0)
    want = tref.wkv6_backward_naive(r, k, v, w, u, s0, dyt, dst)
    for name, g, w_ in zip(NAMES, got, want):
        assert torch.equal(g, w_), name
    y, s = tref.wkv6_naive(r, k, v, w, u, s0)
    assert torch.equal(value, (y * dyt).sum() + (s * dst).sum())


@pytest.mark.parametrize("with_dstate", [True, False])
@pytest.mark.parametrize("B,T,H,hs", [(2, 1, 2, 16), (1, 31, 2, 64),
                                      (2, 33, 2, 16), (1, 70, 1, 64)])
def test_chunked_backward_matches_the_plain_scan_and_the_vjp(
        B, T, H, hs, with_dstate):
    """``ref.wkv6_backward_chunks``: one chunk, a chunk less a token, a
    chunk and one, two chunks and a tail of 6; with and without a final
    state's gradient."""
    args, dy, ds = _inputs(B, T, H, hs, seed=B * T + hs + 5)
    ds = ds if with_dstate else None
    got = _chunks(args, dy, ds)
    _assert_close(got, _plain(args, dy, ds))
    _assert_close(got, _jax_vjp(jref.wkv6_naive, args, dy, ds))


@pytest.mark.parametrize("case", ["zero-one", "1e-30"])
def test_chunked_backward_takes_extreme_decays(case):
    """Every decay a product of w from a chunk or sub-chunk boundary, none
    divided out: channels at w = 0, 1 and down to 1e-30 are plain cases,
    over two chunks and a tail."""
    args, dy, ds = _inputs(2, 70, 2, 64, seed=71)
    args = _extreme_decays(case, args)
    got = _chunks(args, dy, ds)
    _assert_close(got, _plain(args, dy, ds))
    _assert_close(got, _jax_vjp(jref.wkv6_naive, args, dy, ds))


def test_chunked_backward_of_bf16_rkv():
    """bf16 r, k, v and dy: dr, dk and dv come back bf16 within one bf16
    ulp of max|.| of the float32 vjp at the same bf16 values, the rest f32
    within REL; and within REL of the plain scan's float32 gradients
    before their rounding to bf16 (one ulp for the bf16 three)."""
    args, dy, ds = _inputs(2, 40, 2, 16, seed=42)
    got = _chunks(args, dy, ds, torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    bf = lambda a: np.asarray(torch.from_numpy(a).to(torch.bfloat16)
                              .to(torch.float32))
    want = _jax_vjp(jref.wkv6_naive, (*map(bf, args[:3]), *args[3:]),
                    bf(dy), ds)
    _assert_close(got[:3], want[:3], 2.0 ** -7)
    _assert_close(got[3:], want[3:], REL)
    plain = _plain(args, dy, ds, torch.bfloat16)
    _assert_close(got[:3], plain[:3], 2.0 ** -7)
    _assert_close(got[3:], plain[3:], REL)
