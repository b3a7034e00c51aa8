"""WKV6 recurrence of RWKV-6 over a segment, with its final state, and its
gradient.

Replaces the Pallas kernel ``repro/kernels/rwkv6.py:68`` (``wkv6``), the
time-mix recurrence of every RWKV-6 prefill and training step. CUDA source:
``csrc/wkv6.cu``. Bound on the card: float32 operations at hs = 64
(``5*hs^2 + 5*hs`` a token and head against 12 bytes an element). One
block per (batch, head); tokens in chunks of 32, two sub-chunks of 16,
every output of a chunk computed at once from the chunk's incoming state,
and the state stepped once a chunk on the tensor cores (three TF32 products
a tile, float32 accuracy); ``ref.wkv6_subchunks`` is the same arithmetic in
PyTorch.

The kernel computes the exact recurrence, which the Pallas kernel
approximates: that one clips each 32-token chunk's cumulative log-decay at
-25 (``repro/kernels/rwkv6.py:45``) and so departs from it on fast-decaying
channels. This one forms every decay as a product of ``w`` from a
sub-chunk boundary (no log, exp or division). The plain version is
``ref.wkv6_naive``.

On the card, ``wkv6`` goes through ``WKV6``, a ``torch.autograd.Function``
whose backward is a second kernel, ``csrc/wkv6_bwd.cu`` (no Pallas
counterpart: the reference differentiates its jnp forms). It is chunked
like the forward: two serial passes write each 32-token chunk's incoming
state and outgoing gradient, then a block a chunk forms every gradient
from those two on the tensor cores and by channelwise scans of products
of ``w`` (never divided out of it); ``ref.wkv6_backward_chunks`` is the
same arithmetic in PyTorch, and the plain version is
``ref.wkv6_backward_naive``. It serves ``torch.autograd.grad`` and the
``torch.func`` transforms alike; a call that takes no gradient skips it
and launches the forward kernel directly. On the CPU, ``wkv6`` is the plain scan,
which autograd differentiates as it stands; ``WKV6`` on CPU tensors runs
the two plain versions, for the tests. Fake tensors (the dry run) go
through ``wkv6_op`` / ``wkv6_backward_op``, ops whose fake
implementations give the shapes and whose costs ``FAKE_COSTS`` holds.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor as _FakeTensor

from repro_torch.kernels import _build, ref

HEAD_SIZES = (16, 64)

_KERNEL = _build.register(
    "wkv6", "repro_wkv6",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 6
    + [ctypes.c_void_p])
_BACKWARD = _build.register(
    "wkv6_backward", "repro_wkv6_backward",
    [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 9
    + [ctypes.c_void_p], packed=True)
CHUNK = 32    # tokens a chunk of the backward (its states are kept a chunk)


def _rows_strided(t):
    """``t`` itself if its last axis is contiguous, else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _vec_aligned(t):
    """The kernel reads 4 elements at a time: strides and base address in
    whole 4-element vectors (true of any contiguous [B, T, H, hs])."""
    return all(st % 4 == 0 for st in t.stride()[:3]) and \
        t.data_ptr() % (4 * t.element_size()) == 0


def _fresh(t):
    """A contiguous copy in a fresh allocation (``contiguous`` would hand
    back a contiguous tensor whose base is misaligned as it is)."""
    return t.clone(memory_format=torch.contiguous_format)


def kernel_operands(r, k, v, w):
    """r, k, v and w (as f32) as the kernel reads them: a contiguous last
    axis, r, k and v on one set of strides, every stride and base in whole
    4-element vectors; a fresh copy of what is not."""
    r, k, v = (_rows_strided(a) for a in (r, k, v))
    if not (r.stride() == k.stride() == v.stride()) or \
            not all(_vec_aligned(a) for a in (r, k, v)):
        r, k, v = _fresh(r), _fresh(k), _fresh(v)
    w = _rows_strided(w.to(torch.float32))
    if not _vec_aligned(w):
        w = _fresh(w)
    return r, k, v, w


def _check(r, k, v, w, u, state):
    B, T, H, hs = r.shape
    if hs not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {hs} not in {HEAD_SIZES}")
    if r.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k, v must share f32 or bf16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape or \
            tuple(u.shape) != (H, hs) or tuple(state.shape) != (B, H, hs, hs):
        raise ValueError(f"wkv6: bad shapes r{tuple(r.shape)} "
                         f"w{tuple(w.shape)} u{tuple(u.shape)} "
                         f"state{tuple(state.shape)}")
    if any(a.device != r.device for a in (k, v, w, u, state)):
        raise ValueError("wkv6: r, k, v, w, u and state must share a device")


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def forward(r, k, v, w, u, state):
    """The forward kernel on checked CUDA tensors."""
    B, T, H, hs = r.shape
    r, k, v, w = kernel_operands(r, k, v, w)
    u = u.to(torch.float32).contiguous()
    s0 = state.to(torch.float32).contiguous()
    y = torch.empty((B, T, H, hs), dtype=r.dtype, device=r.device)
    s1 = torch.empty_like(s0)
    _KERNEL(*(_ptr(a) for a in (r, k, v, w, u, s0, y, s1)), B, H, T, hs, int(r.dtype == torch.bfloat16),
            *r.stride()[:3], *w.stride()[:3], _build.stream_of(r))
    return y, s1


def backward(r, k, v, w, u, state, dy, dstate=None,
             needs=(True,) * 6):
    """The backward kernel on checked CUDA tensors: (dr, dk, dv, dw, du,
    dstate0), each None where ``needs`` (the six inputs' flags) says so.
    ``dy`` of any strides (an expanded or sliced cotangent is made what the
    kernel reads); ``dstate`` None when the final state is discarded.
    Scratch of this call: each chunk's incoming state (for dr and dw) and
    outgoing gradient (for dk, dv, dw and dstate0), [B, H, ceil(T / 32),
    hs, hs] f32 each, and du's partials, [B, ceil(T / 32), H, hs]."""
    B, T, H, hs = r.shape
    dev = r.device
    r, k, v, w = kernel_operands(r, k, v, w)
    dy = _rows_strided(dy.to(r.dtype))
    if not _vec_aligned(dy):
        dy = _fresh(dy)
    u = u.to(torch.float32).contiguous()
    s0 = state.to(torch.float32).contiguous()
    if dstate is not None:
        dstate = dstate.to(torch.float32).contiguous()
    out = lambda dt: torch.empty((B, T, H, hs), dtype=dt, device=dev)
    dr, dk, dv = (out(r.dtype) if n else None for n in needs[:3])
    dw = out(torch.float32) if needs[3] else None
    du = torch.empty((H, hs), dtype=torch.float32, device=dev) \
        if needs[4] else None
    ds0 = torch.empty_like(s0) if needs[5] else None
    # each chunk's incoming state (for dr, dw) and outgoing gradient (for
    # dk, dv, dw, dstate0), and du's partials
    nck = -(-T // CHUNK)
    states = lambda: torch.empty((B, H, nck, hs, hs), dtype=torch.float32,
                                 device=dev)
    s_in = states() if needs[0] or needs[3] else None
    g_out = states() if needs[1] or needs[2] or needs[3] or needs[5] \
        else None
    du_part = torch.empty((B, nck, H, hs), dtype=torch.float32,
                          device=dev) if needs[4] else None
    _BACKWARD(*(0 if a is None else a.data_ptr() for a in (
        r, k, v, w, u, s0, dy, dstate, dr, dk, dv, dw, du, du_part, ds0,
        s_in, g_out)), B, H, T, hs, int(r.dtype == torch.bfloat16),
        *r.stride()[:3], *w.stride()[:3], *dy.stride()[:3],
        _build.stream_of(r))
    return dr, dk, dv, dw, du, ds0


def set_backward_pdl(on: bool) -> bool:
    """Whether the backward's chunk kernel starts before its pass ends
    (programmatic dependent launch; on by default), for later calls of
    this process; returns the setting before. Off, each kernel's profiled
    device time is its own (``trace_kernels``)."""
    fn = _build.library().repro_wkv6_backward_pdl
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return bool(fn(int(on)))


class WKV6(torch.autograd.Function):
    """``wkv6`` with a backward: on CUDA tensors the two kernels, on CPU
    tensors ``ref.wkv6_naive`` and ``ref.wkv6_backward_naive`` (for the
    tests). ``setup_context`` style, so ``torch.func`` transforms go
    through it as autograd does. Only the gradients in
    ``ctx.needs_input_grad`` are computed; a discarded final state arrives
    as None (grads are not materialised)."""

    @staticmethod
    def forward(r, k, v, w, u, state):
        if isinstance(r, _FakeTensor):
            return wkv6_op(r, k, v, w, u, state)
        if r.device.type == "cpu":
            return ref.wkv6_naive(r, k, v, w, u, state)
        return forward(r, k, v, w, u, state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad)
        if dy is None:
            dy = torch.zeros_like(r)
        if isinstance(r, _FakeTensor):
            grads = wkv6_backward_op(r, k, v, w, u, state, dy, dstate)
            return tuple(g if n else None for g, n in zip(grads, needs))
        if r.device.type == "cpu":
            grads = ref.wkv6_backward_naive(r, k, v, w, u, state, dy, dstate)
            return tuple(g if n else None for g, n in zip(grads, needs))
        return backward(r, k, v, w, u, state, dy, dstate, needs)


def wkv6(r, k, v, w, u, state):
    """r, k, v, w: [B, T, H, hs] (r, k, v f32 or bf16; w f32); u: [H, hs];
    state: [B, H, hs, hs] f32 -> (y [B, T, H, hs] in r.dtype, state' f32).
    A CPU tensor takes the plain scan (autograd differentiates it); a CUDA
    tensor goes through ``WKV6``, the two kernels, where a gradient is
    being taken, and straight to the forward kernel where none is (a
    prefill or an eval skips the Function's host cost). Fake tensors take
    the same two routes through ``wkv6_op``."""
    if isinstance(r, _FakeTensor):
        if torch.is_grad_enabled() and any(
                a.requires_grad for a in (r, k, v, w, u, state)):
            return WKV6.apply(r, k, v, w, u, state)
        return wkv6_op(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return ref.wkv6_naive(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    _check(r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (r, k, v, w, u, state)):
        return WKV6.apply(r, k, v, w, u, state)
    return forward(r, k, v, w, u, state)


# --------------------------------------------------------------------------- #
# Ops for fake operands (the dry run) and their costs
# --------------------------------------------------------------------------- #

@torch.library.custom_op("repro_torch::wkv6", mutates_args=())
def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel as an op, for fake operands."""
    _check(r, k, v, w, u, state)
    return forward(r, k, v, w, u, state)


@wkv6_op.register_fake
def _(r, k, v, w, u, state):
    return r.new_empty(r.shape), state.new_empty(state.shape,
                                                 dtype=torch.float32)


@torch.library.custom_op("repro_torch::wkv6_backward", mutates_args=())
def wkv6_backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                     dy: torch.Tensor, dstate: Optional[torch.Tensor]
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel as an op (every gradient), for fake
    operands."""
    return backward(r, k, v, w, u, state, dy, dstate)


@wkv6_backward_op.register_fake
def _(r, k, v, w, u, state, dy, dstate):
    f32 = torch.float32
    return (r.new_empty(r.shape), r.new_empty(r.shape), r.new_empty(r.shape),
            r.new_empty(r.shape, dtype=f32), u.new_empty(u.shape, dtype=f32),
            state.new_empty(state.shape, dtype=f32))


def forward_cost(B: int, T: int, H: int, hs: int, e: int):
    """(flops, bytes) of a forward launch (``chip_smoke.check_wkv6``):
    ``(5 hs + 5)`` flops an element; r, k, v and y in e bytes, w in 4,
    the two states in float32."""
    n = B * T * H * hs
    return (5.0 * hs + 5) * n, float(n * (4 * e + 4) + 2 * B * H * hs * hs * 4)


def backward_cost(B: int, T: int, H: int, hs: int, e: int, given: bool):
    """(flops, bytes) of a backward launch
    (``chip_smoke.check_wkv6_backward``): ``10 hs^2`` flops a token and
    head; ``given``: a final state's gradient read too."""
    n = B * T * H * hs
    states = B * H * hs * hs * 4
    nbytes = (n * (4 * e + 4) + H * hs * 4 + states * (1 + given)
              + n * (3 * e + 4) + H * hs * 4 + states)
    return 10.0 * hs * hs * B * T * H, float(nbytes)


_build.FAKE_COSTS["repro_torch::wkv6"] = \
    lambda args, out: forward_cost(*args[0].shape, args[0].element_size())
_build.FAKE_COSTS["repro_torch::wkv6_backward"] = \
    lambda args, out: backward_cost(*args[0].shape, args[0].element_size(),
                                    args[7] is not None)
