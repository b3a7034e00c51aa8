"""WKV6 recurrence of RWKV-6 over a segment, with its final state.

Replaces the Pallas kernel ``repro/kernels/rwkv6.py:68`` (``wkv6``), the
time-mix recurrence of every RWKV-6 prefill. CUDA source: ``csrc/wkv6.cu``.
Bound on the card: float32 operations at hs = 64 (``5*hs^2 + 5*hs`` a
token and head against 12 bytes an element). One block per (batch, head);
tokens in chunks of 32, two sub-chunks of 16, every output of a chunk
computed at once from the chunk's incoming state, and the state stepped
once a chunk on the tensor cores (three TF32 products a tile, float32
accuracy); ``ref.wkv6_subchunks`` is the same arithmetic in PyTorch.

The kernel has no backward yet: on the card a gradient taken through it
(autograd or a ``torch.func`` transform) raises ``NotImplementedError``
rather than cutting the time-mix gradients (``refuse_backward``). On the
CPU the plain scan is differentiated as it stands.

The kernel computes the exact recurrence, which the Pallas kernel
approximates: that one clips each 32-token chunk's cumulative log-decay at
-25 (``repro/kernels/rwkv6.py:45``) and so departs from it on fast-decaying
channels. This one forms every decay as a product of ``w`` from a
sub-chunk boundary (no log, exp or division). The plain version is
``ref.wkv6_naive``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_SIZES = (16, 64)

_KERNEL = _build.register(
    "wkv6", "repro_wkv6",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 6
    + [ctypes.c_void_p])


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


def refuse_backward(device: torch.device, tensors) -> None:
    """Raise ``NotImplementedError`` when ``device`` is a CUDA device and a
    gradient is being taken through ``tensors``: grad mode is on and one of
    them requires grad, which is also how a tensor inside
    ``torch.func.grad`` presents itself."""
    if device.type == "cuda" and torch.is_grad_enabled() and \
            any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "wkv6: the CUDA kernel has no backward, so RWKV-6 does not train "
            "on the card yet (ROADMAP.md, queue 1: RWKV-6 training on the "
            "card: a wkv6 backward kernel)")


def wkv6(r, k, v, w, u, state):
    """r, k, v, w: [B, T, H, hs] (r, k, v f32 or bf16; w f32); u: [H, hs];
    state: [B, H, hs, hs] f32 -> (y [B, T, H, hs] in r.dtype, state' f32)."""
    if r.device.type == "cpu":
        return ref.wkv6_naive(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    refuse_backward(r.device, (r, k, v, w, u, state))
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
    r, k, v, w = kernel_operands(r, k, v, w)
    u = u.to(torch.float32).contiguous()
    s0 = state.to(torch.float32).contiguous()
    y = torch.empty((B, T, H, hs), dtype=r.dtype, device=r.device)
    s1 = torch.empty_like(s0)
    ptrs = (ctypes.c_void_p(a.data_ptr()) for a in (r, k, v, w, u, s0, y, s1))
    _KERNEL(*ptrs, B, H, T, hs, int(r.dtype == torch.bfloat16),
            *r.stride()[:3], *w.stride()[:3], _build.stream_of(r))
    return y, s1
