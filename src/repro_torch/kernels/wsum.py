"""Weighted sum of M flattened models: ``out[n] = sum_m w[m] * x[m, n]``.

Replaces the Pallas kernel ``repro/kernels/wsum.py:27`` (``weighted_sum``),
the intra-silo FedAvg every silo runs every round. CUDA source:
``csrc/wsum.cu``. Bound on the card: memory, ``(M+1) * N * itemsize`` bytes
for ``2 * M * N`` flops; each thread streams one 16-, 8- or 4-byte vector of
outputs down the M rows and sums in float32 registers, in order 0..M-1.

``x`` is any ``[M, N]`` with unit column stride and row stride >= N: views
and unpadded models go in as they are. Host weights (``M <= 64``) travel
in the kernel's parameters, so FedAvg's numpy weights need no copy.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor as _FakeTensor

from repro_torch.kernels import _build, ref

MAX_HOST_M = 64    # host weights ride in the kernel's parameters

_KERNEL = _build.register(
    "weighted_sum", "repro_weighted_sum",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
     ctypes.c_void_p])


def weighted_sum(x, w):
    """x: [M, N] f32/bf16, row-strided; w: [M] on the card or the host
    -> [N] in x.dtype. The checks are written for a thin host path: at the
    paper CNN's size the call costs more host time than device time. A
    fake ``x`` goes through ``weighted_sum_op``."""
    if isinstance(x, _FakeTensor):
        return weighted_sum_op(x, w)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return ref.weighted_sum(x, w)
        raise ValueError(f"weighted_sum: no kernel for device {x.device}")
    dtype = x.dtype
    if dtype is not torch.float32 and dtype is not torch.bfloat16:
        raise TypeError(f"weighted_sum: x must be f32 or bf16, got {dtype}")
    M, N = x.shape
    s0, s1 = x.stride()
    ld = s0 if M > 1 else N
    if not (M >= 1 and N >= 1 and w.shape == (M,)
            and (s1 == 1 or N == 1) and ld >= N):
        raise ValueError(f"weighted_sum: bad operands x{tuple(x.shape)} "
                         f"strides {x.stride()}, w{tuple(w.shape)} (M >= 1, "
                         "unit column stride, row stride >= N)")
    if not w.is_cuda and M <= MAX_HOST_M:
        if w.dtype is not torch.float32 or not w.is_contiguous():
            w = w.to(torch.float32).contiguous()    # read by the C call
        w_dev, w_host = None, w.data_ptr()
    else:
        if not (w.is_cuda and w.dtype is torch.float32 and w.is_contiguous()
                and w.get_device() == x.get_device()):
            w = w.to(device=x.device, dtype=torch.float32).contiguous()
        w_dev, w_host = w.data_ptr(), None
    out = torch.empty(N, dtype=dtype, device=x.device)
    _KERNEL(x.data_ptr(), ld, w_dev, w_host, out.data_ptr(), M, N,
            dtype is torch.bfloat16, _build.stream_of(x))
    return out


@torch.library.custom_op("repro_torch::weighted_sum", mutates_args=())
def weighted_sum_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``weighted_sum`` as an op, for fake operands (the dry run)."""
    return weighted_sum(x, w)


@weighted_sum_op.register_fake
def _(x, w):
    return x.new_empty((x.shape[1],))


def cost(M: int, N: int, itemsize: int):
    """(flops, bytes) of one launch: ``2 M N`` and ``(M + 1) N`` elements
    (``chip_smoke.bound``)."""
    return 2.0 * M * N, float((M + 1) * N * itemsize)


_build.FAKE_COSTS["repro_torch::weighted_sum"] = \
    lambda args, out: cost(*args[0].shape, args[0].element_size())
