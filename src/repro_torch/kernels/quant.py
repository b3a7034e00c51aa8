"""Symmetric per-tile int8 quantize / dequantize (the int8 wire format).

``quantize`` replaces ``repro/kernels/quant.py:34``; ``dequantize`` replaces
the body ``_dq_kernel`` that both ``quant.py:79`` (``dequantize``, one
payload) and ``quant.py:55`` (``dequantize_batch``, K payloads in one
launch) run. CUDA source: ``csrc/quant.cu``. Bound on the card: memory —
quantize reads 4 bytes of each element it is given and writes 1 of each
payload element (+4 per 1024-tile), dequantize 5 (or 3 for bf16 output)
per element it keeps. ``quantize`` takes the caller's ``[n]`` floats as
they are and writes the payload's zero padding itself (zero codes, scale
1.0 past n): on a large payload one warp a tile with a warp-shuffle amax,
on a small one a block of 8 warps a tile; ``x / s`` is an IEEE division
and rounding is half-to-even, so codes are bit-exact.
``dequantize`` takes the payloads as they are (row-strided ``[K, Np]``)
and writes only the ``n`` columns the caller keeps, 16 codes a thread.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

TILE = 1024
LANE = 128  # quantization tiles per block of the reference layout

_Q = _build.register(
    "quantize", "repro_quantize",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
_DQ = _build.register(
    "dequantize", "repro_dequantize",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
     ctypes.c_int, ctypes.c_void_p], packed=True)
MAX_K = 65535        # rows are the grid's y axis


def _cuda_only(t, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def quantize(x, padded=None, warps=0):
    """x: [n] f32 (unit stride, any n) -> (q int8 [padded], scales f32
    [padded/TILE]): the codes of x zero-padded to ``padded`` elements, a
    multiple of TILE and at least n (default: n rounded up to TILE). On
    the card the kernel reads the n floats and writes the padding's codes
    and scales itself, with ``warps`` warps a tile (1 or 8; 0, the
    default, chooses from the tile count); on the CPU the plain version
    quantizes a padded copy."""
    n = x.shape[0] if x.dim() == 1 else -1
    Np = -(-n // TILE) * TILE if padded is None else padded
    if not (n >= 0 and Np % TILE == 0 and Np >= n and warps in (0, 1, 8)
            and (x.stride(0) == 1 or n <= 1)):
        raise ValueError(f"quantize: need x [n] with unit stride and padded "
                         f"a multiple of {TILE} >= n; got x{tuple(x.shape)} "
                         f"strides {x.stride()}, padded={padded}, "
                         f"warps={warps}")
    if x.device.type == "cpu":
        xp = x.to(torch.float32)
        if Np > n:
            xp = torch.cat([xp, xp.new_zeros(Np - n)])
        return ref.quantize_int8(xp, TILE)
    _cuda_only(x, "quantize")
    if x.dtype is not torch.float32:
        raise ValueError(f"quantize: need f32, got {x.dtype}")
    dev = x.get_device()
    q = torch.empty((Np,), dtype=torch.int8, device=x.device)
    s = torch.empty((Np // TILE,), dtype=torch.float32, device=x.device)
    if Np:
        _Q(x.data_ptr(), n, q.data_ptr(), s.data_ptr(), Np, warps,
           _build.raw_stream(dev))
    return q, s


def _plain_dequantize(q, scales, dtype, n):
    rows = ref.dequantize_rows(q.reshape(-1, q.shape[-1]),
                               scales.reshape(-1, scales.shape[-1]), TILE)
    out = rows.reshape(q.shape).to(dtype)
    return out if n is None else out[..., :n]


def dequantize(q, scales, dtype=torch.float32, n=None):
    """q: [Np] or [K, Np] int8 (Np % TILE == 0; rows may be strided);
    scales: [Np/TILE] or [K, Np/TILE] -> the first ``n`` (default Np)
    columns in ``dtype`` (f32 or bf16): a contiguous [n], or a [K, n] view
    whose rows start 16-byte aligned (row stride n rounded up to 16 bytes).
    One launch for any number of rows. The checks are written for a thin
    host path."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return _plain_dequantize(q, scales, dtype, n)
        raise ValueError(f"dequantize: no kernel for device {q.device}")
    bf16 = dtype is torch.bfloat16
    if not bf16 and dtype is not torch.float32:
        raise TypeError(f"dequantize: output must be f32 or bf16, got {dtype}")
    shape, strides = q.shape, q.stride()
    two = len(shape) == 2
    Np = shape[-1] if shape else 0
    K, ldq = (shape[0], strides[0]) if two else (1, Np)
    n = Np if n is None else n
    tiles = Np // TILE
    if not (q.dtype is torch.int8 and len(shape) in (1, 2) and Np % TILE == 0
            and 0 < n <= Np and strides[-1] == 1 and (K == 1 or ldq >= Np)
            and 0 < K <= MAX_K
            and scales.shape == ((K, tiles) if two else (tiles,))):
        raise ValueError(f"dequantize: bad operands q{tuple(shape)} "
                         f"{q.dtype} strides {strides}, "
                         f"scales{tuple(scales.shape)}, n={n} (q [Np] or "
                         f"[K, Np], Np % {TILE} == 0, 1 <= n <= Np, unit "
                         "column stride)")
    dev = q.get_device()
    if not (scales.dtype is torch.float32 and scales.is_contiguous()
            and scales.get_device() == dev):
        scales = scales.to(device=q.device, dtype=torch.float32).contiguous()
    if two:
        a = 8 if bf16 else 4                 # 16 bytes of outputs
        ldo = (n + a - 1) // a * a
        out = torch.empty_strided((K, n), (ldo, 1), dtype=dtype, device=dev)
    else:
        out, ldo = torch.empty(n, dtype=dtype, device=dev), n
    _DQ(q.data_ptr(), ldq, scales.data_ptr(), tiles, out.data_ptr(), ldo, K,
        n, bf16, _build.raw_stream(dev))
    return out
