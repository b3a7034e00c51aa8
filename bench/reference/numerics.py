"""The arithmetic of the plain references: every matrix product goes
through a ``Numerics`` object, so that one reference runs as the judge
(float32, TF32 off) or as the control the judge must reject (fp8: each
product's operands rounded to float8 e4m3 with one scale a tensor, its
gradients to e5m2, as an fp8 training recipe rounds them).

Plain PyTorch only: nothing here imports the program.
"""
from __future__ import annotations

import torch

F32 = torch.float32
PRECISIONS = ("float32", "fp8")


def _round8(x, dtype):
    """``x`` rounded to the float8 ``dtype`` under one scale that maps its
    largest magnitude to the format's largest finite value; float32 out."""
    top = torch.finfo(dtype).max
    s = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(F32) * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


class Numerics:
    """``mm`` and ``einsum`` in float32, their operands first rounded to
    fp8 when ``precision`` is 'fp8'."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def cast(self, x):
        x = x.to(F32)
        return _Fp8.apply(x) if self.precision == "fp8" else x

    def mm(self, a, b):
        return self.cast(a) @ self.cast(b)

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *(self.cast(o) for o in ops))


def no_tf32() -> None:
    """float32 products in float32: TF32 rounds their operands to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
