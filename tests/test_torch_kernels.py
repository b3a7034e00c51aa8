"""The port's kernel wrappers: dispatch by device, padding contract, and (on a
CUDA device) each hand-written kernel against its plain PyTorch version.

This file imports no JAX, so it also runs where only the port is installed:
``python -m pytest -m gpu tests/test_torch_kernels.py`` on the GPU machine.
The parity of the plain versions with the JAX reference lives in
``test_torch_ops.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, q8agg, quant, ref, wsum


def _rng_tensor(shape, seed, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale)
        .astype(np.float32))


def _q8_inputs(m, n, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, (m, n)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-4, 0.05, (m, n // 1024))
                         .astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, m).astype(np.float32))
    return q, s, w


# --------------------------------------------------------------------------- #
# CPU: the wrappers run the plain versions, the ops layer keeps its padding
# --------------------------------------------------------------------------- #

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = _build.launch_counts()
    x, w = _rng_tensor((3, 4096), 0), torch.tensor([0.2, 0.3, 0.5])
    torch.testing.assert_close(wsum.weighted_sum(x, w), ref.weighted_sum(x, w),
                               rtol=0, atol=0)
    xq = _rng_tensor((2048,), 1)
    for a, b in zip(quant.quantize(xq), ref.quantize_int8(xq)):
        assert torch.equal(a, b)
    q, s, wq = _q8_inputs(2, 4096, 2)
    assert torch.equal(quant.dequantize(q, s), ref.dequantize_rows(q, s))
    assert torch.equal(q8agg.wsum_q8(q, s, wq), ref.wsum_q8(q, s, wq))
    assert _build.launch_counts() == before
    assert set(before) == {"weighted_sum", "quantize", "dequantize", "wsum_q8"}


@pytest.mark.parametrize("call", [
    lambda t: wsum.weighted_sum(t((2, 4096)), t((2,))),
    lambda t: quant.quantize(t((1024,))),
    lambda t: quant.dequantize(t((1024,), torch.int8), t((1,))),
    lambda t: q8agg.wsum_q8(t((2, 4096), torch.int8), t((2, 4)), t((2,))),
], ids=["weighted_sum", "quantize", "dequantize", "wsum_q8"])
def test_devices_without_a_kernel_raise(call):
    meta = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype,
                                                          device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call(meta)


def test_quantize_pads_to_the_wire_block_on_cpu():
    """The CPU path gives the default (131072-padded) payload, never the
    tile-padded one: wire bytes depend on it."""
    x = _rng_tensor((62_006,), 3)
    q, s, n = ops.quantize(x)
    assert n == 62_006
    assert q.shape == (ops.QUANT_BLOCK,) and s.shape == (ops.QUANT_BLOCK // 1024,)
    assert torch.all(q[n:] == 0) and torch.all(s[-((ops.QUANT_BLOCK - n) // 1024):] == 1.0)


def test_plain_quantize_rounds_half_to_even_and_keeps_zero_tiles():
    x = torch.zeros(3 * 1024)
    ties = torch.arange(1024, dtype=torch.float32) % 200 - 100.5
    ties[0] = 127.0                       # scale exactly 1.0
    x[1024:2048] = ties
    x[2048:] = _rng_tensor((1024,), 4)
    q, s = quant.quantize(x)
    assert s[0] == 1.0 and torch.all(q[:1024] == 0)      # all-zero tile
    want = np.clip(np.round(ties.numpy()), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q[1024:2048].numpy(), want)


def test_ops_unpadded_lengths_slice_back():
    x, w = _rng_tensor((2, 5000), 5), torch.tensor([0.25, 0.75])
    out = ops.weighted_sum(x, w)
    assert out.shape == (5000,)
    torch.testing.assert_close(out, 0.25 * x[0] + 0.75 * x[1])
    q, s, wq = _q8_inputs(3, 2048, 6)
    got = ops.weighted_sum_q8(q, s, wq, n=1500)
    torch.testing.assert_close(got, ref.wsum_q8(q, s, wq)[:1500])


# --------------------------------------------------------------------------- #
# GPU: each CUDA kernel against its plain version on the card
# --------------------------------------------------------------------------- #

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(name, fn):
    before = _build.KERNELS[name].launches
    out = fn()
    torch.cuda.synchronize()
    assert _build.KERNELS[name].launches == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1, 4096), (2, 65536), (5, 8192), (64, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_weighted_sum(m, n, dtype):
    dev = _cuda()
    x = _rng_tensor((m, n), m * n).to(dev, dtype)
    w = torch.rand(m, device=dev)
    got = _launched("weighted_sum", lambda: wsum.weighted_sum(x, w))
    want = ref.weighted_sum(x, w)
    assert got.dtype == dtype
    # f32: an m-term sum in another order; bf16: one rounding of the output
    tol = (m * 2.0 ** -23) if dtype == torch.float32 else 2.0 ** -7
    scale = float((w[:, None] * x.float().abs()).sum(0).max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 131072, 4 * 131072])
def test_gpu_quantize_bit_exact(n):
    dev = _cuda()
    x = _rng_tensor((n,), n, scale=0.1).to(dev)
    x[:1024] = 0.0
    if n > 2048:
        ties = torch.arange(1024, device=dev, dtype=torch.float32) % 200 - 100.5
        ties[0] = 127.0
        x[1024:2048] = ties
    q, s = _launched("quantize", lambda: quant.quantize(x))
    q0, s0 = ref.quantize_int8(x)
    assert torch.equal(q, q0) and torch.equal(s, s0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_dequantize_bit_exact(k, dtype):
    dev = _cuda()
    q, s, _ = _q8_inputs(k, 131072, k)
    q, s = q.to(dev), s.to(dev)
    got = _launched("dequantize", lambda: quant.dequantize(q, s, dtype))
    assert torch.equal(got, ref.dequantize_rows(q, s).to(dtype))
    one = _launched("dequantize", lambda: quant.dequantize(q[0], s[0], dtype))
    assert torch.equal(one, got[0])


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1, 4096), (2, 131072), (7, 12288)])
def test_gpu_wsum_q8(m, n):
    dev = _cuda()
    q, s, w = (t.to(dev) for t in _q8_inputs(m, n, m + n))
    got = _launched("wsum_q8", lambda: q8agg.wsum_q8(q, s, w))
    want = ref.wsum_q8(q, s, w)
    scale = 127.0 * float((w[:, None] * s).sum(0).max())
    assert float((got - want).abs().max()) <= m * 2.0 ** -22 * scale


@pytest.mark.gpu
def test_gpu_ops_match_the_cpu_path():
    """The ops layer (padding, slicing) gives the CPU path's numbers."""
    dev = _cuda()
    x = _rng_tensor((62_006,), 7)
    for a, b in zip(ops.quantize(x.to(dev))[:2], ops.quantize(x)[:2]):
        assert torch.equal(a.cpu(), b)
    xs, w = _rng_tensor((2, 62_006), 8), torch.tensor([0.5, 0.5])
    torch.testing.assert_close(ops.weighted_sum(xs.to(dev), w.to(dev)).cpu(),
                               ops.weighted_sum(xs, w), rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
def test_gpu_wrappers_refuse_misaligned_and_malformed_operands():
    dev = _cuda()
    x = torch.zeros(4096 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        quant.quantize(x[1:1025])
    with pytest.raises(ValueError):
        wsum.weighted_sum(torch.zeros((2, 1000), device=dev),
                          torch.ones(2, device=dev))
