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

from repro_torch.kernels import (_build, multikrum, ops, q8agg, quant, ref,
                                 rwkv6, wsum)


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


def _wkv6_inputs(B, T, H, hs, seed, dtype=torch.float32):
    """r, k, v (in ``dtype``), w as the model draws it (exp(-exp(decay_base
    + dw)), f32), u and a random f32 state."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = (torch.from_numpy(n(B, T, H, hs)).to(dtype) for _ in range(3))
    base = rng.uniform(-7.0, -1.0, (H, hs)).astype(np.float32)
    w = torch.from_numpy(np.exp(-np.exp(base + 0.5 * n(B, T, H, hs))))
    u = torch.from_numpy(rng.uniform(0.0, 0.5, (H, hs)).astype(np.float32))
    return r, k, v, w, u, torch.from_numpy(n(B, H, hs, hs))


# --------------------------------------------------------------------------- #
# CPU: the wrappers run the plain versions; ops pads only for the wire
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
    base = _rng_tensor((131072,), 9)
    qd, sd, _ = _q8_inputs(1, 131072, 10)
    assert torch.equal(q8agg.add_q8_delta(base, qd[0], sd[0]),
                       ref.add_q8_delta(base, qd[0], sd[0]))
    for a, b in zip(q8agg.gram_q8(q, s), ref.gram_q8(q, s)):
        assert torch.equal(a, b)
    xg = _rng_tensor((3, 2048), 11)
    for a, b in zip(multikrum.gram_and_norms(xg), ref.gram_and_norms(xg)):
        assert torch.equal(a, b)
    args = _wkv6_inputs(2, 5, 2, 16, 12)
    for a, b in zip(rwkv6.wkv6(*args), ref.wkv6_naive(*args)):
        assert torch.equal(a, b)
    leaves = [a.clone().requires_grad_() for a in args[:5]]
    dy = torch.ones_like(args[0])
    got = torch.autograd.grad(rwkv6.WKV6.apply(*leaves, args[5])[0], leaves,
                              dy)
    for a, b in zip(got, ref.wkv6_backward_naive(*args, dy)):
        assert torch.equal(a, b)
    assert _build.launch_counts() == before
    assert set(before) == {"weighted_sum", "quantize", "dequantize", "wsum_q8",
                           "add_q8_delta", "gram_q8", "gram_and_norms",
                           "wkv6", "wkv6_backward"}


@pytest.mark.parametrize("call", [
    lambda t: wsum.weighted_sum(t((2, 4096)), t((2,))),
    lambda t: quant.quantize(t((1024,))),
    lambda t: quant.dequantize(t((1024,), torch.int8), t((1,))),
    lambda t: q8agg.wsum_q8(t((2, 4096), torch.int8), t((2, 4)), t((2,))),
    lambda t: q8agg.add_q8_delta(t((131072,)), t((131072,), torch.int8),
                                 t((128,))),
    lambda t: q8agg.gram_q8(t((2, 4096), torch.int8), t((2, 4))),
    lambda t: multikrum.gram_and_norms(t((2, 2048))),
    lambda t: rwkv6.wkv6(*(t(s) for s in ((1, 4, 2, 16),) * 4),
                         t((2, 16)), t((1, 2, 16, 16))),
], ids=["weighted_sum", "quantize", "dequantize", "wsum_q8", "add_q8_delta",
        "gram_q8", "gram_and_norms", "wkv6"])
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


@pytest.mark.parametrize("n,padded", [(0, 1024), (1, None), (1000, 2048),
                                      (3000, 131072)])
def test_quantize_writes_the_zero_padding(n, padded):
    """The codes of x zero-padded to ``padded`` (default n rounded up to a
    tile): zero codes and the scale 1.0 past the last tile x reaches."""
    x = _rng_tensor((n,), 20 + n)
    q, s = quant.quantize(x, padded)
    Np = -(-n // 1024) * 1024 if padded is None else padded
    assert q.shape == (Np,) and s.shape == (Np // 1024,)
    for a, b in zip((q, s), ref.quantize_int8(
            torch.cat([x, torch.zeros(Np - n)]))):
        assert torch.equal(a, b)
    assert torch.all(q[n:] == 0) and torch.all(s[-(-n // 1024):] == 1.0)


@pytest.mark.parametrize("x,padded", [
    (torch.zeros(1000), 1000), (torch.zeros(2048), 1024),
    (torch.zeros(4096)[::2], None), (torch.zeros((2, 1024)), None)],
    ids=["not-a-tile-multiple", "below-n", "strided", "two-dimensional"])
def test_quantize_refuses_bad_operands(x, padded):
    with pytest.raises(ValueError):
        quant.quantize(x, padded)


@pytest.mark.parametrize("warps", [-1, 2, 4, 32])
def test_quantize_refuses_other_warp_counts(warps):
    with pytest.raises(ValueError):
        quant.quantize(torch.zeros(1024), None, warps)


def test_wsum_q8_keeps_n_columns_of_strided_payloads():
    """The plain path of ``wsum_q8``: any row stride, the first n columns,
    bit for bit the kernels' FMA chain."""
    q, s, w = _q8_inputs(3, 8192, 21)
    qv = torch.zeros((3, 8192 + 1024), dtype=torch.int8)[:, :8192]
    qv.copy_(q)
    got = q8agg.wsum_q8(qv, s, w, 5000)
    fw = (w[:, None] * s).repeat_interleave(1024, 1)
    assert got.shape == (5000,)
    assert torch.equal(got, ref.weighted_sum_ordered(q.float(), fw)[:5000])
    assert torch.equal(q8agg.wsum_q8(q, s, w), ref.wsum_q8(q, s, w))


def test_ops_unpadded_lengths_slice_back():
    x, w = _rng_tensor((2, 5000), 5), torch.tensor([0.25, 0.75])
    out = ops.weighted_sum(x, w)
    assert out.shape == (5000,)
    torch.testing.assert_close(out, 0.25 * x[0] + 0.75 * x[1])
    q, s, wq = _q8_inputs(3, 2048, 6)
    got = ops.weighted_sum_q8(q, s, wq, n=1500)
    torch.testing.assert_close(got, ref.wsum_q8(q, s, wq)[:1500])


def test_ops_hand_views_straight_to_the_kernels(monkeypatch):
    """No F.pad and no copy: the f32 weighted sum and Gram get the caller's
    row-strided view itself, at any N."""
    def refuse(*a, **k):
        raise AssertionError("ops padded an operand")

    monkeypatch.setattr(torch.nn.functional, "pad", refuse)
    seen = []
    monkeypatch.setattr(ops._ws, "weighted_sum",
                        lambda a, w: seen.append(a) or ref.weighted_sum(a, w))
    monkeypatch.setattr(ops._mk, "gram_and_norms",
                        lambda a: seen.append(a) or ref.gram_and_norms(a))
    x = _rng_tensor((3, 8192), 13)[:, :6001]
    w = torch.tensor([0.2, 0.3, 0.5])
    assert ops.weighted_sum(x, w).shape == (6001,)
    assert ops.pairwise_dists(x).shape == (3, 3)
    assert len(seen) == 2
    for a in seen:
        assert (a.data_ptr(), a.shape, a.stride()) == \
            (x.data_ptr(), x.shape, x.stride())


def test_ops_hand_int8_payloads_straight_to_the_kernels(monkeypatch):
    """No F.pad and no slice: ``dequantize``, ``dequantize_batch``,
    ``add_q8_delta``, ``quantize`` and ``weighted_sum_q8`` hand their
    wrappers the caller's own tensors and the length to keep
    (``quantize``: the payload's), and return what the wrapper returns."""
    def refuse(*a, **k):
        raise AssertionError("ops padded an operand")

    monkeypatch.setattr(torch.nn.functional, "pad", refuse)
    seen, outs = [], []

    def spy(fn):
        def call(*args):
            seen.append(args)
            outs.append(fn(*args))
            return outs[-1]
        return call

    monkeypatch.setattr(ops._q, "dequantize", spy(quant.dequantize))
    monkeypatch.setattr(ops._q8, "add_q8_delta", spy(q8agg.add_q8_delta))
    monkeypatch.setattr(ops._q, "quantize", spy(quant.quantize))
    monkeypatch.setattr(ops._q8, "wsum_q8", spy(q8agg.wsum_q8))
    q, s, w = _q8_inputs(2, 131072, 15)
    base = _rng_tensor((6002,), 16)[1:6001]
    results = [ops.dequantize(q[1], s[1], 6000),
               ops.dequantize_batch(q, s, 6000, torch.bfloat16),
               ops.add_q8_delta(base, q[0], s[0], 6000)]
    # quantize: an [n] view at an offset; the merge: a row-strided view
    qv = torch.zeros((2, 131072 + 1024), dtype=torch.int8)[:, :131072]
    qv.copy_(q)
    coded = ops.quantize(base)
    merged = ops.weighted_sum_q8(qv, s, w, 6000)
    assert [a[-1] for a in seen[3:]] == [ops.QUANT_BLOCK, 6000]
    for got, want in zip((seen[3][0],) + seen[4][:3], (base, qv, s, w)):
        assert (got.data_ptr(), got.shape, got.stride()) == \
            (want.data_ptr(), want.shape, want.stride())
    assert all(a is b for a, b in zip(coded[:2], outs[3]))
    assert coded[2] == 6000 and merged is outs[4]
    padded = torch.cat([base, torch.zeros(ops.QUANT_BLOCK - 6000)])
    for a, b in zip(coded[:2], ref.quantize_int8(padded)):
        assert torch.equal(a, b)
    assert torch.equal(merged, ref.wsum_q8(q, s, w)[:6000])
    del seen[3:], outs[3:]
    assert [a[-1] for a in seen] == [6000, 6000, 6000]
    handed = [(seen[0][0], seen[0][1]), (seen[1][0], seen[1][1]),
              (seen[2][0], seen[2][1]), (seen[2][2],)]
    for got, want in zip(handed, [(q[1], s[1]), (q, s), (base, q[0]),
                                  (s[0],)]):
        for a, b in zip(got, want):
            assert (a.data_ptr(), a.shape, a.stride()) == \
                (b.data_ptr(), b.shape, b.stride())
    assert seen[1][2] is torch.bfloat16
    assert all(r is o for r, o in zip(results, outs))
    assert [tuple(r.shape) for r in results] == [(6000,), (2, 6000), (6000,)]


def test_fedavg_keeps_its_weights_on_the_host(monkeypatch):
    """FedAvg hands the kernel layer host weights (no host-to-device copy):
    normalised in float64, then cast to float32, as before; the average is
    the plain weighted sum with exactly those weights."""
    from repro_torch.fed import aggregator
    seen = {}
    real = aggregator.ops.weighted_sum

    def spy(x, w):
        seen["w"] = w
        return real(x, w)

    monkeypatch.setattr(aggregator.ops, "weighted_sum", spy)
    clients = [{"conv": {"b": _rng_tensor((6,), 20 + i),
                         "w": _rng_tensor((5, 5, 3, 6), 30 + i)},
                "fc": _rng_tensor((7,), 40 + i)} for i in range(3)]
    samples = [120, 75, 311]
    got = aggregator.fedavg_params(clients, samples)
    w = seen["w"]
    assert w.device.type == "cpu" and w.dtype == torch.float32
    w64 = np.asarray(samples, np.float64)
    np.testing.assert_array_equal(w.numpy(),
                                  (w64 / w64.sum()).astype(np.float32))
    vecs, spec = ops.flatten_batch(clients)
    want = ops.unflatten_pytree(ref.weighted_sum(vecs, w), spec)
    for (p, a), (_, b) in zip(ops.tree.leaves_with_paths(got),
                              ops.tree.leaves_with_paths(want)):
        assert torch.equal(a, b), p


def _f32_of(q):
    """The float32 nearest the rational q, ties to even (exact)."""
    from fractions import Fraction
    a = np.float32(float(q))
    near = [a, np.nextafter(a, np.float32(np.inf)),
            np.nextafter(a, np.float32(-np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - q),
                                    int(np.float32(c).view(np.uint32)) & 1))


def test_weighted_sum_ordered_rounds_each_fma_once():
    """The kernel's arithmetic, emulated: every step a float32 FMA rounded
    once, against exact rationals; the tie cases a float64 sum alone would
    round the wrong way included."""
    from fractions import Fraction
    rng = np.random.default_rng(14)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, 4).astype(np.float32)
    # acc = 1 + 2^-23; the product 2^-24 (1 - 2^-46) sits just under the
    # midpoint, which float64 rounds onto (and ties-to-even would round up)
    x[:2, 0] = [1 + 2.0 ** -23, 2.0 ** -24 * (1 - 2.0 ** -23)]
    x[2:, 0] = 0.0
    w[:2] = [1.0, 1 + 2.0 ** -23]
    got = ref.weighted_sum_ordered(torch.from_numpy(x), torch.from_numpy(w))
    assert got[0] == np.float32(1 + 2.0 ** -23)
    for n in range(x.shape[1]):
        acc = np.float32(0.0)
        for m in range(x.shape[0]):
            acc = _f32_of(Fraction(float(w[m])) * Fraction(float(x[m, n]))
                          + Fraction(float(acc)))
        assert acc.tobytes() == got[n].numpy().tobytes(), n


@pytest.mark.parametrize("offset,ld", [(0, 2048), (16, 2048), (1, 2048),
                                       (0, 2056), (0, 2049)])
def test_gram_rows_copies_only_what_the_kernel_cannot_read(offset, ld):
    """``gram_q8``'s operand: rows at a 16-byte base and row stride pass as
    they are; a contiguous view at a misaligned base gets a fresh aligned
    copy (``contiguous`` would return the view itself), a row stride off
    16 bytes a contiguous one."""
    M, N = 3, 2048
    flat = torch.from_numpy(np.random.default_rng(5).integers(
        -127, 128, offset + M * ld).astype(np.int8))
    q = flat[offset:].view(M, ld)[:, :N]
    got, got_ld = q8agg.gram_rows(q)
    assert torch.equal(got, q)
    assert got.data_ptr() % 16 == 0 and got_ld % 16 == 0
    assert got.stride() == (got_ld, 1)
    kept = offset % 16 == 0 and ld % 16 == 0
    assert (got.data_ptr() == q.data_ptr()) == kept
    assert got_ld == (ld if kept else N)


@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_operands_copy_only_what_the_kernel_cannot_read(offset, dtype):
    """``wkv6``'s operands at a base off a 4-element vector get a fresh
    aligned copy (a contiguous view would come back as it is from
    ``contiguous``); aligned ones pass as they are."""
    inputs = _wkv6_inputs(2, 5, 3, 16, 7, dtype)[:4]

    def at_offset(t):
        flat = torch.zeros(offset + t.numel(), dtype=t.dtype)
        flat[offset:] = t.reshape(-1)
        return flat[offset:].view(t.shape)

    views = [at_offset(t) for t in inputs]
    for got, view, want in zip(rwkv6.kernel_operands(*views), views, inputs):
        assert torch.equal(got, want)
        assert got.data_ptr() % (4 * got.element_size()) == 0
        assert all(st % 4 == 0 for st in got.stride()[:3])
        assert (got.data_ptr() == view.data_ptr()) == (offset % 4 == 0)


def test_gram_scratch_is_one_pair_a_device_and_stream(monkeypatch):
    """The Gram kernels' ticket and partials: one pair for each (device,
    stream), grown in place of the partials, never shared across streams."""
    monkeypatch.setattr(_build, "_GRAM_SCRATCH", {})
    x = torch.zeros(1)
    ticket, part = _build.gram_scratch(x, 3, 11)
    assert ticket.dtype == torch.int32 and int(ticket) == 0
    assert part.numel() == 3 * _build.GRAM_PART_BLOCKS
    assert _build.gram_scratch(x, 1, 11)[1] is part
    other = _build.gram_scratch(x, 3, 12)
    assert other[0] is not ticket and other[1] is not part
    grown = _build.gram_scratch(x, 6, 11)
    assert grown[0] is ticket
    assert grown[1].numel() == 6 * _build.GRAM_PART_BLOCKS


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
@pytest.mark.parametrize("warps", [0, 1, 8])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("n,padded", [
    (1024, None), (131072, None), (4 * 131072, None), (1, 1024),
    (1023, 131072), (3000, 3 * 131072), (62_006, 131072),
    (131_073, 262_144)])
def test_gpu_quantize_bit_exact(n, padded, offset, warps):
    """Codes and scales of x zero-padded to ``padded``, bit for bit, with x
    at 16-, 4- and 8-byte alignment (``offset`` floats into a buffer) and
    each body (one warp a tile, a block of 8 a tile, and the one chosen):
    from n = 2048 on an all-zero tile and a tile of .5 ties holding +amax
    and -amax; the ragged tile masked, the tiles past n zero codes and the
    scale 1.0."""
    dev = _cuda()
    x = _rng_tensor((n + offset,), n, scale=0.1).to(dev)[offset:]
    if n >= 2048:
        x[:1024] = 0.0
        ties = torch.arange(1024, device=dev, dtype=torch.float32) % 200 - 100.5
        ties[0], ties[1] = 127.0, -127.0
        x[1024:2048] = ties
    q, s = _launched("quantize", lambda: quant.quantize(x, padded, warps))
    Np = -(-n // 1024) * 1024 if padded is None else padded
    q0, s0 = ref.quantize_int8(torch.cat([x, torch.zeros(Np - n,
                                                         device=dev)]))
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


_WSUM_Q8_CASES = (
    [(1, 4096, 4096, "contiguous"), (2, 131072, 131072, "contiguous"),
     (7, 12288, 12288, "contiguous")]
    + [(m, 131_072, 62_006, layout) for m in (1, 2, 3, 8, 9, 17)
       for layout in ("strided", "offset1")]
    + [(m, 5120, 5000, "offset4") for m in (4, 5, 6, 16)])


@pytest.mark.gpu
@pytest.mark.parametrize("m,np_,n,layout", _WSUM_Q8_CASES)
def test_gpu_wsum_q8(m, np_, n, layout):
    """Each template (M = 1..3) and the loop over groups of 3 (4 to 17:
    a last group of 1, 2 or 3), ragged n and row-strided or misaligned
    codes (``_codes``): bit for bit the FMA chain
    ``ref.weighted_sum_ordered`` of w_m s_m against the codes."""
    dev = _cuda()
    q, s = _codes(m, np_, layout, dev, seed=m + np_)
    w = torch.from_numpy(np.random.default_rng(m).uniform(0.1, 1.0, m)
                         .astype(np.float32)).to(dev)
    got = _launched("wsum_q8", lambda: q8agg.wsum_q8(q, s, w, n))
    fw = (w[:, None] * s).repeat_interleave(1024, 1)
    assert got.shape == (n,)
    assert torch.equal(got, ref.weighted_sum_ordered(q.float(), fw)[:n])
    assert torch.equal(got, ref.wsum_q8(q, s, w)[:n])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [131072, 4 * 131072])
def test_gpu_add_q8_delta_bit_exact(n):
    """fmaf on the card, one float64 rounding on the CPU: the same bits."""
    dev = _cuda()
    q, s, _ = _q8_inputs(1, n, n)
    base = _rng_tensor((n,), n + 1, scale=0.05).to(dev)
    q, s = q[0].to(dev), s[0].to(dev)
    got = _launched("add_q8_delta", lambda: q8agg.add_q8_delta(base, q, s))
    assert torch.equal(got, ref.add_q8_delta(base, q, s))
    assert torch.equal(got.cpu(), ref.add_q8_delta(base.cpu(), q.cpu(),
                                                   s.cpu()))


def _codes(k, np_, layout, dev, seed):
    """[k, np_] codes and [k, np_/1024] scales on the card: "contiguous",
    "strided" (the [:, :np_] view of [k, np_ + 1024]), or at a 4-byte
    ("offset4") or 1-byte ("offset1") offset from a 16-byte boundary (then
    the row stride is np_ + 4 or np_ + 1)."""
    q, s, _ = _q8_inputs(k, np_, seed)
    extra = {"contiguous": 0, "strided": 1024, "offset4": 4, "offset1": 1}
    off = extra[layout] if layout.startswith("offset") else 0
    buf = torch.zeros((k, np_ + extra[layout]), dtype=torch.int8, device=dev)
    buf[:, off:off + np_] = q.to(dev)
    return buf[:, off:off + np_], s.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n,np_", [(1, 1024), (15, 1024), (17, 1024),
                                   (1023, 1024), (62_006, 131_072),
                                   (131_072, 131_072), (131_073, 262_144)])
@pytest.mark.parametrize("k,layout", [(1, "contiguous"), (3, "strided"),
                                      (3, "offset4"), (2, "offset1")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_dequantize_ragged_and_strided(n, np_, k, layout, dtype):
    """Only the n columns kept, from row-strided codes at any alignment:
    the plain version's bits, one launch, rows 16-byte aligned."""
    dev = _cuda()
    q, s = _codes(k, np_, layout, dev, n + k)
    got = _launched("dequantize",
                    lambda: quant.dequantize(q, s, dtype, n))
    assert got.shape == (k, n) and got.dtype == dtype
    assert got.stride(1) == 1 and got.stride(0) * got.element_size() % 16 == 0
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got, ref.dequantize_rows(q, s)[:, :n].to(dtype))
    one = _launched("dequantize",
                    lambda: ops.dequantize(q[-1], s[-1], n, dtype))
    assert one.shape == (n,) and one.is_contiguous()
    assert torch.equal(one, got[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,np_", [(1, 1024), (15, 1024), (17, 1024),
                                   (1023, 1024), (62_006, 131_072),
                                   (131_073, 262_144),
                                   ((1 << 20) + 17, (1 << 20) + 1024)])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_gpu_add_q8_delta_ragged_and_misaligned(n, np_, offset):
    """A base of n floats at a 0-, 4- or 8-byte offset from a 16-byte
    boundary, the payload's codes as they are: the plain version's bits
    (fmaf on the card, one float64 rounding on the CPU), one launch; from
    2^20 elements on the kernel takes four vectors a thread."""
    dev = _cuda()
    q, s, _ = _q8_inputs(1, np_, n + offset)
    q, s = q[0].to(dev), s[0].to(dev)
    buf = _rng_tensor((n + offset,), n, scale=0.05).to(dev)
    base = buf[offset:]
    assert base.data_ptr() % 16 == 4 * offset
    got = _launched("add_q8_delta",
                    lambda: ops.add_q8_delta(base, q, s, n))
    assert got.shape == (n,)
    assert torch.equal(got, ref.add_q8_delta(base, q[:n], s))
    assert torch.equal(got.cpu(), ref.add_q8_delta(base.cpu(), q[:n].cpu(),
                                                   s.cpu()))


@pytest.mark.gpu
def test_gpu_int8_ops_launch_once_and_nothing_else():
    """At the paper CNN's n from 131,072 payloads, each ops call is exactly
    one launch of its own kernel (no pad, no copy, no plain fallback); a
    base that is a row of the dequantized stack included."""
    dev = _cuda()
    q, s = _codes(2, 131_072, "contiguous", dev, 3)
    for name, call in [
            ("dequantize", lambda: ops.dequantize(q[0], s[0], 62_006)),
            ("dequantize", lambda: ops.dequantize_batch(q, s, 62_006)),
            ("add_q8_delta", lambda: ops.add_q8_delta(
                ops.dequantize_batch(q, s, 62_006)[1], q[0], s[0], 62_006))]:
        call()                                    # the row: built first
        before = _build.launch_counts()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        after = _build.launch_counts()
        delta = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        if name == "add_q8_delta":   # the base's own dequantize, then ours
            assert delta == {"dequantize": 1, "add_q8_delta": 1}
        else:
            assert delta == {name: 1}
        # the profiler may drop events, never add them: no other kernel
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(e.count for e in kern) <= sum(delta.values())
        assert all("dequantize_kernel" in e.key or "add_q8_delta_kernel"
                   in e.key for e in kern), [e.key for e in kern]


@pytest.mark.gpu
def test_gpu_int8_wrappers_refuse_malformed_operands():
    dev = _cuda()
    q, s = _codes(2, 4096, "contiguous", dev, 4)
    with pytest.raises(ValueError):
        quant.dequantize(q, s[:, :3])                   # wrong scales length
    with pytest.raises(ValueError):
        quant.dequantize(q, s, n=4097)                  # n > Np
    with pytest.raises(ValueError):
        quant.dequantize(q[:, :4000], s)                # Np % 1024
    with pytest.raises(ValueError):
        quant.dequantize(q.T.contiguous().T, s)         # column stride
    base = torch.zeros(4096, device=dev)
    with pytest.raises(ValueError):
        q8agg.add_q8_delta(base, q[0], s[0, :3])        # wrong scales length
    with pytest.raises(ValueError):
        q8agg.add_q8_delta(torch.zeros(5000, device=dev), q[0], s[0])
    with pytest.raises(ValueError):
        q8agg.add_q8_delta(base[:100], q[0], s[0], 200)  # base too short
    with pytest.raises(ValueError, match="1024-aligned"):
        ops.add_q8_delta(base, q[0, :1000], s[0])


def _assert_gram(got, want, x):
    """G and sq within 2^-16 * ‖x_i‖ * ‖x_j‖: float32 sums over N in other
    orders (the kernel: per block, then across blocks; cuBLAS: its own)."""
    norms = x.double().pow(2).sum(1).sqrt()
    bound = 2.0 ** -16 * norms[:, None] * norms[None, :]
    assert ((got[0].double() - want[0].double()).abs() <= bound).all()
    assert ((got[1][:, 0].double() - want[1][:, 0].double()).abs()
            <= bound.diagonal()).all()
    assert torch.equal(got[0], got[0].T)                   # fixed order
    assert torch.equal(got[1][:, 0], got[0].diagonal())


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1, 4096), (3, 131072), (8, 12288),
                                 (64, 4096), (5, 1024 * 2000),
                                 (3, 61 * 1024), (8, 2 ** 20 + 1024),
                                 (12, 5 * 1024), (1, 1024)])
def test_gpu_gram_q8(m, n):
    dev = _cuda()
    q, s, _ = _q8_inputs(m, n, m * n)
    q, s = q.to(dev), s.to(dev)
    got = _launched("gram_q8", lambda: q8agg.gram_q8(q, s))
    _assert_gram(got, ref.gram_q8(q, s), ref.dequantize_rows(q, s))
    again = q8agg.gram_q8(q, s)          # no atomics: the same bits again
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.gpu
def test_gpu_gram_q8_launches_once_and_nothing_else():
    """At the paper CNN's payloads (M 3 x 131,072, and the 61 tiles that
    hold its 62,006 parameters), a ``gram_q8`` call and an
    ``ops.pairwise_dists_q8`` call launch ``gram_q8_kernel`` once: no
    second pass, no pad, no copy; row-strided payloads included."""
    dev = _cuda()
    q, s, _ = _q8_inputs(3, 131_072, 17)
    q, s = q.to(dev), s.to(dev)
    for call in [lambda: q8agg.gram_q8(q, s),
                 lambda: q8agg.gram_q8(q[:, :61 * 1024], s[:, :61]),
                 lambda: ops.pairwise_dists_q8(q[:, :61 * 1024], s[:, :61])]:
        call()
        before = _build.launch_counts()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        after = _build.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {"gram_q8": 1}
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        grams = [e for e in kern if "gram_q8_kernel" in e.key]
        assert sum(e.count for e in grams) <= 1
        if isinstance(out, tuple):    # the wrapper: nothing but the kernel
            assert len(grams) == len(kern), [e.key for e in kern]
    want = ref.gram_q8(q[:, :61 * 1024], s[:, :61])
    got = q8agg.gram_q8(q[:, :61 * 1024], s[:, :61])
    _assert_gram(got, want, ref.dequantize_rows(q[:, :61 * 1024], s[:, :61]))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1, 2048), (3, 63488), (8, 2048 * 1100),
                                 (64, 4096), (23, 6144)])
def test_gpu_gram_and_norms(m, n):
    dev = _cuda()
    x = _rng_tensor((m, n), m + n).to(dev)
    got = _launched("gram_and_norms", lambda: multikrum.gram_and_norms(x))
    _assert_gram(got, ref.gram_and_norms(x), x)
    again = multikrum.gram_and_norms(x)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def _operand(m, n, layout, dev, dtype=torch.float32, seed=0):
    """[m, n] on the card: "contiguous" (rows 8-byte aligned at an odd
    n * 4 / 8), "strided" (the [:, :n] view of [m, 131072]), "offset" (the
    [:, 1:] view of [m, n + 1]: a 4-byte base and row stride)."""
    width = {"contiguous": n, "strided": 131_072, "offset": n + 1}[layout]
    buf = _rng_tensor((m, width), seed).to(dev, dtype)
    return buf[:, 1:] if layout == "offset" else buf[:, :n]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,layout", [
    (2, 62_006, "contiguous"), (2, 62_006, "strided"), (3, 62_007, "offset"),
    (5, 1, "contiguous"), (1, 13, "offset"), (9, 4099, "strided")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_weighted_sum_ragged_and_strided(m, n, layout, dtype):
    """Any N, any row stride, every vector width: the plain version's
    numbers, and equal bits from host and card weights."""
    dev = _cuda()
    x = _operand(m, n, layout, dev, dtype, seed=m + n)
    w = torch.rand(m, generator=torch.Generator().manual_seed(n))
    got = _launched("weighted_sum", lambda: wsum.weighted_sum(x, w))
    on_card = _launched("weighted_sum",
                        lambda: wsum.weighted_sum(x, w.to(dev)))
    assert got.shape == (n,) and torch.equal(got, on_card)
    want = ref.weighted_sum(x, w.to(dev))
    tol = (m * 2.0 ** -23) if dtype == torch.float32 else 2.0 ** -7
    scale = float((w.to(dev)[:, None] * x.float().abs()).sum(0).max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
    # and bit for bit the ordered FMA chain, whatever the vector width
    assert torch.equal(got, ref.weighted_sum_ordered(x.float(), w).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,layout", [
    (3, 62_006, "contiguous"), (3, 62_006, "strided"), (8, 62_007, "offset"),
    (1, 1, "contiguous"), (5, 300, "offset"), (12, 5000, "contiguous"),
    (17, 10_000, "strided"), (64, 777, "contiguous")])
def test_gpu_gram_and_norms_ragged_and_strided(m, n, layout):
    """One launch a call at any N and row stride; G symmetric, sq its
    diagonal, a rerun the same bits."""
    dev = _cuda()
    x = _operand(m, n, layout, dev, seed=m * n)
    got = _launched("gram_and_norms", lambda: multikrum.gram_and_norms(x))
    _assert_gram(got, ref.gram_and_norms(x), x)
    again = multikrum.gram_and_norms(x)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.gpu
def test_gpu_gram_wrappers_refuse_more_than_64_models():
    dev = _cuda()
    with pytest.raises(ValueError, match="M <= 64"):
        multikrum.gram_and_norms(torch.zeros((65, 2048), device=dev))
    with pytest.raises(ValueError, match="M <= 64"):
        q8agg.gram_q8(torch.zeros((65, 4096), dtype=torch.int8, device=dev),
                      torch.ones((65, 4), device=dev))


@pytest.mark.gpu
def test_gpu_ops_match_the_cpu_path():
    """The ops layer (padding, slicing) gives the CPU path's numbers."""
    dev = _cuda()
    x = _rng_tensor((62_006,), 7)
    for a, b in zip(ops.quantize(x.to(dev))[:2], ops.quantize(x)[:2]):
        assert torch.equal(a.cpu(), b)
    # the int8 merge: the same FMA chain on both, so the same bits
    q, s, wq = _q8_inputs(3, 131072, 17)
    got = ops.weighted_sum_q8(q.to(dev), s.to(dev), wq.to(dev), 62_006)
    assert torch.equal(got.cpu(), ops.weighted_sum_q8(q, s, wq, 62_006))
    xs, w = _rng_tensor((2, 62_006), 8), torch.tensor([0.5, 0.5])
    torch.testing.assert_close(ops.weighted_sum(xs.to(dev), w.to(dev)).cpu(),
                               ops.weighted_sum(xs, w), rtol=1e-6, atol=1e-7)
    # distances cancel: within a few ulps of the largest squared norm
    xm = _rng_tensor((3, 62_006), 9)
    d = ops.pairwise_dists(xm.to(dev)).cpu()
    assert float((d - ops.pairwise_dists(xm)).abs().max()) <= \
        4 * 2.0 ** -16 * float(xm.pow(2).sum(1).max())
    assert torch.equal(d.diagonal(), torch.zeros(3))   # G[i, i] == sq[i]


@pytest.mark.gpu
def test_gpu_wrappers_refuse_misaligned_and_malformed_operands():
    dev = _cuda()
    x = torch.zeros(4096 + 1, device=dev)
    # quantize takes any 4-byte offset now; a column stride or a padding
    # that is no whole number of tiles not
    with pytest.raises(ValueError):
        quant.quantize(x[1::2])
    with pytest.raises(ValueError):
        quant.quantize(x[1:1025], 1000)
    with pytest.raises(ValueError):
        q8agg.wsum_q8(torch.zeros((2, 1024), dtype=torch.int8, device=dev),
                      torch.ones((2, 1), device=dev),
                      torch.ones(2, device=dev), 1025)
    # any N and a row stride are fine now; a wrong w or a column stride not
    x2 = torch.zeros((2, 1000), device=dev)
    with pytest.raises(ValueError):
        wsum.weighted_sum(x2, torch.ones(3, device=dev))
    with pytest.raises(ValueError):
        wsum.weighted_sum(torch.zeros((1000, 2), device=dev).T,
                          torch.ones(2, device=dev))
    with pytest.raises(ValueError):
        multikrum.gram_and_norms(torch.zeros((1000, 2), device=dev).T)


def _assert_wkv6(got, want, rel=1e-5):
    """|dy| <= rel*max|y| (plus one ulp of |y| for a bf16 y) and |dS| <=
    rel*max|S|: float32 sums over the key index in another order; the
    token scan itself sits within about 1e-6 of float64 at T <= 4096."""
    (y, s), (y0, s0) = got, want
    assert y.dtype == y0.dtype and s.dtype == torch.float32
    ulp = 2.0 ** -7 if y.dtype == torch.bfloat16 else 0.0
    y, y0 = y.float(), y0.float()
    assert ((y - y0).abs() <= rel * y0.abs().max() + ulp * y0.abs()).all()
    assert float((s - s0).abs().max()) <= rel * float(s0.abs().max())


def _extreme_decays(w, kind):
    """w of the model's draw, or: "strong" decays in [0.2, 0.5] (where the
    Pallas kernel clips); "zero_one" channels at w = 0 and w = 1 exactly;
    "tiny" w down to 1e-30."""
    g = torch.Generator().manual_seed(w.shape[1])
    if kind == "strong":
        return 0.2 + 0.3 * torch.rand(w.shape, generator=g)
    if kind == "zero_one":
        w = w.clone()
        w[..., :3] = 0.0
        w[..., 3:6] = 1.0
        return w
    if kind == "tiny":
        return 10.0 ** (-30.0 * torch.rand(w.shape, generator=g))
    return w


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,hs,T", [(2, 8, 16, 1), (2, 8, 16, 33),
                                      (2, 8, 16, 1000), (2, 2, 64, 1),
                                      (2, 2, 64, 33), (2, 2, 64, 1000),
                                      (4, 32, 64, 64), (4, 32, 64, 1000)])
@pytest.mark.parametrize("decay", ["model", "strong", "zero_one", "tiny"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_wkv6(B, H, hs, T, decay, dtype):
    """The serving head count (B 4, H 32, hs 64 at T 64 and 1000) among
    them; against the token scan and the kernel's own sub-chunked
    arithmetic written out in PyTorch."""
    dev = _cuda()
    r, k, v, w, u, s0 = _wkv6_inputs(B, T, H, hs, T + hs, dtype)
    args = [a.to(dev) for a in (r, k, v, _extreme_decays(w, decay), u, s0)]
    got = _launched("wkv6", lambda: rwkv6.wkv6(*args))
    _assert_wkv6(got, ref.wkv6_naive(*args))
    _assert_wkv6(got, ref.wkv6_subchunks(*args))
    again = rwkv6.wkv6(*args)             # no atomics: the same bits again
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.gpu
def test_gpu_wkv6_reads_strided_inputs():
    """[B, H, T, hs] storage read through a [B, T, H, hs] view, and w in
    another layout than r, k, v: no copy, the same numbers."""
    dev = _cuda()
    r, k, v, w, u, s0 = (a.to(dev) for a in _wkv6_inputs(2, 40, 4, 64, 5))
    view = lambda a: a.transpose(1, 2).contiguous().transpose(1, 2)
    rs, ks, vs = view(r), view(k), view(v)
    assert rs.stride() != r.stride()
    got = _launched("wkv6", lambda: rwkv6.wkv6(rs, ks, vs, w, u, s0))
    _assert_wkv6(got, ref.wkv6_naive(r, k, v, w, u, s0))


@pytest.mark.gpu
def test_gpu_kernels_take_contiguous_views_at_a_misaligned_base():
    """Contiguous operands one element off an aligned base (views of a flat
    buffer): ``wkv6`` and ``gram_q8`` copy them to a fresh allocation and
    give the plain versions' numbers, where the C checks would refuse."""
    dev = _cuda()

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    args = [a.to(dev) for a in _wkv6_inputs(2, 40, 4, 64, 6, torch.bfloat16)]
    views = [shifted(a) for a in args[:4]] + args[4:]
    assert all(a.is_contiguous() and a.data_ptr() % 8 for a in views[:4])
    got = _launched("wkv6", lambda: rwkv6.wkv6(*views))
    _assert_wkv6(got, ref.wkv6_naive(*args))
    q, s, _ = _q8_inputs(3, 8192, 8)
    q, s = q.to(dev), s.to(dev)
    qv = shifted(q)
    assert qv.is_contiguous() and qv.data_ptr() % 16
    got = _launched("gram_q8", lambda: q8agg.gram_q8(qv, s))
    _assert_gram(got, ref.gram_q8(q, s), ref.dequantize_rows(q, s))


@pytest.mark.gpu
def test_gpu_wkv6_refuses_other_head_sizes():
    dev = _cuda()
    z = torch.zeros((1, 4, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head size 48"):
        rwkv6.wkv6(z, z, z, z, torch.zeros((2, 48), device=dev),
                   torch.zeros((1, 2, 48, 48), device=dev))
    z = torch.zeros((1, 4, 2, 64), device=dev)
    with pytest.raises(ValueError, match="share a device"):
        rwkv6.wkv6(z, z, z, z, torch.zeros((2, 64), device=dev),
                   torch.zeros((1, 2, 64, 64)))             # state on the CPU


def test_trace_kernels_reads_a_ptxas_report():
    """``trace_kernels.parse_ptxas`` keeps the two int8 kernels' entries of
    an ``nvcc -Xptxas -v`` report: registers, shared memory, spills."""
    from repro_torch.kernels import trace_kernels
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115quantize_kernelILi16EEEvPKflPaPfl' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers, 388 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114wsum_q8_kernelILi3ELb0ELi4EEEvPKalPKflS4_iPfl' "
        "for 'sm_90a'",
        "ptxas info    : Used 72 registers, 16 bytes smem, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z5otheri' for 'sm_90a'",
        "ptxas info    : Used 12 registers, 388 bytes cmem[0]"])
    got = trace_kernels.parse_ptxas(log)
    assert got == {
        "_ZN12_GLOBAL__N_115quantize_kernelILi16EEEvPKflPaPfl": {
            "stack": 0, "spill_stores": 8, "spill_loads": 4, "regs": 40,
            "shared": 0},
        "_ZN12_GLOBAL__N_114wsum_q8_kernelILi3ELb0ELi4EEEvPKalPKflS4_iPfl": {
            "regs": 72, "shared": 16}}
