"""The yardstick's counts against hand counts: model FLOPs a token of each
family at the small widths and at the published ones, and the bytes and
operations behind each kernel's roofline."""
import pytest

from bench import harness, smoke, traffic

H100 = {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12}


def test_dense_forward_flops_by_hand():
    _, cfg, _ = smoke.cell("pod_topk_int8.qwen3-1.7b")
    fam = harness.family("dense")
    # multiply-adds a token: q 64x64, k and v 64x32, o 64x64, the MLP's
    # three 64x128, for each of 2 layers; attention's two products over
    # (32 + 1) / 2 keys of 4 heads x 16; the logits 64 x 256
    macs = 2 * (4096 + 2048 + 2048 + 4096 + 3 * 8192) + 2 * 2 * 16.5 * 64 \
        + 64 * 256
    assert fam.forward_flops(cfg, 32) == 2 * macs


def _matrix_macs(fam, cfg, skip):
    """Multiply-adds of the weight products a token, from the leaves."""
    L = cfg["n_layers"]
    total = 0
    for path, shape, _, _ in fam.param_specs(cfg):
        name = path.split("/")[-1]
        if path.startswith("layers/") and len(shape) >= 3 and \
                name not in skip:
            n = 1
            for s in shape[1:]:
                n *= s
            total += L * n
    return total + cfg["d_model"] * cfg["vocab_size"]


@pytest.mark.parametrize("workload,skip", [
    ("pod_topk_int8.qwen3-1.7b", ()),
    ("pod_mean.rwkv6-1.6b", ("mix_mu", "cmix_mu", "bonus_u"))])
def test_weight_products_are_the_matrix_leaves(workload, skip):
    _, cfg, mix = harness.cell(workload)
    fam = harness.family(cfg["family"])
    T = mix["seq_len"]
    attn = fam.forward_flops(cfg, T) - 2 * _matrix_macs(fam, cfg, skip)
    if cfg["family"] == "dense":     # causal attention at T = 4,096
        want = 2 * cfg["n_layers"] * 2 * cfg["n_heads"] * cfg["head_dim"] \
            * (T + 1) / 2
    else:                            # the recurrence, 5 hs^2 + 5 hs a head
        hs = cfg["rwkv_head_size"]
        want = cfg["n_layers"] * (cfg["d_model"] // hs) * (5 * hs * hs
                                                          + 5 * hs)
    assert attn == pytest.approx(want, rel=1e-12)


def test_published_qwen3_flops_a_step():
    """3.91 GFLOP a token forward (2 x 1.72 B products with the logits,
    0.47 G of attention at 4,096), 3 a trained token and 1 a scored one:
    16,384 trained and 32,768 scored tokens a step."""
    _, cfg, mix = harness.cell("pod_topk_int8.qwen3-1.7b")
    fam = harness.family("dense")
    f = fam.forward_flops(cfg, 4096)
    assert f == pytest.approx(3.91e9, rel=0.01)
    assert traffic.tokens_a_step(mix) == 16384
    assert traffic.scored_a_step(mix) == 32768
    assert harness.flops_a_step(cfg, mix, fam) == f * (3 * 16384 + 32768)


def test_mean_mix_scores_nothing():
    _, cfg, mix = harness.cell("pod_mean.rwkv6-1.6b")
    assert traffic.scored_a_step(mix) == 0


def test_weighted_sum_bound():
    r = harness.reader("weighted_sum_roofline")
    # 2 bf16 rows of 1,000 read, one row written, 2 float32 weights
    assert r.bound_s((2, 1000), "bfloat16", H100) == \
        (2 * 1000 * 2 + 1000 * 2 + 8) / 3.35e12


def test_wkv6_bounds():
    fwd = harness.reader("wkv6_roofline")
    bwd = harness.reader("wkv6_backward_roofline")
    B, T, H, hs = 2, 4096, 32, 64
    n = B * T * H * hs
    # forward: (5 hs + 5) float32 operations an element bound it
    assert fwd.bound_s(((B, T, H, hs), "bfloat16"), H100) == \
        325 * n / 67e12
    nbytes = n * 12 + H * hs * 4 + 2 * B * H * hs * hs * 4
    assert nbytes / 3.35e12 < 325 * n / 67e12
    # backward: 10 hs^2 a token and head
    args = [((B, T, H, hs), "bfloat16")] + [None] * 8
    assert bwd.bound_s(args, H100) == 10 * hs * hs * B * T * H / 67e12
