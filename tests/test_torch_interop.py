"""Parameters cross between numpy and the port bit for bit, each leaf in
its own dtype: bf16 (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses) through its 16 bits, the others as they are."""
import jax
import ml_dtypes
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.models import build_model
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.tree import leaves_with_paths

BF16 = np.dtype(ml_dtypes.bfloat16)


def _mixed_tree():
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 3.0e38,
                        -1.5], np.float32)
    return {
        "w": np.concatenate([special, rng.standard_normal(56)
                             .astype(np.float32)]).reshape(8, 8).astype(BF16),
        "b": {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
              "f16": rng.standard_normal((2, 2)).astype(np.float16)},
        "col": rng.standard_normal((6, 4)).astype(np.float32).astype(BF16).T,
        "scalar": np.asarray(2.5, BF16),
    }


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint16) if a.dtype == BF16 else a.view(np.uint8)


def test_numpy_to_torch_to_numpy_is_bit_exact():
    tree = _mixed_tree()
    tp = params_from_numpy(tree, "cpu")
    want_dtypes = {("w",): torch.bfloat16, ("b", "f32"): torch.float32,
                   ("b", "i32"): torch.int32, ("b", "f16"): torch.float16,
                   ("col",): torch.bfloat16, ("scalar",): torch.bfloat16}
    assert {p: t.dtype for p, t in leaves_with_paths(tp)} == want_dtypes
    # bf16 widens to float32 exactly: torch's values are numpy's values
    for (p, t), (_, a) in zip(leaves_with_paths(tp), leaves_with_paths(tree)):
        assert t.shape == a.shape, p
        if t.dtype == torch.bfloat16:
            t, a = t.to(torch.float32), a.astype(np.float32)
        np.testing.assert_array_equal(t.numpy(), a, err_msg=str(p))
    back = params_to_numpy(tp)
    for (p, b), (_, a) in zip(leaves_with_paths(back),
                              leaves_with_paths(tree)):
        assert b.dtype == a.dtype and b.shape == a.shape, p
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=str(p))


def test_torch_to_numpy_to_torch_is_bit_exact():
    g = torch.Generator().manual_seed(1)
    tp = {"a": torch.randn((5, 7), generator=g).to(torch.bfloat16),
          "b": {"c": torch.randn((3,), generator=g),
                "d": torch.randn((4, 2), generator=g).to(torch.bfloat16).T}}
    tp["a"][0, :3] = torch.tensor([float("nan"), float("inf"), -0.0])
    again = params_from_numpy(params_to_numpy(tp), "cpu")
    for (p, a), (_, b) in zip(leaves_with_paths(tp), leaves_with_paths(again)):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a.view(torch.int32),
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b.view(torch.int32)), p


def test_reference_rwkv6_init_round_trips():
    """The bf16 model with its f32 leaves (decay_base, bonus_u)."""
    ref = jax.tree.map(np.asarray, build_model(
        get_smoke_config("rwkv6-1.6b")).init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(ref, "cpu")
    assert tp["layers"]["wr"].dtype == torch.bfloat16
    assert tp["layers"]["decay_base"].dtype == torch.float32
    for (p, b), (_, a) in zip(leaves_with_paths(params_to_numpy(tp)),
                              leaves_with_paths(ref)):
        assert b.dtype == a.dtype, p
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=str(p))
