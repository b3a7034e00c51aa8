"""The token-stream client against ``repro.fed.client.Client``: the same
windows from the same numpy seed, and one local step at a time the same
losses and params, at smoke presets in float32 on the CPU.

Tolerances: LOSS_REL = 1e-5 relative on each step's loss; PARAM_REL = 1e-4
of each leaf's largest magnitude after the first step (one float32 SGD
step whose sums run in another order; measured 1.24e-5 at RWKV-6's
embedding, below 1.3e-7 elsewhere). Later steps compare losses only: RWKV-6's
training is ill-conditioned at this preset in the reference itself (see
``test_torch_lm_train_recurrent.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.data.synthetic import make_lm_dataset
from repro.fed.client import Client as JClient
from repro.models import build_model as jbuild
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.fed.client import Client as TClient
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model as tbuild
from repro_torch.tree import leaves_with_paths
from test_torch_lm_fed import F32, KEEP, one_torch_thread  # noqa: F401

LOSS_REL = 1e-5
PARAM_REL = 1e-4


def _pair(arch, over=F32):
    jm = jbuild(jreplace(jsmoke(arch), **over))
    tm = tbuild(treplace(tsmoke(arch), **over))
    ref = jm.init(jax.random.PRNGKey(0))
    KEEP.append(jm)
    return jm, tm, ref


def _data(vocab, steps=1, seq=32):
    stream = make_lm_dataset(vocab=vocab, length=6000, seed=0)[0]
    return {"tokens": stream, "seq_len": seq, "steps_per_epoch": steps}


def test_windows_match_reference():
    """Both clients draw the same window starts from the same seed, epoch
    after epoch; targets are the tokens one place on."""
    jm, tm, _ = _pair("qwen3-1.7b")
    data = _data(256, steps=3)
    jc = JClient("c", jm, data, batch_size=4, seed=7)
    tc = TClient("c", tm, data, device="cpu", batch_size=4, seed=7)
    jb, tb = list(jc._batches(2)), list(tc._batches(2))
    assert len(tb) == len(jb) == 6
    for j, t in zip(jb, tb):
        assert t["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
        np.testing.assert_array_equal(t["targets"].numpy(),
                                      np.asarray(j["targets"]))
        np.testing.assert_array_equal(t["tokens"][:, 1:].numpy(),
                                      t["targets"][:, :-1].numpy())
    assert tc.n_samples == jc.n_samples == 6000


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "recurrentgemma-9b", "rwkv6-1.6b"])
def test_local_train_matches_reference_step_by_step(arch):
    jm, tm, ref = _pair(arch)
    data = _data(jm.cfg.vocab_size)
    jc = JClient("c", jm, data, batch_size=4, lr=0.05, seed=3)
    tc = TClient("c", tm, data, device="cpu", batch_size=4, lr=0.05, seed=3)
    jp, tp = ref, params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    for step in range(3):
        jp, jn, jl = jc.local_train(jp, 1)
        tp, tn, tl = tc.local_train(tp, 1)
        assert tn == jn
        assert abs(tl - jl) <= LOSS_REL * abs(jl), (step, tl, jl)
        if step == 0:
            want = dict(leaves_with_paths(jax.tree.map(np.asarray, jp)))
            for path, t in leaves_with_paths(tp):
                w = want[path]
                err = np.abs(t.numpy() - w).max()
                assert err <= PARAM_REL * np.abs(w).max(), (path, err)


def test_bf16_params_turn_float32_as_in_the_reference():
    """The reference's SGD step ``p - lr * g`` takes ``lr`` as a float32
    array (``repro/fed/client.py:89``), so a bf16 leaf comes back float32
    after one step; so does the port's. The next step's loss agrees to
    the bf16 bound of the LM parity tests (twice the loss's bf16 rounding
    of about 2^-8 relative), the params to the bf16 rounding of one
    step's update (2^-8 of the leaf)."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jm, tm, ref = _pair("qwen3-1.7b", over)
    data = _data(256)
    jc = JClient("c", jm, data, batch_size=4, lr=0.05, seed=3)
    tc = TClient("c", tm, data, device="cpu", batch_size=4, lr=0.05, seed=3)
    jp, tp = ref, params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    assert jax.tree.leaves(ref)[0].dtype == jnp.bfloat16
    for _ in range(2):
        jp, _, jl = jc.local_train(jp, 1)
        tp, _, tl = tc.local_train(tp, 1)
        assert abs(tl - jl) <= 2 * 2.0 ** -8 * abs(jl)
    assert {str(a.dtype) for a in jax.tree.leaves(jp)} == {"float32"}
    assert {t.dtype for _, t in leaves_with_paths(tp)} == {torch.float32}
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jp)))
    for path, t in leaves_with_paths(tp):
        w = want[path]
        assert np.abs(t.numpy() - w).max() <= 2.0 ** -8 * np.abs(w).max(), \
            path


def test_encdec_cannot_train_from_a_token_stream_in_either_package():
    """The encoder-decoder's loss reads ``batch['frames']``
    (``repro/models/encdec.py:125``), and a token-stream client draws none:
    the reference fails with a KeyError, and the port fails the same way."""
    jm, tm, ref = _pair("seamless-m4t-medium")
    data = _data(jm.cfg.vocab_size)
    with pytest.raises(KeyError, match="frames"):
        JClient("c", jm, data, batch_size=4).local_train(ref, 1)
    tp = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    with pytest.raises(KeyError, match="frames"):
        TClient("c", tm, data, device="cpu", batch_size=4).local_train(tp, 1)
