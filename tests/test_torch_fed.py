"""Client training, silo aggregation and batched scoring vs the JAX
reference, from equal params, data and numpy seeds.

Tolerances: one local epoch 1e-4 (a few dozen float32 SGD steps whose
convolution sums run in another order); FedAvg and the int8 cross-silo merge
1e-6 relative (one weighted sum); scores 1e-5, the bar of
tests/test_scorebatch.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import wire as jwire
from repro.core.store import deserialize_pytree as jdeser
from repro.core.store import serialize_pytree as jser
from repro.fed import scorebatch as jsb
from repro.fed.aggregator import SiloAggregator as JAgg
from repro.fed.aggregator import fedavg_params as jfedavg
from repro.fed.client import Client as JClient
from repro.fed.cluster import Cluster as JCluster
from repro.kernels import ops as jops
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.core import wire as twire
from repro_torch.core.store import deserialize_pytree as tdeser
from repro_torch.fed import scorebatch as tsb
from repro_torch.fed.aggregator import SiloAggregator as TAgg
from repro_torch.fed.aggregator import fedavg_params as tfedavg
from repro_torch.fed.client import Client as TClient
from repro_torch.fed.cluster import Cluster as TCluster
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as tbuild
from repro_torch.tree import leaves_with_paths


@pytest.fixture(scope="module")
def models():
    return jbuild(get_config("paper-cnn")), tbuild(tget("paper-cnn"))


@pytest.fixture(scope="module")
def ref_params(models):
    return jax.tree.map(np.asarray, models[0].init(jax.random.PRNGKey(0)))


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            "y": rng.integers(0, 10, n).astype(np.int32)}


def _flat(params):
    return np.concatenate([np.ravel(a) for _, a in leaves_with_paths(params)])


def _perturbed(ref_params, k, scale=0.05):
    rng = np.random.default_rng(100 + k)
    return jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * scale)
                        .astype(np.float32), ref_params)


@pytest.mark.parametrize("byzantine", [None, "noise"])
def test_local_train_one_epoch_matches(models, ref_params, byzantine):
    jm, tm = models
    data = _data(96, 1)
    jc = JClient("c", jm, data, batch_size=32, seed=5, byzantine=byzantine)
    tc = TClient("c", tm, data, device="cpu", batch_size=32, seed=5,
                 byzantine=byzantine)
    jp, jn, jl = jc.local_train(jax.tree.map(jnp.asarray, ref_params), 1)
    tp, tn, tl = tc.local_train(params_from_numpy(ref_params, "cpu"), 1)
    assert jn == tn == 96
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(_flat(params_to_numpy(tp)),
                               _flat(jax.tree.map(np.asarray, jp)),
                               rtol=1e-4, atol=1e-4)


def test_fedavg_params_matches(ref_params):
    peers = [_perturbed(ref_params, k) for k in range(3)]
    counts = [120, 45, 301]
    want = jfedavg([jax.tree.map(jnp.asarray, p) for p in peers], counts)
    got = tfedavg([params_from_numpy(p, "cpu") for p in peers], counts)
    a, b = _flat(params_to_numpy(got)), _flat(jax.tree.map(np.asarray, want))
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("method", ["int8", "raw"])
def test_apply_cross_silo_vec_matches(ref_params, method):
    own = _flat(ref_params).astype(np.float32)
    peers = [_flat(_perturbed(ref_params, k)).astype(np.float32)
             for k in range(2)]
    payloads = [jser(jwire.encode_vec(jnp.asarray(v), method).to_store())
                for v in peers]
    jpeers = [jwire.decode_flat(jdeser(b)) for b in payloads]
    tpeers = [twire.decode_store(tdeser(b), "cpu") for b in payloads]
    assert all(p.is_q8 == (method == "int8") for p in tpeers)
    weights = [1.0, 1.0, 2.0]
    want = JAgg("s").apply_cross_silo_vec(jnp.asarray(own), jpeers, weights)
    got = TAgg("s").apply_cross_silo_vec(torch.from_numpy(own), tpeers,
                                         weights)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_score_round_batch_matches(models, ref_params):
    """Mixed int8 / raw round, 300 test images (one full batch of 256 and a
    remainder of 44 weighted by its true count), one host transfer."""
    jm, tm = models
    td = _data(300, 2)
    jcl = JCluster("scorer", jm, [], test_data=td)
    tcl = TCluster("scorer", tm, [], test_data=td, device="cpu")
    vecs = [_flat(_perturbed(ref_params, k, 0.02)).astype(np.float32)
            for k in range(3)]
    payloads = [jser(jwire.encode_vec(jnp.asarray(v), m).to_store())
                for v, m in zip(vecs, ["int8", "raw", "int8"])]
    _, jspec = jops.flatten_pytree(jax.tree.map(jnp.asarray, ref_params))
    _, tspec = tops.flatten_pytree(params_from_numpy(ref_params, "cpu"))
    jdec = [jwire.decode_flat(jdeser(b)) for b in payloads]
    tdec = [twire.decode_store(tdeser(b), "cpu") for b in payloads]
    for method in ("accuracy", "loss"):
        want = jsb.score_round_batch(jcl, jdec, jspec, method=method)
        got = tsb.score_round_batch(tcl, tdec, tspec, method=method)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tsb.get_scorer(tcl).host_syncs == 2
    # K=1 self-eval through the same engine
    je = jcl.evaluate(jax.tree.map(jnp.asarray, ref_params))
    te = tcl.evaluate(params_from_numpy(ref_params, "cpu"))
    np.testing.assert_allclose([te["loss"], te["accuracy"]],
                               [je["loss"], je["accuracy"]], rtol=1e-5)
    assert tsb.get_scorer(tcl).host_syncs == 3
