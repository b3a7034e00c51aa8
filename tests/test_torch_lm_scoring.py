"""Token-stream scoring against ``repro.fed.scorebatch._lm_eval_fn``: a
round's K peer models, off the reference's own wire bytes (int8 and raw
mixed), scored on a silo's test stream in one pass with one host transfer;
the K=1 self-eval, ``Cluster.score_model``, the empty-stream fallback, and
``SiloAggregator.apply_cross_silo`` on LM params. Smoke presets in float32
on the CPU.

Tolerances: scores and losses 1e-5 relative (the bar of
``tests/test_scorebatch.py``; W = 4 windows summed in window order on both
sides); the merge 1e-6 of the largest magnitude (one weighted sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.core import wire as jwire
from repro.core.store import deserialize_pytree as jdeser
from repro.core.store import serialize_pytree as jser
from repro.data.synthetic import make_lm_dataset
from repro.fed import scorebatch as jsb
from repro.fed.aggregator import SiloAggregator as JAgg
from repro.fed.cluster import Cluster as JCluster
from repro.kernels import ops as jops
from repro.models import build_model as jbuild
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import wire as twire
from repro_torch.core.store import deserialize_pytree as tdeser
from repro_torch.fed import scorebatch as tsb
from repro_torch.fed.aggregator import SiloAggregator as TAgg
from repro_torch.fed.cluster import Cluster as TCluster
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as tbuild
from repro_torch.tree import leaves_with_paths
from test_torch_lm_fed import F32, KEEP, one_torch_thread  # noqa: F401

REL = 1e-5
SEQ = 32


def _flat(params):
    return np.concatenate([np.ravel(a) for _, a in leaves_with_paths(params)])


def _perturbed(ref, k, scale=0.02):
    rng = np.random.default_rng(100 + k)
    return jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * scale)
                        .astype(np.float32), ref)


def _clusters(arch, td):
    jm = jbuild(jreplace(jsmoke(arch), **F32))
    tm = tbuild(treplace(tsmoke(arch), **F32))
    jcl = JCluster("scorer", jm, [], test_data=td)
    tcl = TCluster("scorer", tm, [], test_data=td, device="cpu")
    KEEP.append(jcl)
    return jcl, tcl, jax.tree.map(np.asarray, jcl.params)


def _stream(vocab, length):
    return {"tokens": make_lm_dataset(vocab=vocab, length=length,
                                      seed=4)[0], "seq_len": SEQ}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_score_round_batch_matches_reference(arch):
    """A mixed int8 / raw round of K = 3 on a 600-token stream (4 windows
    of 32: the reference's cap), one host transfer a call."""
    jcl, tcl, ref = _clusters(arch, _stream(256, 600))
    vecs = [_flat(_perturbed(ref, k)).astype(np.float32) for k in range(3)]
    payloads = [jser(jwire.encode_vec(jnp.asarray(v), m).to_store())
                for v, m in zip(vecs, ["int8", "raw", "int8"])]
    _, jspec = jops.flatten_pytree(jax.tree.map(jnp.asarray, ref))
    _, tspec = tops.flatten_pytree(params_from_numpy(ref, "cpu"))
    jdec = [jwire.decode_flat(jdeser(b)) for b in payloads]
    tdec = [twire.decode_store(tdeser(b), "cpu") for b in payloads]
    for method in ("accuracy", "loss"):
        want = jsb.score_round_batch(jcl, jdec, jspec, method=method)
        got = tsb.score_round_batch(tcl, tdec, tspec, method=method)
        np.testing.assert_allclose(got, want, rtol=REL)
    assert tsb.get_scorer(tcl).host_syncs == 2
    p = tsb.get_scorer(tcl)._prep()
    assert p["kind"] == "lm" and tuple(p["args"][0].shape) == (4, SEQ)
    # K = 1 self-eval and score_model through the same engine
    je = jcl.evaluate(jax.tree.map(jnp.asarray, ref))
    te = tcl.evaluate(params_from_numpy(ref, "cpu"))
    np.testing.assert_allclose([te["loss"], te["accuracy"]],
                               [je["loss"], je["accuracy"]], rtol=REL)
    assert te["accuracy"] == pytest.approx(np.exp(-te["loss"]), rel=1e-6)
    for method in ("accuracy", "loss"):
        np.testing.assert_allclose(
            tcl.score_model(params_from_numpy(ref, "cpu"), method),
            jcl.score_model(jax.tree.map(jnp.asarray, ref), method),
            rtol=REL)
    with pytest.raises(ValueError):
        tcl.score_model(params_from_numpy(ref, "cpu"), "f1")
    assert tsb.get_scorer(tcl).host_syncs == 6   # "f1" evaluates, then raises


@pytest.mark.parametrize("length", [70, 2 * SEQ + 2])
def test_short_streams_match_reference(length):
    """One or two windows; a stream too short for one (the reference's
    fallback: loss 0, score 1, no transfer)."""
    jcl, tcl, ref = _clusters("qwen3-1.7b", _stream(256, length))
    want = jcl.evaluate(jax.tree.map(jnp.asarray, ref))
    got = tcl.evaluate(params_from_numpy(ref, "cpu"))
    np.testing.assert_allclose([got["loss"], got["accuracy"]],
                               [want["loss"], want["accuracy"]], rtol=REL)
    jcl, tcl, ref = _clusters("qwen3-1.7b", _stream(256, SEQ + 1))
    got = tcl.evaluate(params_from_numpy(ref, "cpu"))
    assert got == jcl.evaluate(jax.tree.map(jnp.asarray, ref)) \
        == {"loss": 0.0, "accuracy": 1.0}
    assert tsb.get_scorer(tcl).host_syncs == 0


def test_apply_cross_silo_matches_reference():
    """The params-facing merge of two peers (weights 1, 1, 2) on LM params,
    through the flat-vector merge."""
    jm = jbuild(jreplace(jsmoke("qwen3-1.7b"), **F32))
    KEEP.append(jm)
    ref = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    peers = [_perturbed(ref, k) for k in range(2)]
    weights = [1.0, 1.0, 2.0]
    want = JAgg("s").apply_cross_silo(
        jax.tree.map(jnp.asarray, ref),
        [jax.tree.map(jnp.asarray, p) for p in peers], weights)
    got = TAgg("s").apply_cross_silo(
        params_from_numpy(ref, "cpu"),
        [params_from_numpy(p, "cpu") for p in peers], weights)
    a, b = _flat(params_to_numpy(got)), _flat(jax.tree.map(np.asarray, want))
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    own = params_from_numpy(ref, "cpu")
    assert TAgg("s").apply_cross_silo(own, [], weights) is own
