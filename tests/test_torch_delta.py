"""The ``int8-delta`` wire method and its fused rebuild, against the JAX
reference on the same numpy inputs.

``add_q8_delta`` is bit-exact with the reference's default path (its Pallas
kernel in interpret mode), which rounds ``base + q*s`` once. Envelopes are
byte-identical, so CIDs match, and each package decodes the other's
payloads to the same bits. The keyframe cadence of a delta run
(``keyframe_every``) gives the reference's sequence of whole and delta
envelopes per silo.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JFed
from repro.configs import get_config as jget
from repro.core import compression as jcomp
from repro.core import store as jstore
from repro.core import wire as jwire
from repro.core.builder import build_image_experiment as jbuild_exp
from repro.kernels import ops as jops
from repro_torch.config import FedConfig as TFed
from repro_torch.configs import get_config as tget
from repro_torch.core import compression as tcomp
from repro_torch.core import store as tstore
from repro_torch.core import wire as twire
from repro_torch.core.builder import build_image_experiment as tbuild_exp
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops as tops

N = 62_006


def _vec(seed, n=N, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def _step(base, seed, frac=0.3, scale=1e-3):
    """base plus a small update on a random subset of whole 1024-tiles,
    so some tiles are elided and some are kept."""
    rng = np.random.default_rng(seed)
    v = base.copy()
    tiles = np.flatnonzero(rng.random(-(-len(v) // 1024)) < frac)
    for t in tiles:
        sl = slice(t * 1024, min((t + 1) * 1024, len(v)))
        v[sl] += (rng.standard_normal(sl.stop - sl.start) * scale
                  ).astype(np.float32)
    return v


@pytest.mark.parametrize("n,np_", [(62_006, 131_072), (131_072, 131_072),
                                   (5_000, 6_144)])
@pytest.mark.parametrize("seed", [0, 1])
def test_add_q8_delta_bit_exact_with_the_kernel_path(n, np_, seed):
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal(n) * 0.05).astype(np.float32)
    q = rng.integers(-127, 128, np_).astype(np.int8)
    s = rng.uniform(1e-5, 1e-3, np_ // 1024).astype(np.float32)
    want = np.asarray(jops.add_q8_delta(jnp.asarray(base), jnp.asarray(q),
                                        jnp.asarray(s)))
    got = tops.add_q8_delta(torch.from_numpy(base), torch.from_numpy(q),
                            torch.from_numpy(s))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _base_laid_out(base, layout):
    """numpy [n] -> the torch base ``wire.reconstruct`` may hand over: a
    fresh tensor, a view at a 1-float offset, or row 1 of a row-strided
    [3, n] view (a dequantized stack)."""
    n = base.shape[0]
    if layout == "offset":
        buf = torch.zeros(n + 1)
        buf[1:] = torch.from_numpy(base)
        return buf[1:]
    if layout == "row":
        buf = torch.zeros((3, n + 3))
        buf[1, :n] = torch.from_numpy(base)
        return buf[:, :n][1]
    return torch.from_numpy(base)


@pytest.mark.parametrize("n", [5_000, 62_006, 131_072])
@pytest.mark.parametrize("layout", ["fresh", "offset", "row"])
def test_add_q8_delta_unpadded_bit_exact(n, layout):
    """The port hands its kernel the unpadded base (any view) and the
    131,072-padded payload; the reference pads the base for its Pallas
    grid. The same bits."""
    rng = np.random.default_rng(n)
    base = (rng.standard_normal(n) * 0.05).astype(np.float32)
    q = rng.integers(-127, 128, 131_072).astype(np.int8)
    s = rng.uniform(1e-5, 1e-3, 128).astype(np.float32)
    want = np.asarray(jops.add_q8_delta(jnp.asarray(base), jnp.asarray(q),
                                        jnp.asarray(s), n))
    tb = _base_laid_out(base, layout)
    got = tops.add_q8_delta(tb, torch.from_numpy(q), torch.from_numpy(s), n)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_add_q8_delta_refuses_unaligned_payloads():
    with pytest.raises(ValueError, match="1024-aligned"):
        tops.add_q8_delta(torch.zeros(10), torch.zeros(1000, dtype=torch.int8),
                          torch.ones(1))


def _pair(v, b, **kw):
    je = jwire.encode_vec(jnp.asarray(v), "int8-delta",
                          base_vec=None if b is None else jnp.asarray(b), **kw)
    te = twire.encode_vec(torch.from_numpy(v), "int8-delta",
                          base_vec=None if b is None else torch.from_numpy(b),
                          **kw)
    return je, te


@pytest.mark.parametrize("delta_rtol", [1.0, 0.0])
def test_int8_delta_envelopes_bytes_cids_and_cross_decode(delta_rtol):
    b = _vec(2)
    v = _step(b, 3)
    je, te = _pair(v, b, base_cid="bafyparent", delta_rtol=delta_rtol)
    assert te.method == je.method == "int8-delta" and je.is_delta
    jb = jstore.serialize_pytree(je.to_store())
    tb = tstore.serialize_pytree(te.to_store())
    assert tb == jb
    assert tstore.compute_cid(tb) == jstore.compute_cid(jb)
    assert te.nbytes() == je.nbytes()
    T = len(te.tiles)
    assert 0 < T < -(-N // 1024)           # some tiles elided, some kept
    resolver_t = lambda cid: twire.DecodedModel(N, vec=torch.from_numpy(b))
    resolver_j = lambda cid: jwire.DecodedModel(N, vec=jnp.asarray(b))
    from_j = twire.decode_store(tstore.deserialize_pytree(jb), "cpu",
                                resolver=resolver_t)
    from_t = jwire.decode_store(jstore.deserialize_pytree(tb),
                                resolver=resolver_j)
    assert from_j.needs_base and not from_j.is_q8
    assert from_j.base_cid == "bafyparent"
    want = np.asarray(from_t.vec())
    np.testing.assert_array_equal(from_j.vec().numpy(), want)
    # the rebuilt model is the encoded one to within one quantization step
    # of the delta, or of the base where a tile was elided
    step = max(np.abs(v - b).max(), delta_rtol * np.abs(b).max()) / 127
    assert np.abs(want - v).max() <= step + 1e-6


def test_int8_delta_without_a_base_is_whole_int8_and_unchanged_is_empty():
    v = _vec(4)
    je, te = _pair(v, None, base_cid="bafyignored")
    assert te.method == je.method == "int8"
    assert tstore.serialize_pytree(te.to_store()) == \
        jstore.serialize_pytree(je.to_store())
    je, te = _pair(v, v.copy(), base_cid="bafyself")
    assert len(te.tiles) == len(je.tiles) == 0
    assert tstore.serialize_pytree(te.to_store()) == \
        jstore.serialize_pytree(je.to_store())
    dm = twire.decode_store(
        tstore.deserialize_pytree(tstore.serialize_pytree(te.to_store())),
        "cpu", resolver=lambda cid: twire.DecodedModel(N, vec=torch.from_numpy(v)))
    np.testing.assert_array_equal(dm.vec().numpy(), v)   # T == 0: the base


def test_chain_depth_and_base_cid_follow_the_store():
    node = tstore.StoreNetwork().add_node("a", "cpu")
    v0 = _vec(5)
    cid = node.put(twire.encode_vec(torch.from_numpy(v0), "int8").to_store())
    cids, vs = [cid], [v0]
    for k in range(3):
        v = _step(vs[-1], 10 + k)
        base = node.get_decoded(cids[-1], node.wire_decoder()).vec()
        payload = twire.encode_vec(torch.from_numpy(v), "int8-delta",
                                   base_vec=base, base_cid=cids[-1]).to_store()
        assert twire.base_cid_of_store(payload) == cids[-1]
        cids.append(node.put(payload))
        vs.append(v)
    assert [twire.chain_depth_of(node, c) for c in cids] == [0, 1, 2, 3]
    assert twire.chain_depth_of(node, cids[-1], max_links=2) == 2
    assert twire.chain_depth_of(node, "bafy-elsewhere") == 0
    flat = tstore.deserialize_pytree(node.read_local(cids[2]))
    assert twire.base_cid_of_store(flat) == cids[1]
    # the chain rebuilds through the node's decoded cache
    last = node.get_decoded(cids[-1], node.wire_decoder()).vec().numpy()
    assert np.abs(last - vs[-1]).max() < 1e-3


@pytest.fixture(scope="module")
def ref_params():
    from repro.models import build_model
    return jax.tree.map(np.asarray, build_model(jget("paper-cnn")).init(
        jax.random.PRNGKey(1)))


@pytest.mark.parametrize("method,with_base", [("int8", False), ("int8", True),
                                              ("topk", True), ("none", False)])
def test_compress_decompress_pytree_matches(ref_params, method, with_base):
    rng = np.random.default_rng(7)
    newer = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape).astype(a.dtype) * 1e-3),
        ref_params)
    base = ref_params if with_base else None
    jp = jcomp.compress(jax.tree.map(jnp.asarray, newer), method,
                        base=None if base is None else
                        jax.tree.map(jnp.asarray, base))
    tp = tcomp.compress(params_from_numpy(newer, "cpu"), method,
                        base=None if base is None else
                        params_from_numpy(base, "cpu"))
    assert tstore.serialize_pytree(tp) == jstore.serialize_pytree(
        jax.tree.map(np.asarray, jp))
    assert tcomp.payload_bytes(tp) == jcomp.payload_bytes(jp)
    like_t = params_from_numpy(ref_params, "cpu")
    back_t = params_to_numpy(tcomp.decompress(tp, like_t))
    back_j = jcomp.decompress(jp, jax.tree.map(jnp.asarray, ref_params))
    for k in back_j:
        for leaf in back_j[k]:
            np.testing.assert_array_equal(back_t[k][leaf],
                                          np.asarray(back_j[k][leaf]))
    with pytest.raises(ValueError, match="not a wire envelope"):
        tcomp.decompress({"a": np.zeros(2)}, like_t)


# --------------------------------------------------------------------------- #
# Keyframe cadence: every keyframe_every-th announced envelope ships whole
# --------------------------------------------------------------------------- #

def _kinds(orch, deser):
    """Per silo, per round: does its submitted envelope name a base?"""
    out = {}
    for s in orch.silos:
        entries = sorted((e for e in orch.contract.models.values()
                          if e.owner == s.silo_id), key=lambda e: e.round)
        out[s.silo_id] = ["['base_cid']" in deser(s.store.read_local(e.cid))
                          for e in entries]
    return out


@pytest.mark.parametrize("compression", ["topk-delta", "int8-delta"])
def test_keyframe_cadence_matches_reference(compression):
    kw = dict(partition="niid", alpha=0.2, n_train=400, n_test=160, seed=0)
    fed = lambda cls: cls(n_silos=3, clients_per_silo=2, rounds=3,
                          mode="sync", scorer="accuracy", agg_policy="top_k",
                          policy_k=2, compression=compression,
                          keyframe_every=2)
    jo = jbuild_exp(jget("paper-cnn"), fed(JFed), **kw)
    init = jax.tree.map(np.asarray, jo.silos[0].cluster.params)
    to = tbuild_exp(tget("paper-cnn"), fed(TFed), device="cpu", **kw)
    for s in to.silos:
        s.cluster.params = params_from_numpy(init, "cpu")
    jo.run(3)
    to.run(3)
    want = _kinds(jo, jstore.deserialize_pytree)
    assert want == {f"silo{i}": [False, True, False] for i in range(3)}
    assert _kinds(to, tstore.deserialize_pytree) == want
    assert [s.pick_log for s in to.silos] == [s.pick_log for s in jo.silos]
    assert to.ledger.height == jo.ledger.height
