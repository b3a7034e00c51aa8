"""Store codec + wire envelopes: byte-identical to the JAX reference.

Equal params or envelopes serialize to equal bytes in both packages (the
header's PyTreeDef and keystr strings are written without JAX), so CIDs
match, and each package decodes the other's payloads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import store as jstore
from repro.core import wire as jwire
from repro.models import build_model as jbuild
from repro_torch.core import store as tstore
from repro_torch.core import wire as twire
from repro_torch.interop import params_from_numpy

N = 62_006


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, jbuild(get_config("paper-cnn")).init(
        jax.random.PRNGKey(3)))


def _vec(seed, n=N):
    return (np.random.default_rng(seed).standard_normal(n) * 0.05
            ).astype(np.float32)


def test_treedef_and_keystr_strings_match_jax():
    tree = {"b": {"w": np.zeros(2), "b": np.zeros(1)}, "a": np.zeros(3),
            "__wire__": np.asarray(1), "e": {"x": {}}}
    assert tstore.treedef_str(tree) == str(jax.tree_util.tree_structure(tree))
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(tree)[0]]
    tpaths = [tstore.keystr(p) for p, _ in
              tstore.tree.leaves_with_paths(tree)]
    assert tpaths == jpaths


def test_params_and_checkpoint_bytes_identical(ref_params):
    tp = params_from_numpy(ref_params, "cpu")
    jb = jstore.serialize_pytree(jax.tree.map(jnp.asarray, ref_params))
    tb = tstore.serialize_pytree(tp)
    assert tb == jb
    assert tstore.compute_cid(tb) == jstore.compute_cid(jb)
    state_j = {"params": ref_params, "round": np.asarray(2)}
    state_t = {"params": tp, "round": np.asarray(2)}
    assert tstore.serialize_pytree(state_t) == jstore.serialize_pytree(state_j)
    # deserialize with a prototype rebuilds the nested dict
    back = tstore.deserialize_pytree(tb, like=tp)
    np.testing.assert_array_equal(back["fc1"]["w"], ref_params["fc1"]["w"])


@pytest.mark.parametrize("method,base", [("raw", False), ("int8", False),
                                         ("topk-delta", False),
                                         ("topk-delta", True),
                                         ("int8-delta", True)])
def test_envelope_bytes_identical_and_cross_decode(method, base):
    v, b = _vec(1), (_vec(2) if base else None)
    kw = dict(base_cid="bafyparent" if base else "", topk_frac=0.01)
    je = jwire.encode_vec(jnp.asarray(v), method,
                          base_vec=None if b is None else jnp.asarray(b), **kw)
    te = twire.encode_vec(torch.from_numpy(v), method,
                          base_vec=None if b is None else torch.from_numpy(b),
                          **kw)
    jb = jstore.serialize_pytree(je.to_store())
    tb = tstore.serialize_pytree(te.to_store())
    assert tb == jb
    assert tstore.compute_cid(tb) == jstore.compute_cid(jb)
    assert te.nbytes() == je.nbytes()
    # each package decodes the other's payload to the same vector
    resolver_t = (lambda cid: twire.DecodedModel(N, vec=torch.from_numpy(b))) \
        if base else None
    resolver_j = (lambda cid: jwire.DecodedModel(N, vec=jnp.asarray(b))) \
        if base else None
    from_j = twire.decode_store(tstore.deserialize_pytree(jb), "cpu",
                                resolver=resolver_t)
    from_t = jwire.decode_store(jstore.deserialize_pytree(tb),
                                resolver=resolver_j)
    assert from_j.is_q8 == from_t.is_q8 == (method == "int8")
    assert from_j.needs_base == from_t.needs_base == base
    np.testing.assert_array_equal(from_j.vec().numpy(),
                                  np.asarray(from_t.vec()))


def test_params_roundtrip_and_non_envelopes_are_refused(ref_params):
    tp = params_from_numpy(ref_params, "cpu")
    data = tstore.serialize_pytree(tp)
    back = tstore.deserialize_pytree(data, like=tp)
    assert tstore.serialize_pytree(back) == data
    with pytest.raises(ValueError, match="not a wire envelope"):
        twire.decode_store(tstore.deserialize_pytree(data), "cpu")


def test_int8_delta_waits_for_its_slice():
    """Its slice has come: a reference int8-delta payload decodes in the
    port, and without a base to resolve it refuses rather than guessing."""
    je = jwire.encode_vec(jnp.asarray(_vec(5)), "int8-delta",
                          base_vec=jnp.asarray(_vec(6)), base_cid="bafyx")
    flat = jstore.deserialize_pytree(jstore.serialize_pytree(je.to_store()))
    dm = twire.decode_store(flat, "cpu")
    assert dm.method == "int8-delta" and dm.base_cid == "bafyx"
    assert dm.tiles.dtype == torch.int32 and dm.q.dtype == torch.int8
    with pytest.raises(KeyError, match="resolver"):
        dm.vec()


def test_store_nodes_fetch_from_peers_and_cache_decodes():
    net = tstore.StoreNetwork()
    a, b = net.add_node("a", "cpu"), net.add_node("b", "cpu")
    env = twire.encode_vec(torch.from_numpy(_vec(7)), "int8")
    cid = a.put(env.to_store())
    d1 = b.get_decoded(cid, b.wire_decoder())
    d2 = b.get_decoded(cid, b.wire_decoder())
    assert d1 is d2 and d1.is_q8 and d1.q.device.type == "cpu"
    assert b.stats["peer_fetches"] == 1 and b.stats["decodes"] == 1
    assert b.stats["decode_hits"] == 1
    with pytest.raises(KeyError):
        b.get_bytes("bafy-missing")
