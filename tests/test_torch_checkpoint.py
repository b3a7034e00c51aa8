"""``repro_torch.checkpoint`` over the port's store: the four cases of
``tests/test_checkpoint.py`` (round trip, manifest lineage, restart from a
peer's store, the mismatch error's text), the same manifest and state
CIDs as ``repro.checkpoint`` for equal states (bf16 leaves too), and a
bf16 LM silo's round checkpoint restored."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import save_state as jsave
from repro.core.store import StoreNode as JStore
from repro_torch.checkpoint import (Checkpointer, load_manifest,
                                    restore_state, save_state)
from repro_torch.config import FedConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.builder import build_lm_experiment
from repro_torch.core.store import StoreNetwork, StoreNode


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros((4,))},
            "step": torch.tensor(3, dtype=torch.int32)}


def _store(name="ckpt"):
    return StoreNode(name, "cpu")


def test_save_restore_roundtrip():
    store = _store()
    cid = save_state(store, _state(2.5), step=3)
    restored, manifest = restore_state(store, cid, like=_state())
    assert manifest["step"] == 3
    np.testing.assert_allclose(restored["params"]["w"].numpy(),
                               np.full((4, 4), 2.5))
    assert restored["step"].dtype == torch.int32


def test_manifest_chain_lineage():
    store = _store()
    ck = Checkpointer(store, every=2)
    for step in range(6):
        ck.maybe_save(_state(float(step)), step)
    lineage = ck.lineage()
    assert [s for s, _ in lineage] == [4, 2, 0]
    restored, m = ck.restore_latest(like=_state())
    assert m["step"] == 4
    np.testing.assert_allclose(restored["params"]["w"].numpy().mean(), 4.0)
    assert [s for s, _ in ck.history] == [0, 2, 4]
    with pytest.raises(RuntimeError, match="no checkpoint saved"):
        Checkpointer(store).restore_latest(like=_state())


def test_restart_after_crash_from_peer_store():
    """Silo A checkpoints; A crashes; a replacement node restores via its
    peer."""
    net = StoreNetwork()
    a = net.add_node("a", "cpu")
    b = net.add_node("b", "cpu")
    cid = save_state(a, _state(7.0), step=10)
    restored, m = restore_state(b, cid, like=_state())  # b pulls from a
    assert m["step"] == 10
    np.testing.assert_allclose(restored["params"]["w"].numpy().mean(), 7.0)


def test_restore_shape_mismatch_names_leaf_and_shapes():
    """The reference's error text: the leaf's flat index and store key and
    both shapes; and a leaf-count mismatch."""
    store = _store()
    bad = {"params": {"w": torch.full((3, 5), 1.0), "b": torch.zeros((4,))},
           "step": torch.tensor(3, dtype=torch.int32)}
    cid = save_state(store, bad, step=1)
    with pytest.raises(ValueError) as ei:
        restore_state(store, cid, like=_state())
    msg = str(ei.value)
    assert msg == ("checkpoint shape mismatch at leaf 1 "
                   "(\"['params']['w']\"): stored (3, 5) cannot reshape to "
                   "prototype (4, 4)")
    with pytest.raises(ValueError, match="checkpoint/prototype mismatch: "
                                         "3 vs 2 leaves"):
        restore_state(store, cid, like={"params": _state()["params"]})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cids_match_reference(dtype):
    """Equal states give equal state and manifest CIDs in both packages
    (a bf16 leaf goes over as its 16 bits, named ``bfloat16``), and each
    package restores the other's bytes."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jstate = {"params": {"w": jw}, "round": np.asarray(2)}
    tstate = {"params": {"w": tw}, "round": np.asarray(2)}
    jstore, tstore = JStore("j"), _store("t")
    jcid = jsave(jstore, jstate, step=5, tag="silo", parent="bafyparent")
    tcid = save_state(tstore, tstate, step=5, tag="silo", parent="bafyparent")
    assert tcid == jcid
    assert load_manifest(tstore, tcid) == {
        "tag": "silo", "step": 5, "parent": "bafyparent",
        "state_cid": load_manifest(tstore, tcid)["state_cid"]}
    tstore.ingest(jcid, jstore.get_bytes(jcid))
    sc = load_manifest(tstore, jcid)["state_cid"]
    tstore.ingest(sc, jstore.get_bytes(sc))
    restored, _ = restore_state(tstore, jcid, like=tstate)
    assert restored["params"]["w"].dtype == tw.dtype
    assert torch.equal(restored["params"]["w"], tw)
    got = np.asarray(jax.tree.map(np.asarray, jstate)["params"]["w"])
    if dtype == "bfloat16":
        assert got.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        restored["params"]["w"].to(torch.float32).numpy(),
        got.astype(np.float32))


def test_bf16_lm_silo_checkpoint_restores():
    """A bf16 LM silo's round checkpoint (the store put at each round's
    end) restores its params bit for bit; after a round of SGD the params
    are float32, as the reference's client step leaves them, and restore
    as such."""
    fed = FedConfig(n_silos=3, clients_per_silo=1, rounds=1,
                    scorer="loss", compression="int8")
    orch = build_lm_experiment(get_smoke_config("qwen3-1.7b"), fed,
                               seq_len=16, batch_size=2, steps_per_epoch=1,
                               stream_len=2000, device="cpu")
    silo = orch.silos[0]
    for dtype in (torch.bfloat16, torch.float32):
        emb = silo.cluster.params["embed"]
        before = {k: v.clone() for k, v in emb.items()}
        assert before["embedding"].dtype == dtype
        cp = silo.checkpoint()
        emb["embedding"].zero_()
        silo.restore_from(cp)
        for k, v in before.items():
            assert torch.equal(silo.cluster.params["embed"][k], v)
        orch.run(1)
