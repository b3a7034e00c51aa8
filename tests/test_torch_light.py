"""Merkle tx commitments and header-only light clients in the port, against
``repro.chain`` (the counterpart of ``tests/test_light.py``).

The port's ``chain.light`` is a copy of the reference's with the imports
rewritten, so every quantity here is held equal, not within a tolerance:
roots, proofs, header hashes, accept/reject decisions, the hub's byte and
proof counters, the WAL audit. The three-tier run over a fabric is held to
the reference test's invariants (block-hash ties over a replicated chain
make its heights incomparable across packages).
"""
import json

import pytest

from repro import chain as jchain
from repro.chain import merkle as jmerkle
from repro.chain import replica as jreplica
from repro.core.contract import UnifyFLContract as JContract
from repro.core.simenv import SimEnv as JEnv
from repro_torch import chain as tchain
from repro_torch.chain import merkle as tmerkle
from repro_torch.chain import replica as treplica
from repro_torch.core.contract import UnifyFLContract as TContract
from repro_torch.core.simenv import SimEnv as TEnv

SIDES = {"ref": (jchain, jmerkle, jreplica, JContract, JEnv),
         "port": (tchain, tmerkle, treplica, TContract, TEnv)}


def _txs(Tx, n, sender="a", seed=0):
    return [Tx(sender, "m", {"i": i, "v": seed ^ i}, float(i),
               f"{sender}:{seed}:{i}") for i in range(n)]


def _both(fn):
    """``fn(chain, merkle, replica, Contract, SimEnv)`` in each package."""
    return {side: fn(*mods) for side, mods in SIDES.items()}


# --------------------------------------------------------------------------- #
# Merkle trees and proofs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 9, 24])
def test_roots_and_proofs_equal_the_reference_and_verify(n):
    """Every index of an n-wide block: the same leaves, root and proof as
    the reference, verifying against its root and not against the empty
    root (n = 0: the domain-separated empty root)."""
    def run(chain, merkle, replica, _c, _e):
        txs = _txs(chain.Tx, n)
        leaves = [merkle.tx_leaf(t.to_json()) for t in txs]
        root = merkle.tx_root([t.to_json() for t in txs])
        proofs = [merkle.merkle_proof(leaves, i) for i in range(n)]
        ok = [merkle.verify_proof(leaves[i], proofs[i], root)
              for i in range(n)]
        empty = [merkle.verify_proof(leaves[i], proofs[i],
                                     merkle.EMPTY_ROOT) for i in range(n)]
        return leaves, root, proofs, ok, empty
    got = _both(run)
    assert got["port"] == got["ref"]
    leaves, root, proofs, ok, empty = got["port"]
    assert all(ok) and not any(empty)
    if n == 0:
        assert root == tmerkle.EMPTY_ROOT
    if n == 1:
        assert root == leaves[0] and proofs == [[]]


def test_tampered_proofs_and_txs_fail_as_in_the_reference():
    def run(chain, merkle, replica, _c, _e):
        txs = _txs(chain.Tx, 5)
        leaves = [merkle.tx_leaf(t.to_json()) for t in txs]
        root = merkle.tx_root([t.to_json() for t in txs])
        proof = merkle.merkle_proof(leaves, 2)
        d, sib = proof[0]
        bad_leaf = merkle.tx_leaf(chain.Tx("a", "m", {"i": 99}, 2.0,
                                           "a:2").to_json())
        out = [merkle.verify_proof(bad_leaf, proof, root),
               merkle.verify_proof(leaves[2], [(d, "00" * 32)]
                                   + list(proof[1:]), root),
               merkle.verify_proof(leaves[2], [("L" if d == "R" else "R",
                                                sib)] + list(proof[1:]),
                                   root),
               merkle.verify_proof(leaves[2], [("X", sib)], root)]
        with pytest.raises(IndexError):
            merkle.merkle_proof(leaves, 5)
        return out
    got = _both(run)
    assert got["port"] == got["ref"] == [False] * 4


# --------------------------------------------------------------------------- #
# Self-verifying headers and the light client
# --------------------------------------------------------------------------- #

def test_header_hashes_equal_the_reference_and_commit_to_the_txs():
    def run(chain, merkle, replica, _c, _e):
        blk = replica.Block(0, chain.GENESIS, "a", _txs(chain.Tx, 3), 0.0, 2)
        blk.hash = blk.compute_hash()
        hdr = blk.header_json()
        leaves = [merkle.tx_leaf(t.to_json()) for t in blk.txs]
        proved = [merkle.verify_proof(leaves[i],
                                      merkle.merkle_proof(leaves, i),
                                      hdr["txroot"]) for i in range(3)]
        blk2 = replica.Block(0, chain.GENESIS, "a", _txs(chain.Tx, 4), 0.0, 2)
        blk2.hash = blk2.compute_hash()
        return blk.hash, chain.header_hash(hdr), hdr, proved, blk2.hash
    got = _both(run)
    assert got["port"] == got["ref"]
    h, hh, _, proved, h2 = got["port"]
    assert h == hh and all(proved) and h2 != h


def test_light_client_accepts_and_rejects_headers_as_the_reference():
    """A valid header (idempotently), then a tampered height, an
    unauthorised sealer and an out-of-turn difficulty claim: rejected."""
    def run(chain, merkle, replica, _c, _e):
        sealers = ["a", "b", "c"]
        blk = replica.Block(0, chain.GENESIS, "a", _txs(chain.Tx, 2), 0.0, 2)
        blk.hash = blk.compute_hash()
        lc = chain.LightClient("edge0", "a", sealers)
        out = [lc.accept_header(blk.header_json()), lc.height,
               lc.accept_header(blk.header_json()),
               lc.accept_header(dict(blk.header_json(), height=5))]
        for sealer in ("mallory", "b"):
            bad = replica.Block(0, chain.GENESIS, sealer, [], 0.0, 2)
            bad.hash = bad.compute_hash()
            out.append(lc.accept_header(bad.header_json()))
        return out, dict(lc.stats)
    got = _both(run)
    assert got["port"] == got["ref"]
    out, stats = got["port"]
    assert out == [True, 1, True, False, False, False]
    assert stats["headers_accepted"] == 1 and stats["headers_rejected"] == 3


@pytest.mark.parametrize("method", ["register", "set_busy"])
def test_proof_roundtrip_on_a_live_chain_matches_the_reference(method):
    """Real txs sealed through ``ChainNetwork`` (no fabric), heads
    announced, one submission light-verified: the same txid, heights and
    hub counters as the reference, the proof verified and cheaper than a
    full replay."""
    def run(chain, merkle, replica, Contract, SimEnv):
        env = SimEnv()
        nodes = ["a", "b", "c"]
        net = chain.ChainNetwork(env, None, sealers=nodes)
        views = {n: net.add_replica(n, Contract("async")) for n in nodes}
        hub = chain.LightSync(None, None, sealers=nodes)
        hub.wire(net)
        lc = hub.add_client("a/edge0", "a")
        for n in nodes:
            views[n].submit(n, "register", logical_time=env.now)
        if method == "set_busy":
            views["a"].submit("a", "set_busy", busy=True,
                              logical_time=env.now)
        env.run()
        txid = hub.verify_submission("a", method=method)
        return (txid, lc.height, dict(lc.verified), dict(hub.stats),
                chain.full_replay_nbytes(net.replicas["a"]))
    got = _both(run)
    assert got["port"] == got["ref"]
    txid, height, verified, stats, full = got["port"]
    assert txid is not None and height >= 1 and verified[txid] is True
    assert stats["proofs_verified"] == 1 and stats["proofs_failed"] == 0
    assert stats["headers_rejected"] == 0
    assert 0 < stats["bytes"] < full


def test_missing_tx_yields_no_proof():
    for chain, _m, replica, _c, _e in SIDES.values():
        rep = replica.ChainReplica("a", ["a"])
        assert chain.find_latest_txid(rep, "a", "submit_model") is None
        assert chain.build_inclusion_proof(rep, "nope") is None


def test_wal_v2_records_rotate_to_corrupt(tmp_path):
    """A v2-era record fails the v3 hash audit and the segment rotates to
    ``.corrupt``; a fresh v3 segment replays (as in the reference)."""
    assert treplica.WAL_FORMAT_VERSION == jreplica.WAL_FORMAT_VERSION == 3
    for side, (chain, _m, replica, _c, _e) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        seg = d / "a.jsonl"
        blk = replica.Block(0, chain.GENESIS, "a", _txs(chain.Tx, 2), 0.0, 2)
        blk.hash = blk.compute_hash()
        rec = blk.to_json()
        rec.pop("txroot")
        rec["hash"] = "ab" * 32
        seg.write_bytes((json.dumps(rec) + "\n").encode())
        rep = replica.ChainReplica("a", ["a"], segment_path=str(seg))
        assert rep.replay_wal() == 0
        assert rep.head == chain.GENESIS
        assert (d / "a.jsonl.corrupt").exists()
        assert seg.read_bytes() == b""
        rep.import_block(blk)
        rep2 = replica.ChainReplica("a2", ["a"], segment_path=str(seg))
        assert rep2.replay_wal() == 1
        assert rep2.head == blk.hash


# --------------------------------------------------------------------------- #
# The three-tier topology over a fabric
# --------------------------------------------------------------------------- #

def test_three_tier_sync_run_with_light_clients():
    """The reference test's acceptance topology (``tests/test_edge.py::
    test_three_tier_sync_run_with_light_clients``) in the port on the CPU:
    3 silos, 2 Sync rounds, 12 edge clients a silo at participation 0.25,
    light clients over ``wan-heterogeneous``, time_scale 0; held to that
    test's invariants."""
    from repro_torch.config import FedConfig, NetConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=2, local_epochs=1,
                    mode="sync", scorer="accuracy", agg_policy="all",
                    score_policy="median", edge_per_silo=12,
                    edge_participation=0.25, edge_light_clients=True,
                    net=NetConfig(preset="wan-heterogeneous"))
    orch = build_image_experiment(get_config("paper-cnn"), fed, n_train=400,
                                  n_test=100, batch_size=4, seed=0,
                                  device="cpu")
    for s in orch.silos:
        s.time_scale = 0.0
    orch.run(2)
    orch.env.run()
    hub = orch.light_sync
    assert hub is not None and all(s.light_sync is hub for s in orch.silos)
    assert len(hub.clients) == 36
    assert hub.stats["proofs_verified"] > 0
    assert hub.stats["proofs_failed"] == 0
    assert hub.stats["headers_rejected"] == 0
    vs = hub.light_vs_full()
    assert 0 < vs["light_bytes"] < vs["full_replay_bytes"]
    assert vs["ratio"] <= 0.10
    assert orch.fabric.stats["edge_bytes"] > 0
    assert orch.fabric.stats["light_bytes"] > 0
    for s in orch.silos:
        assert s.rounds_done == 2
        assert all("edge_participants" in m for m in s.metrics)
    assert orch.chain.converged()
