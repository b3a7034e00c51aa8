"""The port's WAN fabric against the reference's (``repro.net``).

Both packages get the same seed, the same payload bytes and the same
sequence of puts, fetches and announces; the fabric's transfer trace, the
store nodes' transfer stats, gossip's pushes and the prefetcher's landings
must be equal, record for record. The fabric is host code on both sides
(numpy), so the comparison is exact; only the decoded models differ in
kind (numpy arrays against tensors on the node's device).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core import wire as jwire
from repro.core.simenv import SimEnv as JEnv
from repro.net import GossipReplicator as JGossip
from repro.net import NetFabric as JFabric
from repro.net import Prefetcher as JPrefetcher
from repro.net import Topology as JTopology
from repro_torch.core import store as tstore
from repro_torch.core import wire as twire
from repro_torch.core.simenv import SimEnv as TEnv
from repro_torch.net import GossipReplicator as TGossip
from repro_torch.net import NetFabric as TFabric
from repro_torch.net import Prefetcher as TPrefetcher
from repro_torch.net import Topology as TTopology
from repro_torch.net import UnreachableError

NODES = ("a", "b", "c", "d")


def _payload(seed=0, kib=256):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(kib * 256).astype(np.float32)}


def _swarm(side, preset="wan-heterogeneous", seed=3, nodes=NODES):
    """(env, fabric, store network) of one package, fabric attached."""
    if side == "ref":
        env = JEnv()
        fab = JFabric(env, JTopology(preset, seed=seed), seed=seed)
        net = jstore.StoreNetwork()
        for n in nodes:
            net.add_node(n)
    else:
        env = TEnv()
        fab = TFabric(env, TTopology(preset, seed=seed), seed=seed)
        net = tstore.StoreNetwork()
        for n in nodes:
            net.add_node(n, "cpu")
    net.attach_fabric(fab)
    return env, fab, net


def _trace(fab):
    return [dataclasses.astuple(r) for r in fab.trace]


def _stats(net):
    return {nid: dict(node.stats) for nid, node in net.nodes.items()}


@pytest.mark.parametrize("preset,seed", [("wan-heterogeneous", 5),
                                         ("wan-uniform", 6), ("lan", 0)])
def test_fabric_trace_matches_reference(preset, seed):
    """Twin of ``tests/test_net.py::test_trace_equality_for_same_seed``:
    the same puts and demand fetches give the same transfer records (kind,
    ends, CID, bytes, start and end times), the same fabric stats and the
    same per-node store stats."""
    out = {}
    for side in ("ref", "port"):
        env, fab, net = _swarm(side, preset, seed)
        cid1 = net.nodes["a"].put(_payload(1))
        cid2 = net.nodes["b"].put(_payload(2, kib=1500))   # multi-block
        for nid in ("b", "c", "d"):
            net.nodes[nid].get_bytes(cid1)
        net.nodes["d"].get_bytes(cid2)
        fab.isolate("a")                # c now fetches cid1 via a replica
        net.nodes["c"].get_bytes(cid2)
        env.run()
        out[side] = (cid1, cid2, _trace(fab), dict(fab.stats), _stats(net),
                     env.now)
    assert out["port"] == out["ref"]
    assert {r[0] for r in out["port"][2]} >= {"fetch"}


def test_store_transfer_stats_match_reference():
    """Twin of ``tests/test_net.py::test_store_transfer_stats_accounting``:
    bytes in and out, fetch time, and the charge handed over exactly once,
    equal to the reference's."""
    got = {}
    for side in ("ref", "port"):
        env, fab, net = _swarm(side, "wan-uniform")
        a, b = net.nodes["a"], net.nodes["b"]
        cid = a.put(_payload(kib=1500))
        nbytes = len(a.read_local(cid))
        b.get_bytes(cid)
        drained = b.drain_transfer_time()
        got[side] = (nbytes, dict(a.stats), dict(b.stats), drained,
                     b.drain_transfer_time())
    assert got["port"] == got["ref"]
    nbytes, a_stats, b_stats, drained, again = got["port"]
    assert b_stats["bytes_in"] == a_stats["bytes_out"] == nbytes
    assert drained == pytest.approx(b_stats["fetch_time"]) and drained > 0
    assert again == 0.0


def test_partitioned_cid_raises_unreachable_in_the_port():
    env, fab, net = _swarm("port", nodes=("a", "b"))
    cid = net.nodes["a"].put(_payload())
    fab.isolate("a")
    with pytest.raises(UnreachableError):
        net.nodes["b"].get_bytes(cid)
    with pytest.raises(KeyError):
        net.nodes["b"].get_bytes("bafy" + "0" * 64)


def _delta_chain(side, a):
    """Three envelopes from node ``a``: an int8 root and two int8-delta
    links, each delta against the previous model as ``a`` decodes it."""
    rng = np.random.default_rng(0)
    v0, v1, v2 = (rng.normal(0, 0.1, 4000).astype(np.float32)
                  for _ in range(3))
    if side == "ref":
        enc, vec = jwire.encode_vec, lambda v: v
    else:
        enc, vec = twire.encode_vec, torch.from_numpy
    cid0 = a.put(enc(vec(v0), "int8").to_store())
    b0 = a.get_decoded(cid0, a.wire_decoder()).vec()
    cid1 = a.put(enc(vec(v0 + v1), "int8-delta", base_vec=b0,
                     base_cid=cid0).to_store())
    b1 = a.get_decoded(cid1, a.wire_decoder()).vec()
    cid2 = a.put(enc(vec(v0 + v1 + v2), "int8-delta", base_vec=b1,
                     base_cid=cid1).to_store())
    return cid0, cid1, cid2


def test_gossip_pushes_base_chain_before_delta_as_reference():
    """Twin of ``tests/test_net.py::test_gossip_pushes_missing_base_chain_
    before_delta``: replicating the newest delta moves its two-link base
    chain first, oldest first; the envelopes' bytes (hence CIDs), the
    pushes and the replica are the reference's, and the replica decodes
    the delta from its own blocks to the origin's bits."""
    got = {}
    for side, Gossip in (("ref", JGossip), ("port", TGossip)):
        env, fab, net = _swarm(side, nodes=("a", "b", "c"))
        gossip = Gossip(fab, net, factor=1)
        fab.subscribe(gossip.on_announce)
        a = net.nodes["a"]
        cids = _delta_chain(side, a)
        fab.announce(cids[2], "a", base_cid=cids[1])
        env.run()
        replica = next(nid for nid in ("b", "c")
                       if net.nodes[nid].has(cids[2]))
        node = net.nodes[replica]
        dm = node.get_decoded(cids[2], node.wire_decoder())
        want = a.get_decoded(cids[2], a.wire_decoder()).vec()
        got[side] = (cids, replica, dict(gossip.stats), _trace(fab),
                     np.asarray(dm.vec()), np.asarray(want))
    (cids, replica, stats, trace, vec, want) = got["port"]
    assert (cids, replica, stats, trace) == got["ref"][:4]
    assert net.nodes[replica].has(cids[0]) and net.nodes[replica].has(cids[1])
    assert stats["base_pushes"] == 2
    # the pushes land oldest first
    pushed = [r[3] for r in trace if r[0] == "replicate"]
    assert pushed == list(cids)
    np.testing.assert_array_equal(vec, want)
    np.testing.assert_array_equal(vec, got["ref"][4])


def test_prefetch_warms_decoded_cache_as_reference():
    """Twin of ``tests/test_net.py::test_prefetch_warms_decoded_cache_after_
    transfer_time``: nothing is warm before the transfer lands, both peers
    are warm after it, the consumer's pull is a charge-free prefetch hit,
    with the reference's trace and stats. The port's cache holds the node's
    own wire decoding: a tensor on its device."""
    got = {}
    for side, Prefetcher in (("ref", JPrefetcher), ("port", TPrefetcher)):
        env, fab, net = _swarm(side, "wan-uniform", nodes=("a", "b", "c"))
        pf = Prefetcher(fab, net)
        fab.subscribe(pf.on_announce)
        a, b = net.nodes["a"], net.nodes["b"]
        enc = jwire.encode_vec if side == "ref" else twire.encode_vec
        vec = _payload()["w"]
        cid = a.put(enc(vec if side == "ref" else torch.from_numpy(vec),
                        "int8").to_store())
        fab.announce(cid, "a")
        cold = [b.has_decoded(cid)]
        env.run(until=1e-4)
        cold.append(b.has_decoded(cid))
        env.run()
        warm = (b.has_decoded(cid), net.nodes["c"].has_decoded(cid))
        before = b.stats["fetch_time"]
        dm = b.get_decoded(cid, b.wire_decoder())
        got[side] = (cold, warm, b.stats["fetch_time"] - before,
                     dict(b.stats), dict(pf.stats), pf.hit_stats()["hit_rate"],
                     _trace(fab), np.asarray(dm.vec()))
    port = got["port"]
    assert port[:7] == got["ref"][:7]
    assert port[0] == [False, False] and port[1] == (True, True)
    assert port[2] == 0.0 and port[3]["prefetch_hits"] == 1
    assert port[4]["completed"] == 2 and port[5] > 0
    np.testing.assert_array_equal(port[7], got["ref"][7])


def test_prefetch_cancelled_by_churn_as_reference():
    """Twin of ``tests/test_net.py::test_prefetch_cancelled_by_churn``: a
    prefetch in flight when its destination churns out never lands."""
    got = {}
    for side, Prefetcher in (("ref", JPrefetcher), ("port", TPrefetcher)):
        env, fab, net = _swarm(side, "wan-uniform", nodes=("a", "b"))
        pf = Prefetcher(fab, net, lambda flat: flat)
        fab.subscribe(pf.on_announce)
        cid = net.nodes["a"].put(_payload())
        fab.announce(cid, "a")
        env.run(until=1e-4)            # transfer now in flight
        fab.node_down("b")
        env.run()
        got[side] = (net.nodes["b"].has_decoded(cid), dict(pf.stats),
                     dict(fab.stats))
    assert got["port"] == got["ref"]
    assert got["port"][0] is False
    assert got["port"][1]["completed"] == 0
    assert got["port"][2]["cancelled"] == 1
