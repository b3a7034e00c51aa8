"""Gossip replication of announced CIDs.

IPFS keeps popularity-driven replicas implicitly (every fetch caches); that
only helps *after* someone paid the WAN fetch. The replicator pushes each
announced model CID to the owner's ``factor`` nearest peers proactively, so
hot CIDs have a close replica before scorers/aggregators come asking — and so
a churned-out origin doesn't take its round's model down with it (the
failover path in ``StoreNode.get_bytes`` reroutes to these replicas).

Delta awareness: a delta envelope is useless without its base chain. Before
replicating a delta the replicator walks the *full* ancestor chain from the
origin's local blocks and pushes every link the peer is missing, oldest
first, so the replica is decodable the moment it lands (normally the chain
is a no-op skip — the bases were previous rounds' announces). If the origin
itself cannot resolve the chain (a base was gc'd), the delta is not pushed
at all: an undecodable replica would only waste WAN bytes
(``stats['chain_unresolved']``).

Pushes ride ``NetFabric.transfer_async``: they occupy links, take simulated
time to land, and are cancelled by churn like any in-flight transfer.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core import wire
from repro_torch.core.store import deserialize_pytree
from repro_torch.net.fabric import NetFabric, UnreachableError
from repro_torch.obs.metrics import StatsView

MAX_CHAIN = 64  # defensive bound on base-chain walks


class GossipReplicator:
    def __init__(self, fabric: NetFabric, network, factor: int = 1):
        self.fabric = fabric
        self.network = network          # StoreNetwork (duck-typed: .nodes)
        self.factor = int(factor)
        self.stats = StatsView("gossip")
        # cid -> base_cid memo: content addressing makes payloads immutable,
        # so each link's base is parsed from its (model-sized) payload at
        # most once per replicator, not on every announce of the chain
        self._base_of: dict = {}
        # store-less exclusion memo, invalidated by membership growth: at
        # thousand-silo scale rebuilding the tuple per announce is O(n^2)
        # across a round of announces
        self._storeless: tuple = ()
        self._storeless_seen: int = -1

    def _storeless_nodes(self) -> tuple:
        count = self.fabric.node_count
        if count != self._storeless_seen:
            self._storeless = tuple(n for n in self.fabric.nodes
                                    if n not in self.network.nodes)
            self._storeless_seen = count
        return self._storeless

    def _base_cid(self, src_node, cid: str) -> Optional[str]:
        """``base_cid`` of a locally-held payload ('' = chain root); None
        when the origin doesn't hold the payload at all."""
        hit = self._base_of.get(cid)
        if hit is not None:
            return hit
        data = src_node.read_local(cid)
        if data is None:
            return None
        base = wire.base_cid_of_store(deserialize_pytree(data))
        self._base_of[cid] = base
        return base

    def _base_chain(self, src_node, base_cid: str) -> Optional[List[str]]:
        """Every ancestor CID the delta depends on, oldest first, read from
        the origin's local blocks; None when the origin cannot resolve the
        chain itself (missing/gc'd base, or a cycle)."""
        chain, cur, seen = [], base_cid, set()
        while cur:
            if cur in seen or len(chain) >= MAX_CHAIN:
                return None
            seen.add(cur)
            nxt = self._base_cid(src_node, cur)
            if nxt is None:
                return None
            chain.append(cur)
            cur = nxt
        chain.reverse()
        return chain

    def on_announce(self, cid: str, owner: str, nbytes: int,
                    base_cid: str = "") -> None:
        if self.factor <= 0:
            return
        src_node = self.network.nodes.get(owner)
        if src_node is None:
            return
        chain = self._base_chain(src_node, base_cid) if base_cid else []
        # replicate only onto store nodes: the fabric also carries store-less
        # chain participants (the engine's 'orchestrator' replica)
        for peer_id in self.fabric.nearest(owner, self.factor,
                                           exclude=self._storeless_nodes()):
            peer = self.network.nodes.get(peer_id)
            if peer is None:
                self.stats["skipped"] += 1
                continue
            if chain is None:
                # the origin can't resolve the delta's own base chain — a
                # replica would be undecodable, so push nothing to this peer
                self.stats["chain_unresolved"] += 1
                continue
            # bring the peer's base chain current (oldest first) before the
            # delta; an already-current peer skips straight to the delta
            for c in chain:
                if not peer.has(c):
                    self._push(src_node, peer, peer_id, c)
                    self.stats["base_pushes"] += 1
            self._push(src_node, peer, peer_id, cid)

    def _push(self, src_node, peer, peer_id: str, cid: str) -> None:
        if peer.has(cid):
            self.stats["skipped"] += 1
            return
        if self.fabric.in_flight(("replicate", peer_id, cid)):
            # already on the wire to this peer: SimEnv keys hold ONE live
            # event (cancel-and-replace), so re-pushing would charge the link
            # again only to land *later* than the transfer it superseded
            self.stats["skipped"] += 1
            return
        data = src_node.serve_bytes(cid)
        if data is None:
            self.stats["failed"] += 1
            return

        def land(peer=peer, data=data):
            peer.ingest(cid, data)
            self.stats["landed"] += 1

        try:
            self.fabric.transfer_async(src_node.node_id, peer_id, cid,
                                       len(data), land, kind="replicate",
                                       key=("replicate", peer_id, cid))
            self.stats["pushes"] += 1
        except UnreachableError:
            self.stats["failed"] += 1
