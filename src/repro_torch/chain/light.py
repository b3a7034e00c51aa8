"""Header-only light clients: how edge nodes follow the chain.

A full replica replays every block; an edge device cannot afford that. Since
PR 10 the block hash commits to the tx list *through* a Merkle root carried
in the header (``replica.Block.tx_root``), so a header alone is
self-verifying: recompute ``header_hash`` and validate the Clique seal
against the known sealer set — no tx bodies needed. On top of that, an
inclusion proof (``merkle.merkle_proof``) shows a specific transaction is
under a header's ``txroot`` at logarithmic cost. Together they let an edge
node answer "did my silo's model land on-chain?" for header+proof bytes
instead of full block replay — the header-chain + proof pattern of Ethereum
light clients, adapted to a PoA committee.

``LightSync`` is the hub wiring this to the simulated network:

  * it subscribes to ``ChainNetwork`` head changes; each serving (full)
    replica's new head is *announced* to that silo's light clients as a
    header push (``HEADER_WIRE_NBYTES``, fabric kind ``"light"``, ctl
    lane). Announcements are debounced per client with the SimEnv's keyed
    cancel-and-replace scheduling — a burst of seals collapses into one
    push of the latest head;
  * ``verify_submission(silo)`` round-trips a per-tx proof: a tiny request
    from the client to its silo's full replica, answered with
    ``{header, tx, index, siblings}``; the client verifies header hash,
    seal, and Merkle path locally. Verifications land in
    ``stats['proofs_verified'|'proofs_failed']``.

Every light-sync byte is charged on the fabric (``stats['light_bytes']``)
and mirrored in the hub's ``StatsView('light')`` — ``light_vs_full()``
reports the measured ratio against what full block replay would have cost
the same client population (the edgebench acceptance gate: <= 10%).

With ``fabric=None``/``env=None`` delivery is synchronous and free (unit
tests), byte *accounting* still accrues.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.chain import merkle, sealer as sealing
from repro_torch.chain.replica import (GENESIS, HEADER_WIRE_NBYTES,
                                       ChainReplica, header_hash)
from repro_torch.obs import events as obsev
from repro_torch.obs.metrics import StatsView

PROOF_REQUEST_NBYTES = 96    # txid + client id, one control message
SIBLING_WIRE_NBYTES = 33     # direction byte + one 32-byte sibling hash
INDEX_WIRE_NBYTES = 8
TX_WIRE_OVERHEAD = 64        # canonical-JSON framing around the proved tx
ANNOUNCE_DEBOUNCE_S = 0.25   # per-client head-push coalescing window


def proof_nbytes(proof: Dict) -> int:
    """Wire size of one inclusion-proof response."""
    import json
    return (HEADER_WIRE_NBYTES + INDEX_WIRE_NBYTES
            + SIBLING_WIRE_NBYTES * len(proof["siblings"])
            + len(json.dumps(proof["tx"], sort_keys=True))
            + TX_WIRE_OVERHEAD)


def build_inclusion_proof(replica: ChainReplica,
                          txid: str) -> Optional[Dict]:
    """Full-replica side: locate ``txid`` on the canonical chain and build
    ``{header, tx, index, siblings}`` (newest blocks searched first)."""
    for blk in reversed(replica.canonical()):
        for i, tx in enumerate(blk.txs):
            if tx.txid == txid:
                leaves = [merkle.tx_leaf(t.to_json()) for t in blk.txs]
                return {"header": blk.header_json(), "tx": tx.to_json(),
                        "index": i, "siblings": merkle.merkle_proof(leaves, i)}
    return None


def find_latest_txid(replica: ChainReplica, sender: str,
                     method: str) -> Optional[str]:
    """The newest canonical tx matching (sender, method) — e.g. the silo's
    latest ``submit_model``."""
    for blk in reversed(replica.canonical()):
        for tx in reversed(blk.txs):
            if tx.sender == sender and tx.method == method:
                return tx.txid
    return None


def full_replay_nbytes(replica: ChainReplica) -> int:
    """What full block replay of the canonical chain costs on the wire —
    the denominator of the light-vs-full comparison."""
    return sum(b.nbytes() for b in replica.canonical())


class LightClient:
    """One edge node's header-only view of its silo's chain."""

    __slots__ = ("node_id", "serving", "sealers", "headers", "head",
                 "stats", "verified")

    def __init__(self, node_id: str, serving: str, sealers: List[str],
                 stats: Optional[StatsView] = None):
        self.node_id = node_id
        self.serving = serving          # the silo's full replica
        self.sealers = list(sealers)
        self.headers: Dict[str, Dict] = {}
        self.head: Optional[Dict] = None
        self.stats = stats if stats is not None else StatsView("light")
        self.verified: Dict[str, bool] = {}   # txid -> last proof outcome

    @property
    def height(self) -> int:
        return self.head["height"] + 1 if self.head is not None else 0

    def accept_header(self, hdr: Dict) -> bool:
        """Self-verify a header: hash recomputes header-only, seal validates
        against the sealer set. Known headers are accepted idempotently."""
        h = hdr.get("hash", "")
        if h != header_hash(hdr):
            # verify BEFORE the known-hash dedupe: a tampered header
            # claiming an already-accepted hash must still be rejected
            self.stats["headers_rejected"] += 1
            return False
        if h in self.headers:
            return True
        if hdr["sealer"] not in self.sealers or hdr["difficulty"] != \
                sealing.difficulty(self.sealers, hdr["height"],
                                   hdr["sealer"]):
            self.stats["headers_rejected"] += 1
            return False
        self.headers[h] = hdr
        self.stats["headers_accepted"] += 1
        if self.head is None or hdr["height"] > self.head["height"]:
            self.head = hdr
        return True

    def verify_inclusion(self, proof: Dict) -> bool:
        """Check one ``{header, tx, index, siblings}`` response: header
        self-verifies, Merkle path folds to the header's ``txroot``."""
        hdr = proof["header"]
        if not self.accept_header(hdr):
            return False
        leaf = merkle.tx_leaf(proof["tx"])
        ok = merkle.verify_proof(leaf, proof["siblings"], hdr["txroot"])
        txid = proof["tx"].get("txid", "")
        if txid:
            self.verified[txid] = ok
        return ok


class LightSync:
    """Hub: head announcements + proof round-trips for a run's light
    clients, charged on the fabric's ctl lane (kind ``"light"``)."""

    def __init__(self, env=None, fabric=None, *,
                 sealers: List[str]):
        self.env = env
        self.fabric = fabric
        self.sealers = list(sealers)
        self.replicas: Dict[str, ChainReplica] = {}
        self.clients: Dict[str, LightClient] = {}
        self._by_serving: Dict[str, List[LightClient]] = {}
        # duty cycling: serving -> the subset of its clients currently awake
        # (None = everyone); sleeping devices get no head pushes — they
        # self-verify whatever header arrives with their next proof instead
        self._awake: Dict[str, Optional[set]] = {}
        self.stats = StatsView("light")

    # -- membership ---------------------------------------------------------- #
    def attach_replica(self, node_id: str, replica: ChainReplica) -> None:
        self.replicas[node_id] = replica

    def add_client(self, node_id: str, serving: str) -> LightClient:
        lc = LightClient(node_id, serving, self.sealers, self.stats)
        self.clients[node_id] = lc
        self._by_serving.setdefault(serving, []).append(lc)
        if self.fabric is not None:
            self.fabric.register_node(node_id)
        return lc

    def wire(self, chain_net) -> None:
        """Subscribe to the chain plane: every replica head change becomes
        a (debounced) header announcement to that silo's light clients."""
        for nid, rep in chain_net.replicas.items():
            self.attach_replica(nid, rep)
        chain_net.subscribe_heads(self.on_head)

    def set_awake(self, serving: str, node_ids: Optional[List[str]]) -> None:
        """Restrict head pushes from ``serving`` to these clients until the
        next call (``None`` wakes everyone). An edge fleet calls this with
        its round's sampled participants — a mostly-sleeping fleet is where
        light sync pays off."""
        self._awake[serving] = None if node_ids is None else set(node_ids)

    # -- head announcements --------------------------------------------------- #
    def on_head(self, node_id: str, _blk) -> None:
        clients = self._by_serving.get(node_id)
        if not clients:
            return
        awake = self._awake.get(node_id)
        if awake is not None:
            clients = [lc for lc in clients if lc.node_id in awake]
        for lc in clients:
            if self.env is None:
                self._push_head(node_id, lc)
            else:
                # keyed cancel-and-replace: a seal burst collapses to one
                # push of whatever the head is when the debounce fires
                self.env.schedule(
                    ANNOUNCE_DEBOUNCE_S,
                    lambda nid=node_id, c=lc: self._push_head(nid, c),
                    f"light:announce:{lc.node_id}",
                    key=("light-ann", node_id, lc.node_id))

    def _push_head(self, serving: str, lc: LightClient) -> None:
        rep = self.replicas.get(serving)
        if rep is None or rep.head == GENESIS:
            return
        hdr = rep.blocks[rep.head].header_json()
        self.stats["announcements"] += 1
        self._transfer(serving, lc.node_id, f"hdr:{hdr['hash'][:12]}",
                       HEADER_WIRE_NBYTES,
                       lambda: lc.accept_header(hdr))

    # -- per-tx inclusion proofs ---------------------------------------------- #
    def verify_submission(self, silo_id: str, *,
                          clients: Optional[List[LightClient]] = None,
                          method: str = "submit_model") -> Optional[str]:
        """Every given light client of ``silo_id`` (default: all of them)
        checks that the silo's newest ``method`` tx landed on-chain.
        Returns the txid being proved (None when the replica has none)."""
        rep = self.replicas.get(silo_id)
        if rep is None:
            return None
        txid = find_latest_txid(rep, silo_id, method)
        if txid is None:
            return None
        for lc in (clients if clients is not None
                   else list(self._by_serving.get(silo_id, ()))):
            self.request_proof(lc, txid)
        return txid

    def request_proof(self, lc: LightClient, txid: str) -> None:
        self.stats["proof_requests"] += 1
        self._transfer(lc.node_id, lc.serving, f"proofreq:{txid}",
                       PROOF_REQUEST_NBYTES,
                       lambda: self._serve_proof(lc, txid))

    def _serve_proof(self, lc: LightClient, txid: str) -> None:
        rep = self.replicas.get(lc.serving)
        proof = build_inclusion_proof(rep, txid) if rep is not None else None
        if proof is None:
            self.stats["proofs_missing"] += 1
            return
        self.stats["proofs_served"] += 1
        self._transfer(lc.serving, lc.node_id, f"proof:{txid}",
                       proof_nbytes(proof),
                       lambda: self._deliver_proof(lc, txid, proof))

    def _deliver_proof(self, lc: LightClient, txid: str,
                       proof: Dict) -> None:
        ok = lc.verify_inclusion(proof)
        self.stats["proofs_verified" if ok else "proofs_failed"] += 1
        if self.env is not None:
            self.env.emit(obsev.light_verify(lc.node_id, txid, ok))
            tr = self.env.tracer
            if tr.enabled:
                tr.event("light.verify", f"{lc.serving}/light",
                         self.env.now, client=lc.node_id, txid=txid, ok=ok)

    # -- transport ------------------------------------------------------------ #
    def _transfer(self, src: str, dst: str, label: str, nbytes: int,
                  on_land: Callable[[], None]) -> None:
        """One light-sync move: free and synchronous without a fabric,
        otherwise a charged ctl-lane (``"light"``) transfer. Bytes accrue
        in the hub's own stats either way — the measurement behind the
        light-vs-full acceptance ratio."""
        self.stats["bytes"] += int(nbytes)
        if self.fabric is None:
            on_land()
            return
        from repro_torch.net.fabric import UnreachableError
        try:
            # src-qualified key: the default (kind, dst, cid) would make
            # concurrent requests for the SAME txid from different clients
            # cancel-and-replace each other
            self.fabric.transfer_async(src, dst, label, nbytes, on_land,
                                       kind="light",
                                       key=("light", src, dst, label))
        except UnreachableError:
            self.stats["undeliverable"] += 1

    # -- measurement ----------------------------------------------------------- #
    def light_vs_full(self) -> Dict[str, float]:
        """Measured light-sync bytes vs what full block replay would have
        cost the same client population (each client replaying its serving
        replica's canonical chain)."""
        full = 0
        for lc in self.clients.values():
            rep = self.replicas.get(lc.serving)
            if rep is not None:
                full += full_replay_nbytes(rep)
        light = int(self.stats["bytes"])
        return {"light_bytes": light, "full_replay_bytes": full,
                "ratio": (light / full) if full else 0.0}
