"""Per-silo chain replica: block tree + mempool + canonical-head maintenance.

One ``ChainReplica`` is one participant's view of the PoA chain. It holds the
full block *tree* (not just the canonical chain): competing blocks arrive
whenever sealers act concurrently or a partition splits the sealer set, and
fork choice (``forkchoice.py``) decides the canonical head. Contract state is
maintained by an attached executor (``adapter.ContractExecutor``):

  * canonical-head *extensions* execute incrementally (the fast path);
  * a *reorg* rebuilds contract state by re-executing the new canonical chain
    from genesis — deterministic, so every replica that converges on a head
    converges on byte-identical contract state;
  * transactions this replica submitted that fall off the canonical chain in
    a reorg return to the mempool (original submission order) and are
    re-sealed on the new head, so no locally-submitted tx is ever lost.

Sealing follows the Clique schedule in ``sealer.py`` with period=0: a
submitted tx seals immediately on the local replica (out-of-turn if needed),
giving submit-via-local-replica / read-your-replica semantics. During a
partition both sides keep sealing — that is the fork; healing is pure block
dissemination (``sync.py``).

``solo=True`` is single-replica mode (the ``core.ledger.Ledger`` facade): one
process impersonates the whole committee, sealing every height as the
in-turn sealer. That reproduces the pre-chain Ledger behaviour bit-for-bit.

**Durability.** Each replica may carry a ``segment_path``: a per-replica
JSONL write-ahead segment that every stored block (sealed or imported)
appends to as it lands. A crash (``wipe()`` — all in-memory state drops)
recovers by ``replay_wal()``: the segment replays in arrival order — parents
always precede children on disk, so every record imports as a clean tree
insert — auditing hashes/seals as it loads and *stopping at the first
break* (torn final record from a crash mid-append, corrupt or missing
record). The broken suffix rotates to ``<path>.corrupt`` and the file is
truncated to the valid prefix, so post-recovery appends extend a well-formed
segment. Disk replay costs ZERO fabric bytes; only the gap sealed while the
process was dead is fetched from peers (``sync.ChainNetwork.restart``).

``snapshot()`` captures the full replica state (block tree + mempool + head
+ contract state, keyed by ``contract.state_digest()``) as a frozen
dataclass; ``restore_snapshot`` + ``replay_wal(skip=snap.wal_count)`` is
byte-identical to a genesis replay of the whole segment.

On-disk format: v3 (headers carry a deterministic Merkle transaction root
— ``txroot`` — and the block hash commits to the tx list *through the
root*, so a header alone is self-verifying and light clients can check
per-tx inclusion proofs against it; a v1/v2 file fails the hash audit at
its first record and rotates to ``.corrupt`` wholesale).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.chain import forkchoice, merkle, sealer as sealing
from repro_torch.chain.forkchoice import GENESIS
from repro_torch.obs.metrics import StatsView

WAL_FORMAT_VERSION = 3   # headers carry txroot; hash commits to txs via it

# wire size of one binary header: height(8) + prev(32) + sealer(~20) +
# time(8) + difficulty(1) + salt(8) + txroot(32) — what a light client pays
# per header instead of ``Block.nbytes()`` for the full JSON block
HEADER_WIRE_NBYTES = 112


@dataclass
class Tx:
    sender: str
    method: str
    args: Dict[str, Any]
    nonce: int = 0
    # globally-unique id assigned by the submitting replica ("<origin>:<seq>");
    # identity for dedupe, emit-once guards and reorg resurrection
    txid: str = ""

    def to_json(self) -> Dict:
        out = {"sender": self.sender, "method": self.method,
               "args": self.args, "nonce": self.nonce}
        if self.txid:
            out["txid"] = self.txid
        return out


@dataclass
class Block:
    height: int
    prev_hash: str
    sealer: str
    txs: List[Tx]
    logical_time: float
    difficulty: int = sealing.DIFF_IN_TURN
    salt: int = 0            # equivocation variants differ only by salt
    tx_root: str = ""        # Merkle root over txs (set by compute_hash)
    hash: str = ""

    def to_json(self) -> Dict:
        return {"height": self.height, "prev": self.prev_hash,
                "sealer": self.sealer, "time": self.logical_time,
                "difficulty": self.difficulty, "salt": self.salt,
                "txroot": self.tx_root, "hash": self.hash,
                "txs": [t.to_json() for t in self.txs]}

    def compute_hash(self) -> str:
        """Header hash. Commits to the tx list through the Merkle root
        (derived here, never trusted from the wire), so a header alone
        re-verifies without the tx bodies — see ``header_hash``."""
        self.tx_root = merkle.tx_root([t.to_json() for t in self.txs])
        return header_hash(self.header_json())

    def header_json(self) -> Dict:
        """The header: everything the hash covers, plus the hash itself —
        what a light client stores and what head announcements carry."""
        return {"height": self.height, "prev": self.prev_hash,
                "sealer": self.sealer, "time": self.logical_time,
                "difficulty": self.difficulty, "salt": self.salt,
                "txroot": self.tx_root, "hash": self.hash}

    def nbytes(self) -> int:
        """Wire size of this block (charged on fabric links by sync.py)."""
        return len(json.dumps(self.to_json()))

    @classmethod
    def from_json(cls, rec: Dict) -> "Block":
        """Parse one WAL/wire record; raises KeyError/TypeError/ValueError on
        malformed input (a torn record from a crash mid-append)."""
        txs = [Tx(t["sender"], t["method"], t["args"],
                  t.get("nonce", 0), t.get("txid", ""))
               for t in rec["txs"]]
        return cls(rec["height"], rec["prev"], rec["sealer"], txs,
                   rec["time"], rec.get("difficulty", 2),
                   rec.get("salt", 0), rec.get("txroot", ""), rec["hash"])


def header_hash(hdr: Dict) -> str:
    """Hash of a header dict — header-only, no tx bodies. The light
    client's self-verification: ``hdr["hash"] == header_hash(hdr)``."""
    body = json.dumps({
        "height": hdr["height"], "prev": hdr["prev"],
        "sealer": hdr["sealer"], "time": hdr["time"],
        "difficulty": hdr["difficulty"], "salt": hdr["salt"],
        "txroot": hdr["txroot"]}, sort_keys=True)
    return hashlib.sha256(body.encode()).hexdigest()


@dataclass(frozen=True)
class ReplicaSnapshot:
    """Frozen full-state snapshot of one replica (deterministic restart).

    ``state_digest`` is the key: a replica restored from this snapshot plus
    the WAL suffix past ``wal_count`` is byte-identical (same digest) to one
    that replayed its whole segment from genesis. Blocks are stored in
    insertion order (parents before children), so restore is a straight
    tree rebuild with no orphan pool."""
    node_id: str
    state_digest: str            # contract.state_digest() at capture
    head: str
    seq: int
    wal_count: int               # WAL records this snapshot covers
    blocks: Tuple[str, ...]      # full block tree, JSON, insertion order
    mempool: Tuple[str, ...]     # pending txs, JSON, submission order
    my_txs: Tuple[str, ...]      # locally-submitted txs (reorg resurrection)
    onchain: Tuple[str, ...]     # txids on the canonical chain
    seen: Tuple[str, ...]        # executor emit-once guard
    contract_state: str          # canonical JSON of full contract state
    format_version: int = WAL_FORMAT_VERSION

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, sort_keys=True)


def load_snapshot(path: str) -> ReplicaSnapshot:
    with open(path) as f:
        raw = json.load(f)
    for k in ("blocks", "mempool", "my_txs", "onchain", "seen"):
        raw[k] = tuple(raw[k])
    return ReplicaSnapshot(**raw)


class ChainReplica:
    def __init__(self, node_id: str, sealers: List[str], *,
                 executor=None, solo: bool = False,
                 byzantine: Optional[str] = None,
                 segment_path: Optional[str] = None):
        if not sealers:
            raise ValueError("need at least one PoA sealer")
        self.node_id = node_id
        self.sealers = list(sealers)
        self.executor = executor
        self.solo = solo
        self.byzantine = byzantine
        self.segment_path = segment_path
        # height of the first broken record hit during replay (None = intact)
        self.wal_stopped_at: Optional[int] = None
        self._replaying = False      # suppress WAL appends during replay
        self._wal_records = 0        # valid records currently in the segment
        self.stats = StatsView("replica", node_id)
        self._init_memory()

    def _init_memory(self) -> None:
        """(Re)initialize every piece of in-memory chain state."""
        self.blocks: Dict[str, Block] = {}
        self.head = GENESIS
        self._td: Dict[str, int] = {GENESIS: 0}
        self._height: Dict[str, int] = {GENESIS: -1}
        self.mempool: "OrderedDict[str, Tx]" = OrderedDict()
        self._my_txs: "OrderedDict[str, Tx]" = OrderedDict()
        self._onchain: Set[str] = set()          # txids on the canonical chain
        self._orphans: Dict[str, List[Block]] = {}   # parent hash -> blocks
        self._sealed_at: Dict[Tuple[str, int], str] = {}
        self._at_height: Dict[int, int] = {}     # blocks held per height
        # conflicting (first, second) block pairs observed for the same
        # (sealer, height): drained by sync.py into tx_report_equivocation
        self._equivocation_proofs: List[Tuple[Block, Block]] = []
        self._seq = 0

    # -- chain reads --------------------------------------------------------- #
    @property
    def height(self) -> int:
        """Number of blocks on the canonical chain (Ledger-API compatible)."""
        return self._height[self.head] + 1

    @property
    def head_hash(self) -> str:
        return self.head

    def canonical(self) -> List[Block]:
        out, cur = [], self.head
        while cur != GENESIS:
            blk = self.blocks[cur]
            out.append(blk)
            cur = blk.prev_hash
        out.reverse()
        return out

    def block_randomness(self, height: int = -1) -> int:
        """Deterministic 'on-chain' randomness from a canonical block hash."""
        return int(self.canonical()[height].hash[:16], 16)

    def verify(self) -> bool:
        """Audit the canonical chain: linkage, hashes, seal validity."""
        prev, ph = GENESIS, -1
        for blk in self.canonical():
            if blk.prev_hash != prev or blk.hash != blk.compute_hash():
                return False
            if blk.height != ph + 1:
                return False
            if not sealing.validate_seal(self.sealers, blk):
                return False
            prev, ph = blk.hash, blk.height
        return True

    # -- sealing -------------------------------------------------------------- #
    @property
    def can_seal(self) -> bool:
        return self.solo or self.node_id in self.sealers

    def submit(self, sender: str, method: str, args: Dict[str, Any],
               logical_time: float = 0.0
               ) -> Tuple[Tx, Optional[Block], str, Any]:
        """Mempool + immediate local seal (Clique period=0). Returns
        ``(tx, sealed_block, status, result)`` where status is ``"ok"`` /
        ``"revert"`` (result is the handler return / the revert exception) or
        ``"queued"`` when this replica cannot seal."""
        self._seq += 1
        tx = Tx(sender, method, dict(args), self._seq,
                f"{self.node_id}:{self._seq}")
        self.mempool[tx.txid] = tx
        self._my_txs[tx.txid] = tx
        self.stats["txs"] += 1
        blk = self.seal(logical_time)
        if blk is None:
            return tx, None, "queued", None
        status, result = ("ok", None)
        if self.executor is not None:
            status, result = self.executor.last_results.get(
                tx.txid, ("ok", None))
        return tx, blk, status, result

    def seal(self, logical_time: float = 0.0) -> Optional[Block]:
        """Seal every mempool tx into one block on the current head."""
        if not self.mempool or not self.can_seal:
            return None
        h = self._height[self.head] + 1
        who = sealing.in_turn_sealer(self.sealers, h) if self.solo \
            else self.node_id
        blk = Block(h, self.head, who, list(self.mempool.values()),
                    logical_time, sealing.difficulty(self.sealers, h, who))
        blk.hash = blk.compute_hash()
        self.mempool = OrderedDict()
        self._insert(blk)
        self._switch_head(blk.hash)        # own extension always wins
        self.stats["blocks_sealed"] += 1
        return blk

    # -- import --------------------------------------------------------------- #
    def import_block(self, blk: Block) -> str:
        """Add a gossiped block to the tree and update the canonical head.
        Returns ``known | invalid | orphan | extended | reorged | side``."""
        if blk.hash in self.blocks:
            return "known"
        if blk.hash != blk.compute_hash() or \
                not sealing.validate_seal(self.sealers, blk):
            self.stats["invalid"] += 1
            return "invalid"
        if blk.prev_hash != GENESIS and blk.prev_hash not in self.blocks:
            pend = self._orphans.setdefault(blk.prev_hash, [])
            if all(b.hash != blk.hash for b in pend):
                pend.append(blk)
                self.stats["orphans"] += 1
            return "orphan"
        inserted = self._connect(blk)
        self.stats["blocks_imported"] += len(inserted)
        best = self.head
        for h in inserted:
            if forkchoice.better(self, h, best):
                best = h
        if best == self.head:
            return "side"       # the incoming branch lost fork choice
        return self._switch_head(best)

    def _insert(self, blk: Block) -> None:
        self.blocks[blk.hash] = blk
        self._td[blk.hash] = self._td[blk.prev_hash] + blk.difficulty
        self._height[blk.hash] = blk.height
        self.stats["blocks"] += 1
        self._wal_append(blk)
        # never reuse a txid: any own-origin tx (disk replay, peer catch-up
        # after a kill wiped the counter) advances the sequence
        own = f"{self.node_id}:"
        for t in blk.txs:
            if t.txid.startswith(own):
                self._seq = max(self._seq, t.nonce)
        # a second block at an occupied height is an observed fork (the
        # status codes don't measure this: catch-up ancestor imports are
        # "side" without being new forks)
        seen = self._at_height.get(blk.height, 0)
        self._at_height[blk.height] = seen + 1
        if seen:
            self.stats["forks_observed"] += 1
        key = (blk.sealer, blk.height)
        other = self._sealed_at.get(key)
        if other is None:
            self._sealed_at[key] = blk.hash
        elif other != blk.hash:
            self.stats["equivocations_seen"] += 1
            # both sealed headers ARE the slashing proof — but only when
            # they extend the SAME parent: re-sealing the same height on a
            # different branch after a reorg is honest fork behaviour, not
            # equivocation (sync.py drains the queue after each delivery)
            if self.blocks[other].prev_hash == blk.prev_hash:
                self._equivocation_proofs.append((self.blocks[other], blk))

    def drain_equivocation_proofs(self) -> List[Tuple[Block, Block]]:
        """Conflicting block pairs observed since the last drain."""
        out, self._equivocation_proofs = self._equivocation_proofs, []
        return out

    def _connect(self, blk: Block) -> List[str]:
        """Insert ``blk`` plus any orphans waiting on it (BFS down the tree);
        returns the inserted hashes."""
        out: List[str] = []
        stack = [blk]
        while stack:
            b = stack.pop(0)
            parent_h = self._height.get(b.prev_hash)
            if parent_h is None or b.height != parent_h + 1:
                self.stats["invalid"] += 1
                continue
            self._insert(b)
            out.append(b.hash)
            for w in self._orphans.pop(b.hash, ()):
                if w.hash not in self.blocks:
                    stack.append(w)
        return out

    # -- head switching -------------------------------------------------------- #
    def _switch_head(self, new: str) -> str:
        old = self.head
        if new == old:
            return "known"
        anc = forkchoice.common_ancestor(self, old, new)
        self.head = new
        if anc == old:                         # pure extension: fast path
            path, cur = [], new
            while cur != anc:
                blk = self.blocks[cur]
                path.append(blk)
                cur = blk.prev_hash
            for blk in reversed(path):
                self._exec(blk)
                for t in blk.txs:
                    if t.txid:
                        self._onchain.add(t.txid)
                        # a resurrected tx that lands via an imported
                        # extension must leave the mempool, or the next
                        # seal would put it on-chain twice
                        self.mempool.pop(t.txid, None)
            return "extended"
        depth = self._height[old] - self._height[anc]
        self.stats["reorgs"] += 1
        self.stats["max_reorg_depth"] = max(self.stats["max_reorg_depth"],
                                            depth)
        chain = self.canonical()
        self._onchain = {t.txid for b in chain for t in b.txs if t.txid}
        if self.executor is not None:
            self.stats["reverts"] += self.executor.rebuild(chain)
        # resurrect locally-submitted txs the reorg dropped, original order
        self.mempool = OrderedDict(
            (txid, tx) for txid, tx in self._my_txs.items()
            if txid not in self._onchain)
        return "reorged"

    def _exec(self, blk: Block) -> None:
        if self.executor is not None:
            self.stats["reverts"] += self.executor.execute_block(blk)

    # -- durability: write-ahead segment -------------------------------------- #
    def _wal_append(self, blk: Block) -> None:
        """Append one stored block to the per-replica segment. Called from
        ``_insert`` so *every* block that enters the tree — sealed locally or
        imported from a peer — persists in arrival order (parents always
        precede children: ``_connect`` only inserts connected blocks)."""
        if self.segment_path is None or self._replaying:
            return
        line = json.dumps(blk.to_json()) + "\n"
        with open(self.segment_path, "a") as f:
            f.write(line)
        self._wal_records += 1
        self.stats["wal_blocks"] += 1
        self.stats["bytes"] += len(line)

    def replay_wal(self, *, skip: int = 0) -> int:
        """Replay the on-disk segment into the (empty or snapshot-restored)
        in-memory tree, through the executor when one is attached. Pure
        local disk I/O — charged ZERO fabric bytes; peer catch-up pays only
        for the gap sealed while this process was dead.

        Audits as it loads: a record that is torn (crash mid-append),
        fails its hash/seal audit, or doesn't connect to the tree ends the
        replay *there* — the intact prefix loads, the broken suffix rotates
        to ``<segment_path>.corrupt`` (preserved, never deleted) and the
        file truncates to the valid prefix so later appends extend a
        well-formed segment. ``skip`` resumes past the records a snapshot
        already covers. Returns the number of blocks imported."""
        if not self.segment_path or not os.path.exists(self.segment_path):
            return 0
        self.wal_stopped_at = None
        imported, valid_bytes = 0, 0
        self._replaying = True
        self._wal_records = 0
        try:
            with open(self.segment_path, "rb") as f:
                for i, raw in enumerate(f):
                    if i < skip:
                        valid_bytes += len(raw)
                        self._wal_records += 1
                        continue
                    try:
                        blk = Block.from_json(json.loads(raw.decode()))
                    except (ValueError, KeyError, TypeError,
                            UnicodeDecodeError):
                        self.wal_stopped_at = self.height
                        break
                    status = self.import_block(blk)
                    if status in ("invalid", "orphan"):
                        # failed audit / broken linkage: the break is here
                        self.wal_stopped_at = self.height
                        break
                    valid_bytes += len(raw)
                    self._wal_records += 1
                    if status != "known":
                        imported += 1
                        self.stats["wal_replay_bytes"] += len(raw)
        finally:
            self._replaying = False
        if self.wal_stopped_at is not None:
            self._rotate_corrupt(valid_bytes)
        self.stats["wal_replayed"] += imported
        return imported

    def _rotate_corrupt(self, valid_bytes: int) -> None:
        """Corrupt-suffix rotation: the suffix past the last valid record
        moves to ``<path>.corrupt`` (appended, preserved) and the segment
        truncates to the intact prefix."""
        with open(self.segment_path, "rb") as f:
            data = f.read()
        with open(self.segment_path + ".corrupt", "ab") as f:
            f.write(data[valid_bytes:])
        with open(self.segment_path, "wb") as f:
            f.write(data[:valid_bytes])

    # -- durability: crash / snapshot / recover -------------------------------- #
    def wipe(self) -> None:
        """Process kill: ALL in-memory state drops — block tree, mempool,
        contract state, emit-once guards. The on-disk segment survives;
        ``recover()`` (disk replay, then peer catch-up) is the way back."""
        self._init_memory()
        self.wal_stopped_at = None
        self._wal_records = 0
        if self.executor is not None:
            self.executor.reset()

    def snapshot(self) -> ReplicaSnapshot:
        """Capture full replica + contract state as a frozen dataclass,
        keyed by ``contract.state_digest()``."""
        ex = self.executor
        contract = ex.contract if ex is not None else None
        return ReplicaSnapshot(
            node_id=self.node_id,
            state_digest=contract.state_digest() if contract is not None
            else "",
            head=self.head,
            seq=self._seq,
            wal_count=self._wal_records,
            blocks=tuple(json.dumps(b.to_json(), sort_keys=True)
                         for b in self.blocks.values()),
            mempool=tuple(json.dumps(t.to_json(), sort_keys=True)
                          for t in self.mempool.values()),
            my_txs=tuple(json.dumps(t.to_json(), sort_keys=True)
                         for t in self._my_txs.values()),
            onchain=tuple(sorted(self._onchain)),
            seen=tuple(sorted(ex._seen)) if ex is not None else (),
            contract_state=json.dumps(contract.snapshot_state(),
                                      sort_keys=True)
            if contract is not None else "")

    def restore_snapshot(self, snap: ReplicaSnapshot) -> None:
        """Rebuild in-memory state from a snapshot (no re-execution: the
        contract restores its raw state). Follow with
        ``replay_wal(skip=snap.wal_count)`` to apply the WAL suffix."""
        self.wipe()
        self._replaying = True      # snapshot blocks are already on disk
        try:
            for bj in snap.blocks:  # insertion order: parents first
                self._insert(Block.from_json(json.loads(bj)))
            self.head = snap.head
            self._seq = snap.seq
            for tj in snap.mempool:
                tx = _tx_from_json(json.loads(tj))
                self.mempool[tx.txid] = tx
            for tj in snap.my_txs:
                tx = _tx_from_json(json.loads(tj))
                self._my_txs[tx.txid] = tx
            self._onchain = set(snap.onchain)
            if self.executor is not None:
                self.executor._seen = set(snap.seen)
                if snap.contract_state:
                    self.executor.contract.restore_state(
                        json.loads(snap.contract_state))
        finally:
            self._replaying = False
        self._wal_records = snap.wal_count

    def recover(self, snapshot: Optional[ReplicaSnapshot] = None) -> int:
        """Restart path after ``wipe()``: restore the snapshot when given,
        then replay the WAL (suffix). Returns blocks replayed from disk."""
        if snapshot is not None:
            self.restore_snapshot(snapshot)
            return self.replay_wal(skip=snapshot.wal_count)
        return self.replay_wal()


def _tx_from_json(rec: Dict) -> Tx:
    return Tx(rec["sender"], rec["method"], rec["args"],
              rec.get("nonce", 0), rec.get("txid", ""))
