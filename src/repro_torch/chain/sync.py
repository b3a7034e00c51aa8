"""Block gossip + catch-up over the WAN fabric: the chain's network plane.

``ChainNetwork`` owns one ``ChainReplica`` per participant and moves blocks
between them as *charged, cancellable fabric transfers* (traffic class
``"chain"``, foreground QoS — consensus messages are latency-critical and
small). Orchestration therefore experiences the network for real:

  * a sealed block broadcasts to every peer; peers behind a partition are
    simply unreachable (``stats["undeliverable"]``) — that is how forks are
    *born*, no extra machinery;
  * a block whose parent is unknown parks in the orphan pool and triggers a
    catch-up: a tiny request to the sender, answered with the missing
    ancestor batch in one charged transfer (late joiners / post-heal sync);
  * a replica that keeps its own head on import (the incoming branch lost
    fork choice) announces its head back to the sender — the minority side
    of a heal learns about the heavier chain without polling;
  * after any import, resurrected mempool txs re-seal on the new head and
    re-broadcast, so a reorged-away submission propagates to the winning
    chain automatically.

``resync()`` makes every replica announce its head to every peer — wired to
the fault injector's ``heal``/``up``/``restart`` actions, it is the "TCP
reconnect" that turns a healed partition into catch-up traffic and,
eventually, one head.

Catch-up requests carry a **locator** (the requester's canonical-chain
hashes at exponentially spaced heights, bitcoin-style): the server walks
ancestors of the orphaned block only until it hits a hash the requester
already has, so a replica that recovered most of its chain from its local
WAL segment pays peers only for the *gap* — recovery cost on the wire is
proportional to what was missed, not to chain length. A requester whose
chain diverged (fork) misses every locator hash and falls back to the full
bounded batch, exactly as before.

``kill`` / ``restart`` are the crash-durability hooks (``net.faults``):
kill drops a replica's entire in-memory state (the WAL segment survives on
disk), restart replays the segment — charged ZERO fabric bytes — and the
follow-up ``resync()`` closes the remaining gap as charged transfers.

With ``fabric=None`` delivery is synchronous and free (unit tests /
single-process replication).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.chain.adapter import ContractExecutor, LedgerView
from repro_torch.chain.replica import (GENESIS, Block, ChainReplica,
                                       ReplicaSnapshot)
from repro_torch.chain import sealer as sealing
from repro_torch.obs import events as obsev
from repro_torch.obs.metrics import StatsView
from repro_torch.obs.tracer import NULL_TRACER

REQUEST_NBYTES = 96          # a catch-up request is one tiny control message
LOCATOR_HASH_NBYTES = 64     # each locator entry is one hex block hash
MAX_CATCHUP = 512            # ancestor batch bound per catch-up response


class ChainNetwork:
    def __init__(self, env, fabric=None, *, sealers: List[str]):
        self.env = env
        self.fabric = fabric
        self.sealers = list(sealers)
        self.replicas: Dict[str, ChainReplica] = {}
        self.views: Dict[str, LedgerView] = {}
        self._announced: Set[Tuple[str, str, str]] = set()
        # finality probes: txid -> submit time / txid -> {node: first-exec time}
        self.tx_submit_t: Dict[str, float] = {}
        self.tx_exec_t: Dict[str, Dict[str, float]] = {}
        self.stats = StatsView("chain_net")
        self._kill_t: Dict[str, float] = {}   # node -> sim time of last kill
        # head-change listeners (light-client hub): fn(node_id, head_block)
        self._head_listeners: List[Any] = []
        self._last_head: Dict[str, str] = {}
        # sorted-membership memo: broadcast/resync iterate peers in sorted
        # order for determinism, and re-sorting per sealed block is
        # O(n log n) x blocks at thousand-replica scale
        self._peer_order: Tuple[str, ...] = ()

    def _sorted_replicas(self) -> Tuple[str, ...]:
        if len(self._peer_order) != len(self.replicas):
            self._peer_order = tuple(sorted(self.replicas))
        return self._peer_order

    # -- head announcements (light clients) ----------------------------------- #
    def subscribe_heads(self, fn) -> None:
        """``fn(node_id, head_block)`` fires whenever a replica's canonical
        head *changes* (seal, import, catch-up, restart) — the light-client
        hub's announcement source (``repro_torch.chain.light``)."""
        self._head_listeners.append(fn)

    def _notify_head(self, node_id: str) -> None:
        if not self._head_listeners:
            return
        rep = self.replicas.get(node_id)
        if rep is None or rep.head == GENESIS \
                or self._last_head.get(node_id) == rep.head:
            return
        self._last_head[node_id] = rep.head
        blk = rep.blocks[rep.head]
        for fn in self._head_listeners:
            fn(node_id, blk)

    # -- membership ---------------------------------------------------------- #
    def add_replica(self, node_id: str, contract, *,
                    byzantine: Optional[str] = None,
                    segment_path: Optional[str] = None) -> LedgerView:
        ex = ContractExecutor(contract)
        ex.on_exec = lambda txid, nid=node_id: \
            self.tx_exec_t.setdefault(txid, {}).__setitem__(nid, self._now())
        rep = ChainReplica(node_id, self.sealers, executor=ex,
                           byzantine=byzantine, segment_path=segment_path)
        rep.replay_wal()        # cold start from an existing segment (rejoin)
        self.replicas[node_id] = rep
        if self.fabric is not None:
            self.fabric.register_node(node_id)
        view = LedgerView(self, rep)
        self.views[node_id] = view
        return view

    # -- crash / restart ------------------------------------------------------ #
    def kill(self, node_id: str) -> None:
        """Process kill: the replica's entire in-memory state drops (block
        tree, mempool, contract state, emit-once guards); its WAL segment
        survives on disk. In-flight transfers touching the node are the
        fabric's job (``node_down`` cancels them — the ``kill`` fault action
        does both)."""
        self.replicas[node_id].wipe()
        self.stats["kills"] += 1
        self._kill_t[node_id] = self._now()
        if self.env is not None:
            self.env.emit(obsev.chain_kill(node_id))

    def restart(self, node_id: str, *,
                snapshot: Optional[ReplicaSnapshot] = None) -> int:
        """Crash recovery: re-construct the replica from its local WAL
        segment (snapshot + WAL suffix when a snapshot is supplied) —
        measured and asserted to charge ZERO fabric bytes — then let the
        caller ``resync()`` so peers serve the remaining gap as charged
        catch-up transfers. Returns blocks replayed from disk."""
        bytes_before = self.fabric.stats["bytes"] if self.fabric else 0
        n = self.replicas[node_id].recover(snapshot=snapshot)
        self.stats["restarts"] += 1
        self.stats["wal_replayed"] += n
        self.stats["restart_fabric_bytes"] += \
            (self.fabric.stats["bytes"] if self.fabric else 0) - bytes_before
        if self.env is not None:
            self.env.emit(obsev.chain_restart(node_id, n))
            tr = self.env.tracer
            t_kill = self._kill_t.pop(node_id, None)
            if tr.enabled and t_kill is not None:
                # the kill -> restart outage, on the node's chain track
                tr.span_at("phase.recovery", f"{node_id}/chain",
                           t_kill, self._now(), wal_blocks=n)
        self._notify_head(node_id)
        return n

    def _now(self) -> float:
        return self.env.now if self.env is not None else 0.0

    @property
    def _tracer(self):
        return self.env.tracer if self.env is not None else NULL_TRACER

    # -- submission ---------------------------------------------------------- #
    def submit(self, replica: ChainReplica, sender: str, method: str,
               args: Dict, logical_time: float) -> Any:
        tx, blk, status, result = replica.submit(sender, method, args,
                                                 logical_time)
        self.tx_submit_t[tx.txid] = self._now()
        if blk is not None:
            self.broadcast(replica.node_id, blk)
        if status == "revert":
            raise result
        return result

    # -- block plane --------------------------------------------------------- #
    def broadcast(self, src: str, blk: Block) -> None:
        rep = self.replicas[src]
        twin = None
        if rep.byzantine == "equivocate":
            twin = sealing.equivocating_twin(blk)
            rep.import_block(twin)      # the equivocator knows both variants
            self.stats["equivocations_sent"] += 1
        tr = self._tracer
        if tr.enabled:
            tr.event("chain.seal", f"{src}/chain", self._now(),
                     hash=blk.hash[:12], height=blk.height)
        peers = [p for p in self._sorted_replicas() if p != src]
        for i, peer in enumerate(peers):
            send = twin if (twin is not None and i % 2 == 1) else blk
            self._send_block(src, peer, send)
        self.stats["broadcasts"] += 1
        self._notify_head(src)

    def _transfer(self, src: str, dst: str, label: str, nbytes: int,
                  on_land, key) -> None:
        """One chain-plane move: synchronous and free without a fabric,
        otherwise a charged, cancellable ``"chain"``-class transfer.
        Unreachable peers count as ``undeliverable`` — the seed of a fork.
        ``src`` is part of every key: during resync several replicas can
        send the same block to one dst concurrently, and the transfers must
        stay independently cancellable on churn."""
        if self.fabric is None:
            on_land()
            return
        from repro_torch.net.fabric import UnreachableError
        try:
            self.fabric.transfer_async(src, dst, label, nbytes, on_land,
                                       kind="chain", key=key)
        except UnreachableError:
            self.stats["undeliverable"] += 1

    def _send_block(self, src: str, dst: str, blk: Block) -> None:
        key = ("chain", src, dst, blk.hash)
        if self.fabric is not None and self.fabric.in_flight(key):
            # this exact block is already on the wire to dst: SimEnv keys
            # hold ONE live event (cancel-and-replace), so re-sending would
            # charge the lane again and deliver *later* than the transfer it
            # replaced
            return
        self._transfer(src, dst, f"blk:{blk.hash[:12]}", blk.nbytes(),
                       lambda: self._deliver(dst, src, blk), key)

    def _deliver(self, dst: str, src: str, blk: Block) -> None:
        rep = self.replicas.get(dst)
        if rep is None:
            return
        self.stats["delivered"] += 1
        tr = self._tracer
        reorgs_before = rep.stats["reorgs"] if tr.enabled else 0
        status = rep.import_block(blk)
        if tr.enabled:
            tr.event("chain.import", f"{dst}/chain", self._now(),
                     status=status, src=src, hash=blk.hash[:12],
                     height=blk.height)
            if rep.stats["reorgs"] > reorgs_before:
                tr.event("chain.reorg", f"{dst}/chain", self._now(),
                         depth=rep.stats["max_reorg_depth"],
                         head=rep.head[:12])
        if status == "orphan":
            self._request_catchup(dst, src, blk)
        elif status == "side":
            # incoming branch lost: tell the sender about our heavier head
            self._announce_head(dst, src)
        self._post_import(dst)
        self._notify_head(dst)

    def _post_import(self, dst: str) -> None:
        """Resurrected txs (reorg) re-seal on the new head and propagate;
        freshly observed equivocation proofs go on-chain as slashing txs."""
        rep = self.replicas[dst]
        if rep.mempool and rep.can_seal:
            blk = rep.seal(self._now())
            if blk is not None:
                self.broadcast(dst, blk)
        self._report_equivocations(dst)

    def _report_equivocations(self, dst: str) -> None:
        """Any replica that imported two conflicting headers for the same
        (sealer, height) auto-submits ``tx_report_equivocation`` carrying
        both headers — the contract verifies the proof and slashes the
        sealer's reputation once per (sealer, height); replicas racing to
        report the same twin are contract-level no-ops, not reverts. A
        replica never reports *its own* equivocation (an actively byzantine
        sealer would otherwise equivocate on the report block too — each
        self-report spawning a fresh proof one height up, forever; honest
        peers see both variants and report it anyway), and skips proofs its
        contract already settled."""
        rep = self.replicas[dst]
        settled = getattr(rep.executor.contract, "equivocation_reports",
                          {}) if rep.executor is not None else {}
        for a, b in rep.drain_equivocation_proofs():
            if a.sealer == dst or f"{a.sealer}@{a.height}" in settled:
                continue
            self.stats["equivocation_reports"] += 1
            if self.env is not None:
                self.env.emit(obsev.equivocation_report(dst, a.sealer,
                                                        a.height))
            try:
                self.submit(rep, dst, "report_equivocation",
                            {"header_a": a.to_json(),
                             "header_b": b.to_json()}, self._now())
            except PermissionError:
                pass  # malformed pair on this replica's view: drop, no crash

    def _announce_head(self, dst: str, src: str) -> None:
        rep = self.replicas[dst]
        if rep.head == GENESIS:
            return
        key = (dst, src, rep.head)
        if key in self._announced:
            return
        self._announced.add(key)
        self.stats["head_announces"] += 1
        self._send_block(dst, src, rep.blocks[rep.head])

    # -- catch-up ------------------------------------------------------------- #
    def _locator(self, node_id: str) -> List[str]:
        """The requester's canonical-chain hashes at exponentially spaced
        heights below its head (dense for the most recent 8): the catch-up
        server stops at the first hash the requester already has, so the
        response covers the *gap*, not the whole chain."""
        rep = self.replicas[node_id]
        chain = rep.canonical()
        out: List[str] = []
        i, step = len(chain) - 1, 1
        while i >= 0:
            out.append(chain[i].hash)
            i -= step
            if len(out) >= 8:
                step *= 2
        return out

    def _request_catchup(self, dst: str, src: str, blk: Block) -> None:
        self.stats["catchup_requests"] += 1
        tr = self._tracer
        if tr.enabled:
            tr.event("chain.catchup-request", f"{dst}/chain", self._now(),
                     peer=src, orphan=blk.hash[:12])
        locator = self._locator(dst)
        nbytes = REQUEST_NBYTES + LOCATOR_HASH_NBYTES * len(locator)
        self._transfer(dst, src, f"req:{blk.hash[:12]}", nbytes,
                       lambda: self._serve_catchup(src, dst, blk, locator),
                       ("chainreq", src, dst, blk.hash))

    def _serve_catchup(self, src: str, dst: str, blk: Block,
                       locator: Sequence[str] = ()) -> None:
        """``src`` answers with the ancestors of the orphaned block it holds
        (oldest first, bounded), stopping early at any locator hash the
        requester advertised — a WAL-recovered replica is served only the
        blocks sealed while it was down. A diverged requester (fork) misses
        every locator hash until the common prefix and gets the full
        bounded batch; the orphan pool connects it on arrival."""
        rep = self.replicas.get(src)
        if rep is None:
            return
        have = set(locator)
        batch: List[Block] = []
        cur = blk.prev_hash
        while cur != GENESIS and cur in rep.blocks and cur not in have \
                and len(batch) < MAX_CATCHUP:
            batch.append(rep.blocks[cur])
            cur = rep.blocks[cur].prev_hash
        if not batch:
            return
        batch.reverse()
        self.stats["catchup_blocks"] += len(batch)
        tr = self._tracer
        if tr.enabled:
            tr.event("chain.catchup-serve", f"{src}/chain", self._now(),
                     peer=dst, n=len(batch))
        self._transfer(src, dst, f"chain:{blk.hash[:12]}",
                       sum(b.nbytes() for b in batch),
                       lambda: self._deliver_batch(dst, src, batch),
                       ("chainresp", src, dst, blk.hash))

    def _deliver_batch(self, dst: str, src: str, batch: List[Block]) -> None:
        rep = self.replicas.get(dst)
        if rep is None:
            return
        tr = self._tracer
        if tr.enabled:
            tr.event("chain.catchup-import", f"{dst}/chain", self._now(),
                     src=src, n=len(batch))
        for b in batch:
            rep.import_block(b)
        # a truncated batch (divergence deeper than MAX_CATCHUP) parks whole
        # in the orphan pool: iterate — request the next, older ancestor
        # span below the batch's root so deep syncs make progress
        oldest = batch[0]
        if oldest.hash not in rep.blocks:
            self._request_catchup(dst, src, oldest)
        self._post_import(dst)
        # heads may still disagree (ours was heavier): tell the peer once
        self._announce_head(dst, src)
        self._notify_head(dst)

    # -- reconciliation / introspection --------------------------------------- #
    def resync(self) -> None:
        """Every replica announces its head to every peer (heal/up hook)."""
        for nid in self._sorted_replicas():
            rep = self.replicas[nid]
            if rep.head == GENESIS:
                continue
            blk = rep.blocks[rep.head]
            for peer in self._sorted_replicas():
                if peer != nid:
                    self._send_block(nid, peer, blk)

    def heads(self) -> Dict[str, str]:
        return {nid: rep.head for nid, rep in self.replicas.items()}

    def converged(self, only_up: bool = True) -> bool:
        """One canonical head across replicas (down nodes excluded when the
        fabric knows about churn and ``only_up``)."""
        heads = set()
        for nid, rep in self.replicas.items():
            if only_up and self.fabric is not None \
                    and not self.fabric.is_up(nid):
                continue
            heads.add(rep.head)
        return len(heads) <= 1

    def state_digests(self, only_up: bool = True) -> Dict[str, str]:
        out = {}
        for nid, rep in self.replicas.items():
            if only_up and self.fabric is not None \
                    and not self.fabric.is_up(nid):
                continue
            out[nid] = rep.executor.contract.state_digest()
        return out

    def finality(self) -> List[float]:
        """Per-tx finality latency: submit -> executed on *every* replica
        (only txs that reached all replicas count)."""
        n = len(self.replicas)
        out = []
        for txid, execs in self.tx_exec_t.items():
            t0 = self.tx_submit_t.get(txid)
            if t0 is not None and len(execs) == n:
                out.append(max(execs.values()) - t0)
        return out

    def totals(self, key: str) -> int:
        return sum(rep.stats[key] for rep in self.replicas.values())
