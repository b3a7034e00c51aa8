"""Contract execution adapter + the Ledger-API view over a replica.

``ContractExecutor`` makes ``UnifyFLContract`` execution *re-executable*: the
same chain always produces the same state, so a reorg can rebuild contract
state from genesis (``rebuild``) on any replica and converge byte-identically
(``contract.state_digest()``).

Two mechanisms make replay safe:

  * **deterministic reverts** — a tx whose handler raises ``PermissionError``
    (a contract revert) stays in its block but leaves no state; the revert is
    recorded in ``last_results`` so the local submitter still sees the
    exception, while remote replicas and replays skip it silently. Since the
    contract is deterministic, every replica reverts the same txs on the
    same chain.
  * **emit-once events** — a tx's events fire at most once per replica
    (keyed by txid), no matter how many times reorgs re-execute it. A
    rebuild therefore emits only for txs this replica has never executed
    (e.g. the other partition side's submissions arriving after a heal),
    never re-triggering scoring for history it already acted on.

``LedgerView`` is what orchestration code holds instead of the old ``Ledger``
singleton: the same API (submit / subscribe / verify / blocks / ...) bound to
*one silo's* replica — submit-via-local-replica, read-your-replica. During a
partition a view serves stale reads and its submissions seal on the local
fork; the heal reconciles via fork choice + re-execution.

``finalized_contract(k)`` adds finality-depth-aware reads: the contract
state of the canonical chain truncated ``k`` blocks below head, re-executed
into a muted shadow contract. A partition-heal reorg can rewrite at most
the last ``reorg-depth`` blocks — reads at ``k >= reorg-depth`` are
reorg-proof: nothing a consumer saw can be un-published. The shadow
executor is cached per depth and extended incrementally while the
finalized prefix only grows (the common case); a reorg deeper than ``k``
falls back to a genesis re-execution of the new prefix.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.chain.forkchoice import GENESIS


class ContractExecutor:
    def __init__(self, contract, subscribers: Optional[List[Callable]] = None):
        self.contract = contract
        self._subs: List[Callable[[str, Dict], None]] = \
            subscribers if subscribers is not None else []
        self._seen: Set[str] = set()
        self.last_results: Dict[str, Tuple[str, Any]] = {}
        self._mute = False
        # optional hook fired on a tx's *first* execution here (finality probe)
        self.on_exec: Optional[Callable[[str], None]] = None
        contract._emit = self._emit

    def subscribe(self, fn: Callable[[str, Dict], None]) -> None:
        self._subs.append(fn)

    def _emit(self, event: str, payload: Dict) -> None:
        if self._mute:
            return
        for fn in list(self._subs):
            fn(event, payload)

    def execute_block(self, blk) -> int:
        """Execute every tx of ``blk`` against the contract; returns the
        number of reverts. Never raises — reverts are part of the chain."""
        reverts = 0
        for tx in blk.txs:
            first = not tx.txid or tx.txid not in self._seen
            self._mute = not first
            try:
                self.last_results[tx.txid] = \
                    ("ok", self.contract.execute(tx, blk))
            except PermissionError as e:        # deterministic contract revert
                self.last_results[tx.txid] = ("revert", e)
                reverts += 1
            finally:
                self._mute = False
            if tx.txid:
                self._seen.add(tx.txid)
                if first and self.on_exec is not None:
                    self.on_exec(tx.txid)
        return reverts

    def reset(self) -> None:
        """Forget everything (process kill): contract back to genesis state,
        emit-once guards and cached tx results dropped. The next replay —
        from disk or from peers — re-emits events exactly once."""
        self.contract.reset()
        self._seen.clear()
        self.last_results.clear()

    def rebuild(self, chain) -> int:
        """Re-execute a whole canonical chain into a reset contract (the
        reorg path); emit-once guards keep already-delivered events quiet."""
        self.contract.reset()
        reverts = 0
        for blk in chain:
            reverts += self.execute_block(blk)
        return reverts


class LedgerView:
    """The Ledger API over one participant's chain replica."""

    def __init__(self, net, replica):
        self._net = net
        self.replica = replica
        # finality-read shadow executors: depth k -> (prefix head hash,
        # prefix length, executor). See finalized_contract.
        self._fin: Dict[int, Tuple[str, int, ContractExecutor]] = {}

    @property
    def node_id(self) -> str:
        return self.replica.node_id

    @property
    def contract(self):
        return self.replica.executor.contract

    @property
    def sealers(self) -> List[str]:
        return list(self.replica.sealers)

    @property
    def blocks(self):
        return self.replica.canonical()

    @property
    def head_hash(self) -> str:
        return self.replica.head

    @property
    def height(self) -> int:
        return self.replica.height

    @property
    def stats(self) -> Dict:
        return self.replica.stats

    def submit(self, sender: str, method: str, logical_time: float = 0.0,
               **args) -> Any:
        """Submit via the local replica: seals immediately (period=0) and
        broadcasts over the fabric; raises on a local contract revert."""
        return self._net.submit(self.replica, sender, method, args,
                                logical_time)

    def subscribe(self, fn: Callable[[str, Dict], None]) -> None:
        """Events from *this replica's* contract execution."""
        self.replica.executor.subscribe(fn)

    def finalized_contract(self, k: int):
        """Contract state of the canonical chain truncated ``k`` blocks
        below head — a read that no reorg shallower than ``k`` can rewrite.
        ``k <= 0`` returns the live head contract. The shadow contract is
        fully muted (no subscribers): finalized reads never re-trigger
        scoring or any other event-driven behaviour."""
        if k <= 0:
            return self.contract
        chain = self.replica.canonical()
        cut = chain[:max(0, len(chain) - k)]
        head = cut[-1].hash if cut else GENESIS
        cached = self._fin.get(k)
        if cached is not None and cached[0] == head:
            return cached[2].contract
        ex: Optional[ContractExecutor] = None
        suffix = cut
        if cached is not None:
            old_head, old_len, old_ex = cached
            # cached prefix still on the (longer) finalized prefix: execute
            # only the new suffix — the normal, incremental path
            if old_head == GENESIS:
                ex = old_ex
            elif old_len <= len(cut) and cut[old_len - 1].hash == old_head:
                ex, suffix = old_ex, cut[old_len:]
        if ex is None:
            # first read at this depth, or a reorg rewrote the finalized
            # prefix itself (deeper than k): rebuild from genesis
            ex = ContractExecutor(type(self.contract)(self.contract.mode),
                                  subscribers=[])
        for blk in suffix:
            ex.execute_block(blk)
        self._fin[k] = (head, len(cut), ex)
        return ex.contract

    def verify(self) -> bool:
        return self.replica.verify()

    def block_randomness(self, height: int = -1) -> int:
        return self.replica.block_randomness(height)
