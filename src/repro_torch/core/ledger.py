"""PoA ledger — a thin facade over one ``repro_torch.chain`` replica.

Historically this module *was* the chain ("every silo holds a replica;
determinism guarantees agreement" — i.e. consensus assumed, never
exercised). The real thing now lives in ``repro_torch.chain``: per-silo
``ChainReplica``s, Clique in-turn/out-of-turn sealing, heaviest-chain fork
choice, block gossip over the WAN fabric, reorgs with deterministic contract
re-execution. ``Ledger`` remains as **single-replica mode** — one solo
replica impersonating the whole committee (sealing every height as the
in-turn sealer) — used when no network fabric is configured and by
direct-ledger tests/benchmarks. The public API is unchanged:

  - blocks are hash-chained and sealed round-robin by the authorized sealer
    set; transactions execute on the attached contract in block order, with
    event emissions delivered to subscribers;
  - the chain persists as JSONL and replays on restart — persistence now
    lives in the replica itself (``ChainReplica.segment_path`` /
    ``replay_wal``), shared with every replicated-mode replica: replay
    validates linkage + hashes as it loads and *stops at the first break*,
    rotating the broken suffix to ``<path>.corrupt`` and truncating the
    file to the valid prefix (a corrupt or missing record cannot smuggle
    history past the audit);
  - ``verify()`` re-checks the whole hash chain, seal schedule included;
  - 'on-chain randomness' derives from block hashes.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

from repro_torch.chain.adapter import ContractExecutor
from repro_torch.chain.replica import GENESIS, Block, ChainReplica, Tx

__all__ = ["Ledger", "Block", "Tx", "GENESIS"]


class Ledger:
    """Single logical chain: a solo ``ChainReplica`` behind the classic API."""

    def __init__(self, sealers: List[str], *, path: Optional[str] = None,
                 block_size: int = 16):
        if not sealers:
            raise ValueError("need at least one PoA sealer")
        self.sealers = list(sealers)
        self._replica = ChainReplica("ledger", sealers, solo=True,
                                     segment_path=path)
        self._subs: List[Callable[[str, Dict], None]] = []
        self._executor: Optional[ContractExecutor] = None
        self.path = path
        self.block_size = block_size
        self._lock = threading.RLock()
        if path and os.path.exists(path):
            # tree-only replay (no executor yet): ``replay_into`` re-executes
            self._replica.replay_wal()

    @property
    def replay_stopped_at(self) -> Optional[int]:
        """Height of the first broken on-disk record (None = intact)."""
        return self._replica.wal_stopped_at

    # -- wiring -------------------------------------------------------------- #
    @property
    def contract(self):
        return self._executor.contract if self._executor is not None else None

    def attach_contract(self, contract) -> None:
        self._executor = ContractExecutor(contract, subscribers=self._subs)
        self._replica.executor = self._executor

    def subscribe(self, fn: Callable[[str, Dict], None]) -> None:
        self._subs.append(fn)

    # -- chain ---------------------------------------------------------------- #
    @property
    def blocks(self) -> List[Block]:
        return self._replica.canonical()

    @property
    def pending(self) -> List[Tx]:
        return list(self._replica.mempool.values())

    @property
    def stats(self) -> Dict:
        return self._replica.stats

    @property
    def head_hash(self) -> str:
        return self._replica.head

    @property
    def height(self) -> int:
        return self._replica.height

    def submit(self, sender: str, method: str, logical_time: float = 0.0,
               **args) -> Any:
        """Submit a tx; seals immediately (Clique period=0) and the sealed
        block appends to the WAL before control returns. A contract revert
        raises to the caller — the block still stands (reverted txs are part
        of history and are skipped deterministically on replay)."""
        with self._lock:
            tx, blk, status, result = self._replica.submit(
                sender, method, args, logical_time)
            if status == "revert":
                raise result
            return result

    def seal(self, logical_time: float = 0.0) -> Optional[Block]:
        """Seal any pending txs into a block (no-op when the pool is empty)."""
        with self._lock:
            return self._replica.seal(logical_time)

    def block_randomness(self, height: int = -1) -> int:
        """Deterministic 'on-chain randomness' from a block hash."""
        return self._replica.block_randomness(height)

    def finalized_contract(self, k: int):
        """API parity with ``chain.LedgerView``: the contract state ``k``
        blocks below head. A solo chain never reorgs, so this is purely the
        same lag semantics, re-executed into a muted shadow contract."""
        if k <= 0 or self._executor is None:
            return self.contract
        live = self.contract
        shadow = ContractExecutor(type(live)(live.mode), subscribers=[])
        chain = self.blocks
        for blk in chain[:max(0, len(chain) - k)]:
            shadow.execute_block(blk)
        return shadow.contract

    def verify(self) -> bool:
        return self._replica.verify()

    # -- crash recovery -------------------------------------------------------- #
    def replay_into(self, contract) -> None:
        """Re-execute the whole loaded chain into a fresh contract (restart
        path); reverted txs are skipped deterministically."""
        self.attach_contract(contract)
        for blk in self.blocks:
            self._executor.execute_block(blk)
