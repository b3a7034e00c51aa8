"""Clique-style PoA sealing schedule (the paper's private-Ethereum consensus).

Geth's Clique engine rotates block authorship through the authorized sealer
set: the *in-turn* sealer of height ``h`` is ``sealers[h % n]`` and seals at
difficulty 2; any other authorized sealer may seal the same height
*out-of-turn* at difficulty 1. Chain weight is the sum of block difficulties,
so when a partition (or just concurrent submission) makes two sealers produce
competing blocks, the fork-choice rule deterministically prefers the branch
with more in-turn blocks — exactly the mechanism that lets every side of a
partition keep sealing and still converge after the heal.

We run with period=0 (seal on demand — the paper's testbed chain is private
and latency-bound, not spam-bound) and without Clique's recent-signer
exclusion window: a minority partition of one sealer must be able to keep
sealing alone, which the SIGNER_LIMIT rule would forbid.

``equivocating_twin`` builds the byzantine-sealer failure mode: a second,
salted block at the same height by the same sealer. Honest replicas count the
equivocation (``stats["equivocations_seen"]``) and let fork choice pick one
variant; the contract state machine converges either way.
"""
from __future__ import annotations

from typing import List

DIFF_IN_TURN = 2
DIFF_OUT_OF_TURN = 1


def in_turn_sealer(sealers: List[str], height: int) -> str:
    """The sealer whose turn it is at ``height`` (round-robin rotation)."""
    return sealers[height % len(sealers)]


def difficulty(sealers: List[str], height: int, sealer: str) -> int:
    """Clique difficulty weight of a block sealed by ``sealer`` at ``height``."""
    return DIFF_IN_TURN if sealer == in_turn_sealer(sealers, height) \
        else DIFF_OUT_OF_TURN


def validate_seal(sealers: List[str], blk) -> bool:
    """Seal validity: authorized sealer, difficulty matching the schedule."""
    if blk.sealer not in sealers:
        return False
    return blk.difficulty == difficulty(sealers, blk.height, blk.sealer)


def equivocating_twin(blk):
    """A second block at the same (sealer, height) with a different hash —
    the byzantine equivocation a Clique sealer could commit. Same parent,
    same txs (state converges whichever variant wins fork choice)."""
    twin = type(blk)(blk.height, blk.prev_hash, blk.sealer, list(blk.txs),
                     blk.logical_time, blk.difficulty, blk.salt + 1)
    twin.hash = twin.compute_hash()
    return twin
