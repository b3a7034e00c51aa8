"""Heaviest-chain fork choice with a deterministic tie-break.

A replica's canonical head is the block tree tip with the greatest total
difficulty (sum of Clique difficulty weights along the chain, see
``sealer.py``); ties break toward the lexicographically smallest head hash.
The order is *strict and global*: any two replicas holding the same block set
pick the same head, which is what makes post-partition convergence a pure
function of block dissemination (no extra agreement round needed). Note the
tie-break must be applied even against a replica's *own* current head —
"prefer what I already have" on ties would leave two replicas parked on
different equal-weight heads forever.

Functions take the replica's block-tree protocol: ``_td`` (hash -> cumulative
difficulty), ``_height`` (hash -> height), ``blocks`` (hash -> Block).

``GENESIS`` lives here (the leaf module) and is imported everywhere else —
it is load-bearing in the tie-break guards below.
"""
from __future__ import annotations

GENESIS = "genesis"


def total_difficulty(replica, h: str) -> int:
    return replica._td[h]


def better(replica, a: str, b: str) -> bool:
    """Strict total order over chain tips: is ``a`` preferable to ``b``?"""
    ta, tb = replica._td[a], replica._td[b]
    if ta != tb:
        return ta > tb
    if a == b:
        return False
    if b == GENESIS:
        return True
    if a == GENESIS:
        return False
    return a < b


def common_ancestor(replica, a: str, b: str) -> str:
    """Deepest block on both branches (``GENESIS`` when fully disjoint)."""
    ha = replica._height[a]
    hb = replica._height[b]
    while ha > hb:
        a = replica.blocks[a].prev_hash
        ha -= 1
    while hb > ha:
        b = replica.blocks[b].prev_hash
        hb -= 1
    while a != b:
        a = replica.blocks[a].prev_hash
        b = replica.blocks[b].prev_hash
    return a
