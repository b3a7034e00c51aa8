"""Deterministic Merkle transaction trees for block headers.

Every sealed block commits to its transaction list through a Merkle root
carried in the header (``Block.tx_root``): leaves are the sha256 of each
tx's canonical JSON, interior nodes hash their children pairwise, and an
odd node is *promoted* unchanged to the next level (no duplicate-last —
promotion keeps one tx list per root). Leaf and node hashes are
domain-separated (``\\x00`` / ``\\x01`` prefixes) so an interior node can
never be replayed as a leaf.

Because the header hash covers the root (not the raw tx list), a client
that holds only headers can verify "tx T is in block B" from a
logarithmic sibling path — the foundation of ``repro_torch.chain.light``.
Proofs are JSON-friendly: a list of ``[direction, sibling_hash]`` pairs,
``"L"`` meaning the sibling sits left of the running hash.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Sequence, Tuple

# root of the empty tx list (a sealed block always carries >=1 tx, but the
# constant keeps merkle_root total — and tested)
EMPTY_ROOT = hashlib.sha256(b"\x02empty").hexdigest()

_LEAF = b"\x00"
_NODE = b"\x01"


def tx_leaf(tx_json: Dict) -> str:
    """Leaf hash of one transaction's canonical (sorted-key) JSON."""
    body = json.dumps(tx_json, sort_keys=True).encode()
    return hashlib.sha256(_LEAF + body).hexdigest()


def _node(left: str, right: str) -> str:
    return hashlib.sha256(_NODE + left.encode() + right.encode()).hexdigest()


def merkle_root(leaves: Sequence[str]) -> str:
    """Root of a leaf-hash list; odd nodes promote unchanged."""
    if not leaves:
        return EMPTY_ROOT
    level = list(leaves)
    while len(level) > 1:
        nxt = [_node(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def tx_root(txs_json: Sequence[Dict]) -> str:
    """Header root over a block's transaction list (canonical JSON)."""
    return merkle_root([tx_leaf(t) for t in txs_json])


def merkle_proof(leaves: Sequence[str], index: int) -> List[Tuple[str, str]]:
    """Sibling path proving ``leaves[index]`` is under ``merkle_root(leaves)``.

    Returns ``[(direction, sibling_hash), ...]`` bottom-up; a promoted odd
    node contributes no path element at that level."""
    if not 0 <= index < len(leaves):
        raise IndexError(f"leaf index {index} out of range ({len(leaves)})")
    proof: List[Tuple[str, str]] = []
    level, i = list(leaves), index
    while len(level) > 1:
        odd = len(level) % 2
        if not (odd and i == len(level) - 1):   # promoted node: no sibling
            if i % 2 == 0:
                proof.append(("R", level[i + 1]))
            else:
                proof.append(("L", level[i - 1]))
        nxt = [_node(level[j], level[j + 1])
               for j in range(0, len(level) - 1, 2)]
        if odd:
            nxt.append(level[-1])
        level, i = nxt, i // 2
    return proof


def verify_proof(leaf: str, proof: Sequence[Sequence[str]],
                 root: str) -> bool:
    """Fold a sibling path from ``leaf`` and compare against ``root``.

    ``proof`` entries may be tuples or (JSON round-tripped) 2-lists."""
    h = leaf
    for step in proof:
        direction, sibling = step[0], step[1]
        if direction == "L":
            h = _node(sibling, h)
        elif direction == "R":
            h = _node(h, sibling)
        else:
            return False
    return h == root
