"""Content-addressed store — the IPFS analogue (paper §2.4, §3.4.2).

Twin of ``repro.core.store``, in memory and without the WAN fabric
(ROADMAP.md: the net fabric path is a later slice). Properties kept from
IPFS: content addressing (CID = SHA-256 of canonical bytes), integrity
verification on fetch, immutability, per-node local blocks with peer
fetch-and-cache, and hosting store nodes on the aggregator machines
themselves.

The pytree codec is byte-compatible with the reference: its JSON header
holds the same ``str(PyTreeDef)`` and ``jax.tree_util.keystr`` strings, here
written without JAX, so equal params or envelopes give equal bytes and CIDs
in both packages.
"""
from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.obs.metrics import StatsView

CHUNK_BYTES = 1 << 20  # 1 MiB blocks, IPFS-style
DECODED_CACHE_MAX = 64  # CIDs kept in each node's decoded-model cache


# --------------------------------------------------------------------------- #
# Deterministic pytree codec (the reference's bytes, without JAX)
# --------------------------------------------------------------------------- #

def _treedef_body(t) -> str:
    """JAX's PyTreeDef repr body: dicts by sorted key, '*' per leaf."""
    if isinstance(t, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_body(t[k])}"
                               for k in sorted(t)) + "}"
    if t is None:
        return "None"
    return "*"


def treedef_str(t) -> str:
    """``str(jax.tree_util.tree_structure(t))`` for nested dicts."""
    return f"PyTreeDef({_treedef_body(t)})"


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a dict-key path: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def serialize_pytree(t) -> bytes:
    items = [(p, l) for p, l in tree.leaves_with_paths(t) if l is not None]
    arrs = [_as_numpy(l) for _, l in items]
    header = {
        "treedef": treedef_str(t),
        "leaves": [{"dtype": str(a.dtype), "shape": list(a.shape)} for a in arrs],
        "paths": [keystr(p) for p, _ in items],
    }
    hb = json.dumps(header, sort_keys=True).encode()
    out = [len(hb).to_bytes(8, "little"), hb]
    for a in arrs:
        out.append(np.ascontiguousarray(a).tobytes())
    return b"".join(out)


def deserialize_pytree(data: bytes, like=None):
    """If ``like`` (a params prototype) is given, rebuild its nested-dict
    structure with numpy leaves; otherwise return a flat dict path -> array."""
    hlen = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + hlen].decode())
    off = 8 + hlen
    arrs = []
    for spec in header["leaves"]:
        dt = np.dtype(spec["dtype"])
        n = int(np.prod(spec["shape"])) if spec["shape"] else 1
        nb = n * dt.itemsize
        a = np.frombuffer(data[off:off + nb], dtype=dt).reshape(spec["shape"])
        arrs.append(a)
        off += nb
    if like is not None:
        paths = [p for p, _ in tree.leaves_with_paths(like)]
        return tree.unflatten(paths, arrs)
    return dict(zip(header["paths"], arrs))


def compute_cid(data: bytes) -> str:
    return "bafy" + hashlib.sha256(data).hexdigest()


def _chunk(data: bytes) -> List[bytes]:
    """Split payload bytes into IPFS-style blocks."""
    return [data[i:i + CHUNK_BYTES]
            for i in range(0, len(data), CHUNK_BYTES)] or [b""]


# --------------------------------------------------------------------------- #
# Store nodes + network
# --------------------------------------------------------------------------- #

class StoreNode:
    """One per silo (hosted on the aggregator node, paper §3.4.2). Decoded
    models land on ``device``, the silo's compute device."""

    def __init__(self, node_id: str, device):
        self.node_id = node_id
        self.device = torch.device(device)
        self._blocks: Dict[str, List[bytes]] = {}
        self._peers: List["StoreNode"] = []
        self._lock = threading.Lock()
        # decoded-model cache, keyed (cid, resolved_base): a delta envelope's
        # decoded form depends on its base chain, so the base CID is part of
        # the identity; _decoded_cids indexes cid -> full key
        self._decoded: "OrderedDict[Tuple[str, str], Any]" = OrderedDict()
        self._decoded_cids: Dict[str, Tuple[str, str]] = {}
        self._wire_decoder: Optional[Callable] = None
        self.stats = StatsView("store", node_id)

    def wire_decoder(self) -> Callable:
        """Node-bound ``repro_torch.core.wire`` decoder: delta envelopes
        resolve their base chain through this node's decoded cache."""
        if self._wire_decoder is None:
            from repro_torch.core.wire import decode_store

            def _dec(flat):
                return decode_store(
                    flat, self.device,
                    resolver=lambda bcid: self.get_decoded(bcid, _dec))

            self._wire_decoder = _dec
        return self._wire_decoder

    # -- network wiring ---------------------------------------------------- #
    def connect(self, peer: "StoreNode"):
        if peer is not self and peer not in self._peers:
            self._peers.append(peer)

    # -- API ---------------------------------------------------------------- #
    def put(self, obj) -> str:
        data = serialize_pytree(obj) if not isinstance(obj, bytes) else obj
        cid = compute_cid(data)
        with self._lock:
            self._blocks[cid] = _chunk(data)
            self.stats["puts"] += 1
            self.stats["bytes_stored"] += len(data)
        return cid

    def has(self, cid: str) -> bool:
        return cid in self._blocks

    def read_local(self, cid: str) -> Optional[bytes]:
        """Local blocks only — never touches the network."""
        with self._lock:
            if cid in self._blocks:
                return b"".join(self._blocks[cid])
        return None

    def get_bytes(self, cid: str) -> bytes:
        data = self.read_local(cid)
        if data is not None:
            with self._lock:
                self.stats["gets"] += 1
            return data
        for peer in self._peers:   # instantaneous DHT-ish peer fetch
            if peer.has(cid):
                data = peer.get_bytes(cid)
                if compute_cid(data) != cid:  # integrity check
                    raise IOError(f"integrity failure fetching {cid} "
                                  f"from {peer.node_id}")
                with self._lock:
                    self._blocks[cid] = _chunk(data)
                    self.stats["peer_fetches"] += 1
                    self.stats["bytes_fetched"] += len(data)
                return data
        raise KeyError(f"CID {cid} not found on {self.node_id} or peers")

    def get(self, cid: str, like=None):
        return deserialize_pytree(self.get_bytes(cid), like)

    # -- decoded-model cache (lock held for both helpers) ------------------ #
    def _cache_lookup(self, cid: str):
        key = self._decoded_cids.get(cid)
        if key is None:
            return None
        self.stats["decode_hits"] += 1
        self._decoded.move_to_end(key)
        return self._decoded[key]

    def _cache_insert(self, cid: str, obj):
        key = (cid, getattr(obj, "base_cid", "") or "")
        self.stats["decodes"] += 1
        self._decoded[key] = obj
        self._decoded_cids[cid] = key
        while len(self._decoded) > DECODED_CACHE_MAX:
            (ecid, _), _ = self._decoded.popitem(last=False)
            self._decoded_cids.pop(ecid, None)

    def get_decoded(self, cid: str, decoder: Callable):
        """Fetch + ``decoder(payload)`` once per CID. Content addressing
        makes blocks immutable, so the decoded form (e.g. the packed int8
        payload of a peer model) is cached: a model pulled by k scorers and
        then for aggregation is deserialized once on this node
        (``stats['decodes']``); the other touches are ``decode_hits``."""
        with self._lock:
            hit = self._cache_lookup(cid)
            if hit is not None:
                return hit
        obj = decoder(self.get(cid))
        with self._lock:
            # decode ran unlocked: a concurrent miss may have won the race —
            # keep its object so all callers share one decoded model
            hit = self._cache_lookup(cid)
            if hit is not None:
                return hit
            self._cache_insert(cid, obj)
        return obj


class StoreNetwork:
    """Fully-connected private swarm of silo store nodes."""

    def __init__(self):
        self.nodes: Dict[str, StoreNode] = {}

    def add_node(self, node_id: str, device) -> StoreNode:
        node = StoreNode(node_id, device)
        for other in self.nodes.values():
            node.connect(other)
            other.connect(node)
        self.nodes[node_id] = node
        return node
