"""Content-addressed store — the IPFS analogue (paper §2.4, §3.4.2).

Twin of ``repro.core.store``. Properties kept from IPFS: content
addressing (CID = SHA-256 of canonical bytes), integrity verification on
fetch, immutability, per-node local blocks with peer fetch-and-cache
(DHT-like), pinning, and hosting store nodes on the aggregator machines
themselves.

With a ``repro_torch.net.NetFabric`` attached, peer fetches stop being free:
the provider is chosen DHT-style from the fabric's records (nearest
reachable replica, not always the origin), the transfer is charged
simulated time on the (src, dst) link, and per-node accounting lands in
``stats`` (``bytes_in`` / ``bytes_out`` / ``fetch_time`` / ``replica_hits``
/ ``prefetch_hits``). ``drain_transfer_time`` hands the accumulated charge
to the orchestrator so WAN time enters the simulated clock. Decoded models
land on the node's ``device`` (the silo's compute device), also when a
prefetch warms the cache from a simulated-time event. A node keeps each
CID's payload as one ``bytes``; the fabric counts its blocks from the
length.

The pytree codec is byte-compatible with the reference: its JSON header
holds the same ``str(PyTreeDef)`` and ``jax.tree_util.keystr`` strings, here
written without JAX, so equal params or envelopes give equal bytes and CIDs
in both packages. A bfloat16 leaf is written as its 16 bits under the dtype
name ``bfloat16`` (numpy's ``ml_dtypes`` name, which the reference writes)
and read back as a bfloat16 tensor: numpy has no bfloat16 of its own.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.obs.metrics import StatsView

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


BF16 = "bfloat16"


def _as_numpy(leaf) -> Tuple[str, np.ndarray]:
    """(the leaf's dtype name, a host array of its bytes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return BF16, t.view(torch.int16).numpy()
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return str(a.dtype), a


def serialize_pytree(t) -> bytes:
    items = [(p, l) for p, l in tree.leaves_with_paths(t) if l is not None]
    arrs = [_as_numpy(l) for _, l in items]
    header = {
        "treedef": treedef_str(t),
        "leaves": [{"dtype": dt, "shape": list(a.shape)} for dt, a in arrs],
        "paths": [keystr(p) for p, _ in items],
    }
    hb = json.dumps(header, sort_keys=True).encode()
    out = [len(hb).to_bytes(8, "little"), hb]
    for _, a in arrs:
        out.append(memoryview(np.ascontiguousarray(a)))
    return b"".join(out)


def deserialize_pytree(data: bytes, like=None):
    """If ``like`` (a params prototype) is given, rebuild its nested-dict
    structure with numpy leaves; otherwise return a flat dict path -> array."""
    hlen = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + hlen].decode())
    off = 8 + hlen
    arrs = []
    for spec in header["leaves"]:
        bf16 = spec["dtype"] == BF16
        dt = np.dtype(np.int16 if bf16 else spec["dtype"])
        n = int(np.prod(spec["shape"])) if spec["shape"] else 1
        nb = n * dt.itemsize
        a = np.frombuffer(data, dtype=dt, count=n, offset=off
                          ).reshape(spec["shape"])
        arrs.append(torch.from_numpy(a.copy()).view(torch.bfloat16)
                    if bf16 else a)
        off += nb
    if like is not None:
        paths = [p for p, _ in tree.leaves_with_paths(like)]
        return tree.unflatten(paths, arrs)
    return dict(zip(header["paths"], arrs))


def store_tensor(leaf) -> torch.Tensor:
    """A deserialized leaf (a numpy array, or a bfloat16 tensor) as a CPU
    tensor of its own."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))


def compute_cid(data: bytes) -> str:
    return "bafy" + hashlib.sha256(data).hexdigest()


# --------------------------------------------------------------------------- #
# Store nodes + network
# --------------------------------------------------------------------------- #


class StoreNode:
    """One per silo (hosted on the aggregator node, paper §3.4.2). Decoded
    models land on ``device``, the silo's compute device."""

    def __init__(self, node_id: str, device, root: Optional[str] = None):
        self.node_id = node_id
        self.device = torch.device(device)
        self.root = root
        self.network: Optional["StoreNetwork"] = None
        self._blocks: Dict[str, bytes] = {}
        self._pins: set = set()
        self._peers: List["StoreNode"] = []
        self._lock = threading.Lock()
        # decoded-model cache, keyed (cid, resolved_base): a delta envelope's
        # decoded form depends on its base chain, so the base CID is part of
        # the identity; _decoded_cids indexes cid -> full key (1:1 — content
        # addressing fixes the base a cid resolves against)
        self._decoded: "OrderedDict[Tuple[str, str], Any]" = OrderedDict()
        self._decoded_cids: Dict[str, Tuple[str, str]] = {}
        self._wire_decoder: Optional[Callable] = None
        self._prefetched: set = set()
        self._pending_net_time = 0.0
        self.stats = StatsView("store", node_id)
        if root:
            os.makedirs(root, exist_ok=True)

    @property
    def fabric(self):
        return self.network.fabric if self.network is not None else None

    def wire_decoder(self) -> Callable:
        """Node-bound ``repro_torch.core.wire`` decoder: delta envelopes
        resolve their base chain through this node's decoded cache, fetching
        missing base CIDs over the fabric like any other content."""
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
    def put(self, obj, *, pin: bool = True) -> str:
        data = serialize_pytree(obj) if not isinstance(obj, bytes) else obj
        cid = compute_cid(data)
        with self._lock:
            self._blocks[cid] = data
            if pin:
                self._pins.add(cid)
            self.stats["puts"] += 1
            self.stats["bytes_stored"] += len(data)
        if self.root:
            with open(os.path.join(self.root, cid), "wb") as f:
                f.write(data)
        fab = self.fabric
        if fab is not None:
            fab.publish(cid, self.node_id, len(data))
        return cid

    def has(self, cid: str) -> bool:
        return cid in self._blocks or bool(
            self.root and os.path.exists(os.path.join(self.root, cid)))

    def read_local(self, cid: str) -> Optional[bytes]:
        """Local blocks / disk only — never touches the network."""
        with self._lock:
            if cid in self._blocks:
                return self._blocks[cid]
        if self.root:
            p = os.path.join(self.root, cid)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    return f.read()
        return None

    def serve_bytes(self, cid: str) -> Optional[bytes]:
        """Serve a block set to a remote peer (counts egress accounting)."""
        data = self.read_local(cid)
        if data is not None:
            with self._lock:
                self.stats["gets"] += 1
                self.stats["bytes_out"] += len(data)
        return data

    def ingest(self, cid: str, data: bytes, *, prefetched: bool = False):
        """Store pushed/fetched bytes locally (gossip replica or prefetch
        landing). Verifies content addressing; no-op if already present."""
        if compute_cid(data) != cid:
            raise IOError(f"integrity failure ingesting {cid} on "
                          f"{self.node_id}")
        with self._lock:
            if cid not in self._blocks:
                self._blocks[cid] = data
                self.stats["bytes_in"] += len(data)
                # a demand fetch that raced us in already paid for these
                # bytes — only a genuinely landing prefetch earns the credit
                if prefetched:
                    self._prefetched.add(cid)
        fab = self.fabric
        if fab is not None:
            fab.add_provider(cid, self.node_id)

    def drain_transfer_time(self) -> float:
        """Simulated seconds of WAN transfer accumulated since the last
        drain; the orchestrator folds this into its scheduled durations."""
        with self._lock:
            t, self._pending_net_time = self._pending_net_time, 0.0
        return t

    def get_bytes(self, cid: str) -> bytes:
        data = self.read_local(cid)
        if data is not None:
            with self._lock:
                self.stats["gets"] += 1
            return data
        fab = self.fabric
        if fab is not None:
            return self._fetch_via_fabric(cid, fab)
        for peer in self._peers:   # no fabric: instantaneous DHT-ish fetch
            if peer.has(cid):
                data = peer.get_bytes(cid)
                if compute_cid(data) != cid:  # integrity check
                    raise IOError(f"integrity failure fetching {cid} "
                                  f"from {peer.node_id}")
                with self._lock:
                    self._blocks[cid] = data
                    self.stats["peer_fetches"] += 1
                    self.stats["bytes_fetched"] += len(data)
                return data
        raise KeyError(f"CID {cid} not found on {self.node_id} or peers")

    def _fetch_via_fabric(self, cid: str, fab) -> bytes:
        """Pull over the WAN fabric: nearest reachable replica, integrity
        check, link-time charge, replica/reroute accounting."""
        from repro_torch.net.fabric import UnreachableError
        tried: tuple = ()
        while True:
            src_id = fab.best_provider(self.node_id, cid, exclude=tried)
            if src_id is None:
                if fab.has_unreachable_provider(self.node_id, cid,
                                                exclude=tried):
                    raise UnreachableError(
                        f"CID {cid} unreachable from {self.node_id}: every "
                        f"provider is partitioned away or down")
                raise KeyError(f"CID {cid} not found on {self.node_id} "
                               f"or any reachable provider")
            peer = self.network.nodes.get(src_id) if self.network else None
            data = peer.serve_bytes(cid) if peer is not None else None
            if data is None:
                # stale provider record (gc'd or dropped node)
                fab.drop_provider(cid, src_id)
                tried = tried + (src_id,)
                continue
            if compute_cid(data) != cid:
                raise IOError(f"integrity failure fetching {cid} "
                              f"from {src_id}")
            origin = fab.origin(cid)
            if src_id == origin:
                kind = "fetch"
            elif origin is not None and \
                    not fab.reachable(self.node_id, origin):
                kind = "reroute"     # failover: origin gone, replica serves
            else:
                kind = "replica"     # replica was simply nearer
            charged = fab.transfer(src_id, self.node_id, cid, len(data),
                                   kind=kind)
            with self._lock:
                self._blocks[cid] = data
                self.stats["peer_fetches"] += 1
                self.stats["bytes_fetched"] += len(data)
                self.stats["bytes_in"] += len(data)
                self.stats["fetch_time"] += charged
                self._pending_net_time += charged
                if kind != "fetch":
                    self.stats["replica_hits"] += 1
            fab.add_provider(cid, self.node_id)
            return data

    def get(self, cid: str, like=None):
        return deserialize_pytree(self.get_bytes(cid), like)

    # -- decoded-model cache (lock held for both helpers) ------------------ #
    def _cache_lookup(self, cid: str):
        """Hit path: returns the cached object or None (updates stats)."""
        key = self._decoded_cids.get(cid)
        if key is None:
            return None
        self.stats["decode_hits"] += 1
        if cid in self._prefetched:
            # one hit per prefetched CID: "the prefetch was useful"
            self.stats["prefetch_hits"] += 1
            self._prefetched.discard(cid)
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
            self._prefetched.discard(ecid)

    def get_decoded(self, cid: str, decoder: Callable):
        """Fetch + ``decoder(payload)`` once per CID. Content addressing
        makes blocks immutable, so the decoded form (e.g. the packed int8
        payload of a peer model) is cached: a model pulled by k scorers and
        then for aggregation is deserialized once on this node
        (``stats['decodes']``); the other touches are ``decode_hits``.
        Bounded LRU keyed on ``(cid, resolved_base)``."""
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

    def has_decoded(self, cid: str) -> bool:
        with self._lock:
            return cid in self._decoded_cids

    def warm_decoded(self, cid: str, decoder: Callable):
        """Prefetch landing: decode a locally-present CID into the cache (on
        the node's device) and mark it, so the eventual consumer's hit
        counts as a prefetch hit. If something already decoded it, leave the
        attribution alone."""
        with self._lock:
            if cid in self._decoded_cids:
                return
        data = self.read_local(cid)
        if data is None:
            return
        obj = decoder(deserialize_pytree(data))
        with self._lock:
            if cid not in self._decoded_cids:
                self._cache_insert(cid, obj)
                self._prefetched.add(cid)

    def pin(self, cid: str):
        self._pins.add(cid)

    def gc(self):
        """Drop unpinned blocks (IPFS gc)."""
        with self._lock:
            for cid in list(self._blocks):
                if cid not in self._pins:
                    del self._blocks[cid]


class StoreNetwork:
    """Fully-connected private swarm of silo store nodes. Attach a
    ``repro_torch.net.NetFabric`` to make transfers cost simulated time."""

    def __init__(self, fabric=None):
        self.nodes: Dict[str, StoreNode] = {}
        self.fabric = fabric

    def attach_fabric(self, fabric) -> None:
        """Install the WAN fabric; existing nodes and their blocks are
        registered/published so provider records match reality."""
        self.fabric = fabric
        for node in self.nodes.values():
            fabric.register_node(node.node_id)
            for cid, data in node._blocks.items():
                fabric.publish(cid, node.node_id, len(data))

    def add_node(self, node_id: str, device,
                 root: Optional[str] = None) -> StoreNode:
        node = StoreNode(node_id, device, root)
        node.network = self
        for other in self.nodes.values():
            node.connect(other)
            other.connect(node)
        self.nodes[node_id] = node
        if self.fabric is not None:
            self.fabric.register_node(node_id)
        return node

    def drop_node(self, node_id: str):
        """Simulate a node failure: disconnect it from the swarm."""
        node = self.nodes.pop(node_id)
        for other in self.nodes.values():
            if node in other._peers:
                other._peers.remove(node)
        if self.fabric is not None:
            self.fabric.node_down(node_id)
        return node
