"""CAS-backed checkpointing (fault tolerance), twin of
``repro.checkpoint.checkpoint`` over the port's ``StoreNode``.

A training state (params + opt state + step + rng) serializes into the
content-addressed store; a manifest chain (each manifest links its parent's
CID) gives an auditable lineage, and restart = fetch latest manifest ->
fetch state -> resume. The manifest JSON and the state bytes are the
reference's, so equal states give equal CIDs in both packages.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.store import StoreNode, store_tensor


def save_state(store: StoreNode, state, *, step: int, tag: str = "train",
               parent: Optional[str] = None) -> str:
    """Returns the manifest CID."""
    state_cid = store.put(state)
    manifest = {"tag": tag, "step": int(step), "state_cid": state_cid,
                "parent": parent or ""}
    data = json.dumps(manifest, sort_keys=True).encode()
    return store.put(data)


def load_manifest(store: StoreNode, manifest_cid: str) -> Dict:
    return json.loads(store.get_bytes(manifest_cid).decode())


def _cast(stored, like):
    """A stored leaf in the prototype leaf's shape and dtype: a tensor on
    its device for a tensor prototype, a numpy array otherwise."""
    if isinstance(like, torch.Tensor):
        return store_tensor(stored).reshape(like.shape).to(
            device=like.device, dtype=like.dtype)
    return np.asarray(stored).astype(np.asarray(like).dtype).reshape(
        np.shape(like))


def restore_state(store: StoreNode, manifest_cid: str, like):
    """Rebuild the state (shape/dtype cast to the prototype ``like``).

    A stored leaf whose element count doesn't match the prototype raises
    ``ValueError`` naming the leaf (flat index + store key) and both shapes,
    not a bare reshape error."""
    manifest = load_manifest(store, manifest_cid)
    flat = store.get(manifest["state_cid"])
    items = tree.leaves_with_paths(like)
    vals = list(flat.values())
    keys = list(flat.keys())
    if len(vals) != len(items):
        raise ValueError(
            f"checkpoint/prototype mismatch: {len(vals)} vs {len(items)} leaves")
    cast = []
    for i, (v, (_, l)) in enumerate(zip(vals, items)):
        got = tuple(v.shape)
        want = tuple(np.shape(l))
        if int(np.prod(got, dtype=np.int64)) != \
                int(np.prod(want, dtype=np.int64)):
            raise ValueError(
                f"checkpoint shape mismatch at leaf {i} ({keys[i]!r}): "
                f"stored {got} cannot reshape to prototype {want}")
        cast.append(_cast(v, l))
    return tree.unflatten([p for p, _ in items], cast), manifest


class Checkpointer:
    """Every-K-steps checkpointing with a manifest chain and crash recovery."""

    def __init__(self, store: StoreNode, *, every: int = 50, tag: str = "train"):
        self.store = store
        self.every = every
        self.tag = tag
        self.latest: Optional[str] = None
        self.history = []

    def maybe_save(self, state, step: int) -> Optional[str]:
        if step % self.every != 0:
            return None
        return self.save(state, step)

    def save(self, state, step: int) -> str:
        self.latest = save_state(self.store, state, step=step, tag=self.tag,
                                 parent=self.latest)
        self.history.append((step, self.latest))
        return self.latest

    def restore_latest(self, like):
        if self.latest is None:
            raise RuntimeError("no checkpoint saved")
        return restore_state(self.store, self.latest, like)

    def lineage(self):
        """Walk the manifest chain back to genesis (audit)."""
        out, cid = [], self.latest
        while cid:
            m = load_manifest(self.store, cid)
            out.append((m["step"], cid))
            cid = m["parent"]
        return out
