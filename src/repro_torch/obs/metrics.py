"""Unified metrics: declared per-component stat schemas + one registry.

Before this module every component carried its own anonymous ``stats`` dict
and every benchmark re-guessed the keys (``stats.get("chain_bytes", 0)``).
Now each component's key set is *declared* once, with zero defaults and a
metric kind per key:

  * ``counter``   — monotonically increasing int,
  * ``seconds``   — monotonically accumulating float (simulated seconds),
  * ``gauge``     — point-in-time value (e.g. ``max_reorg_depth``).

``StatsView`` is a schema-enforcing MutableMapping that **is** the backing
store (components assign ``self.stats = StatsView("fabric")`` and mutate it
exactly as they mutated the dict — no caller changes). Reading or writing an
undeclared key raises ``KeyError`` immediately instead of silently minting a
new counter; keys can never be deleted.

``MetricsRegistry`` indexes the views of one run by ``(component, node)``
(the orchestrator adopts every view it creates) and renders them as a nested
``snapshot()`` or a flat ``component/node/key`` dict — the form hooked into
``round_log`` marks and the Chrome-trace export. Because the registry holds
the *same objects* the components mutate, registry values and legacy
``stats`` reads are equal by construction, and the parity tests assert it.

Histograms (``registry.histogram(name)``) accumulate count/sum/min/max plus
power-of-two buckets; the tracer feeds span and transfer durations in.
"""
from __future__ import annotations

import math
from collections.abc import MutableMapping
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

# --------------------------------------------------------------------------- #
# Declared schemas — the single source of truth for stats keys per component.
# --------------------------------------------------------------------------- #

SCHEMAS: Dict[str, Dict[str, str]] = {
    # core.store.StoreNode (one per silo)
    "store": {
        "puts": "counter", "gets": "counter", "peer_fetches": "counter",
        "bytes_stored": "counter", "bytes_fetched": "counter",
        "decodes": "counter", "decode_hits": "counter",
        "bytes_in": "counter", "bytes_out": "counter",
        "fetch_time": "seconds",
        "replica_hits": "counter", "prefetch_hits": "counter",
    },
    # net.fabric.NetFabric (one per run)
    "fabric": {
        "transfers": "counter", "bytes": "counter",
        "queue_wait_s": "seconds", "busy_s": "seconds",
        "reroutes": "counter", "replica_serves": "counter",
        "cancelled": "counter", "chain_bytes": "counter",
        "light_bytes": "counter",   # light-client chain sync (ctl lane)
        "edge_bytes": "counter",    # edge<->silo fleet traffic (access ports)
        # fair-share bandwidth model (bandwidth_model='fair-share')
        "settles": "counter",       # vectorized rate recomputes
        "reschedules": "counter",   # land events moved by repricing
    },
    # net.gossip.GossipReplicator
    "gossip": {
        "pushes": "counter", "landed": "counter", "skipped": "counter",
        "failed": "counter", "base_pushes": "counter",
        "chain_unresolved": "counter",
    },
    # net.prefetch.Prefetcher
    "prefetch": {
        "issued": "counter", "completed": "counter", "skipped": "counter",
        "failed": "counter",
    },
    # chain.sync.ChainNetwork (network plane)
    "chain_net": {
        "broadcasts": "counter", "delivered": "counter",
        "undeliverable": "counter", "catchup_requests": "counter",
        "catchup_blocks": "counter", "head_announces": "counter",
        "equivocations_sent": "counter", "kills": "counter",
        "restarts": "counter", "wal_replayed": "counter",
        "restart_fabric_bytes": "counter",
        "equivocation_reports": "counter",
    },
    # chain.light.LightSync (hub for all header-only edge clients of a run)
    "light": {
        "announcements": "counter",      # head headers pushed to clients
        "headers_accepted": "counter", "headers_rejected": "counter",
        "proof_requests": "counter", "proofs_served": "counter",
        "proofs_missing": "counter",
        "proofs_verified": "counter", "proofs_failed": "counter",
        "bytes": "counter",              # total light-sync wire bytes
        "undeliverable": "counter",
    },
    # edge.fleet.EdgeFleet (one per silo)
    "edge": {
        "rounds": "counter", "participants": "counter",
        "skipped_empty": "counter",      # sampled clients with no full batch
        "bytes_down": "counter", "bytes_up": "counter",
        "train_s": "seconds",            # summed simulated device time
    },
    # chain.replica.ChainReplica (one per participant)
    "replica": {
        "txs": "counter", "blocks": "counter", "bytes": "counter",
        "blocks_sealed": "counter", "blocks_imported": "counter",
        "forks_observed": "counter", "reorgs": "counter",
        "max_reorg_depth": "gauge", "equivocations_seen": "counter",
        "orphans": "counter", "invalid": "counter", "reverts": "counter",
        "wal_blocks": "counter", "wal_replayed": "counter",
        "wal_replay_bytes": "counter",
    },
}

COUNTER_KINDS = ("counter", "seconds")


def zero_for(kind: str):
    return 0.0 if kind == "seconds" else 0


def declared_keys() -> set:
    """Union of every declared stat key (benchmark key-lint uses this)."""
    out: set = set()
    for schema in SCHEMAS.values():
        out.update(schema)
    return out


class StatsView(MutableMapping):
    """A component's stats: schema-checked, zero-initialized, undeletable."""

    __slots__ = ("component", "node", "_schema", "_data")

    def __init__(self, component: str, node: str = ""):
        schema = SCHEMAS.get(component)
        if schema is None:
            raise ValueError(f"unknown stats component {component!r} "
                             f"(declared: {sorted(SCHEMAS)})")
        self.component = component
        self.node = node
        self._schema = schema
        self._data = {k: zero_for(kind) for k, kind in schema.items()}

    def __getitem__(self, key: str):
        try:
            return self._data[key]
        except KeyError:
            raise KeyError(
                f"{key!r} is not a declared {self.component!r} stat "
                f"(declared: {sorted(self._schema)})") from None

    def __setitem__(self, key: str, value) -> None:
        if key not in self._data:
            raise KeyError(
                f"{key!r} is not a declared {self.component!r} stat "
                f"(declared: {sorted(self._schema)})")
        self._data[key] = value

    def __delitem__(self, key: str) -> None:
        raise TypeError(f"declared {self.component!r} stats cannot be "
                        f"deleted (tried {key!r})")

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def __repr__(self) -> str:
        label = f"{self.component}:{self.node}" if self.node \
            else self.component
        return f"StatsView({label}, {self._data!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Mapping):
            return dict(self._data) == dict(other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def kind_of(self, key: str) -> str:
        return self._schema[key]


class Histogram:
    """count / sum / min / max + power-of-two buckets (upper-edge labeled)."""

    __slots__ = ("name", "count", "total", "min", "max", "buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[str, int] = {}

    @staticmethod
    def bucket_label(v: float) -> str:
        if v <= 0:
            return "<=0"
        return f"<=2^{math.ceil(math.log2(v)) if v > 0 else 0}"

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        lbl = self.bucket_label(v)
        self.buckets[lbl] = self.buckets.get(lbl, 0) + 1

    def summary(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.total,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": self.total / self.count if self.count else 0.0,
                "buckets": dict(sorted(self.buckets.items()))}


class MetricsRegistry:
    """Index of one run's StatsViews + histograms, keyed (component, node)."""

    def __init__(self):
        self._views: Dict[Tuple[str, str], StatsView] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- views --------------------------------------------------------------- #
    def adopt(self, view: StatsView) -> StatsView:
        """Register an existing view (the component keeps mutating it; the
        registry reads live values — one backing store, zero copies)."""
        key = (view.component, view.node)
        prior = self._views.get(key)
        if prior is not None and prior is not view:
            raise ValueError(f"duplicate stats view for {key}")
        self._views[key] = view
        return view

    def view(self, component: str, node: str = "") -> StatsView:
        """Get-or-create a registered view."""
        key = (component, node)
        if key not in self._views:
            self._views[key] = StatsView(component, node)
        return self._views[key]

    def views(self) -> Dict[Tuple[str, str], StatsView]:
        return dict(self._views)

    # -- histograms ----------------------------------------------------------- #
    def histogram(self, name: str) -> Histogram:
        if name not in self._hists:
            self._hists[name] = Histogram(name)
        return self._hists[name]

    def histograms(self) -> Dict[str, Histogram]:
        return dict(self._hists)

    # -- rendering ------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """Nested live values: {component: {node: {key: value}}}."""
        out: Dict[str, Dict[str, Dict[str, Any]]] = {}
        for (component, node), view in sorted(self._views.items()):
            out.setdefault(component, {})[node or "-"] = dict(view)
        return out

    def flat(self) -> Dict[str, Any]:
        """Flat ``component/node/key`` dict (round_log marks, trace export)."""
        out: Dict[str, Any] = {}
        for (component, node), view in sorted(self._views.items()):
            prefix = f"{component}/{node or '-'}"
            for k, v in view.items():
                out[f"{prefix}/{k}"] = v
        for name, h in sorted(self._hists.items()):
            s = h.summary()
            out[f"hist/{name}/count"] = s["count"]
            out[f"hist/{name}/sum"] = s["sum"]
        return out
