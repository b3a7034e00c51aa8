"""Async CID prefetch: warm the decoded cache during the training window.

The ROADMAP lever this module closes: when a silo announces a model CID, every
other silo is busy with its local training window — its store link is idle.
The prefetcher uses that window to pull the announced payload over the fabric
and decode it into the destination node's decoded-model cache, so the scoring
window / next round's pull-and-merge starts warm (a ``decode_hit`` +
``prefetch_hit`` instead of a charged WAN fetch).

Semantics:
  * a prefetched payload only becomes visible when its in-flight transfer
    *lands* (simulated transfer time elapses) — no premature warmth;
  * transfers are keyed SimEnv events: node churn cancels them mid-flight;
  * the link time a prefetch consumes is real fabric time (it queues behind
    and ahead of other transfers on the same link) but is *not* charged to
    the silo's compute windows — that is exactly the overlap the paper's
    async mode exists to exploit.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.net.fabric import NetFabric, UnreachableError
from repro_torch.obs.metrics import StatsView


class Prefetcher:
    def __init__(self, fabric: NetFabric, network,
                 decoder: Optional[Callable] = None, *,
                 delay_s: float = 0.0, fanout: int = 0):
        self.fabric = fabric
        self.network = network          # StoreNetwork (duck-typed: .nodes)
        # None -> each node's own wire decoder (delta base chains resolve
        # through that node's decoded cache)
        self.decoder = decoder
        self.delay_s = float(delay_s)
        # > 0: only the fanout cheapest peers of the announcer prefetch a
        # fresh CID — at thousand-silo scale all-to-all prefetch floods the
        # fabric with scavenger flows nobody will score against
        self.fanout = int(fanout)
        self.stats = StatsView("prefetch")

    def _targets(self, owner: str):
        if self.fanout <= 0 or len(self.network.nodes) <= self.fanout:
            return list(self.network.nodes)
        storeless = tuple(n for n in self.fabric.nodes
                          if n not in self.network.nodes)
        return self.fabric.nearest(owner, self.fanout, exclude=storeless)

    # fabric announce subscriber ------------------------------------------- #
    def on_announce(self, cid: str, owner: str, nbytes: int,
                    base_cid: str = "") -> None:
        for nid in self._targets(owner):
            if nid == owner:
                continue
            self.stats["issued"] += 1
            self.fabric.env.schedule(
                self.delay_s,
                lambda nid=nid: self._fire(nid, cid, base_cid),
                f"net:prefetch-start:{nid}:{cid[:12]}",
                key=("prefetch-start", nid, cid))

    def _fire(self, nid: str, cid: str, base_cid: str = "") -> None:
        node = self.network.nodes.get(nid)
        if node is None or not self.fabric.is_up(nid):
            self.stats["failed"] += 1
            return
        if base_cid and not (node.has(base_cid)
                             or node.has_decoded(base_cid)
                             or self.fabric.in_flight(
                                 ("prefetch", nid, base_cid))):
            # a delta envelope reconstructs against its base chain: pull the
            # missing base in the same training window (normally a no-op —
            # the base is last round's announce, already landed or still in
            # flight here; re-issuing would collide on the transfer key and
            # break churn cancellation)
            self.stats["issued"] += 1
            self._fire(nid, base_cid)
        if node.has(cid) or node.has_decoded(cid):
            # a scorer already pulled it the moment it was announced — the
            # cache is warm without us
            self.stats["skipped"] += 1
            return
        src = self.fabric.best_provider(nid, cid)
        src_node = self.network.nodes.get(src) if src else None
        data = src_node.serve_bytes(cid) if src_node else None
        if data is None:
            self.stats["failed"] += 1
            return

        def land(node=node, data=data):
            node.ingest(cid, data, prefetched=True)
            node.warm_decoded(cid, self.decoder or node.wire_decoder())
            self.stats["completed"] += 1

        try:
            self.fabric.transfer_async(src, nid, cid, len(data), land,
                                       kind="prefetch",
                                       key=("prefetch", nid, cid))
        except UnreachableError:
            self.stats["failed"] += 1

    def hit_stats(self) -> dict:
        hits = sum(n.stats["prefetch_hits"]
                   for n in self.network.nodes.values())
        done = max(1, self.stats["completed"])
        return {**self.stats, "hits": hits,
                "hit_rate": hits / done}
