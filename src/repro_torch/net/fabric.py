"""The simulated WAN fabric under the store network.

Converts the store from "peer fetch is free" into a scheduled, observable
resource on the orchestrator's ``SimEnv``:

  * every CID transfer serializes its 1 MiB blocks over the (src, dst) link
    and is *charged* simulated time: queue wait + latency + seeded jitter +
    blocks / bandwidth. Links carry three QoS lanes: demand traffic (fetch /
    replica / reroute) serializes only behind other demand transfers;
    control traffic (``chain`` — consensus block gossip) pipelines among
    itself, occupying the lane for its transmission time only (propagation
    latency is concurrent), so a consensus storm never starves model
    transfers; background traffic (prefetch / gossip replication) is
    scavenger-class — it queues behind *everything* and never delays a
    demand fetch;
  * DHT-style provider records track which nodes hold which CID; fetches are
    served from the cheapest reachable replica, not always the origin;
  * faults are first-class: network partitions, node churn (with in-flight
    transfer cancellation via the SimEnv's keyed events), and degraded
    "slow" links;
  * ``announce`` fans a newly submitted CID out to subscribers (the gossip
    replicator and the async prefetcher).

The fabric never moves bytes itself — callers (StoreNode / gossip /
prefetcher) read blocks from the source node and ask the fabric how much
simulated time the move costs. That keeps the data plane synchronous (real
numpy copies) while the clock stays simulated, matching how SiloRuntime
treats compute.
Two bandwidth models share every other mechanism (providers, faults,
announcements, keyed cancellation):

  * ``'lanes'`` (default) — the original per-link QoS-lane busy-until
    serialization described above; timelines are byte-identical to the
    pre-fair-share fabric.
  * ``'fair-share'`` — every transfer is a progress-tracked *flow*;
    concurrent flows split bandwidth by strict-priority weighted max-min
    over the pair link and both endpoints' access ports
    (``repro_torch.net.fairshare``), completion events are rescheduled as flows
    join/leave, and ``best_provider`` ranks replicas by *current* residual
    bandwidth instead of the static link profile.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.simenv import Trace
from repro_torch.net import fairshare
from repro_torch.net.topology import MIB, Topology
from repro_torch.obs import events as obsev
from repro_torch.obs.metrics import StatsView

_CID_W = 12  # cid prefix width in trace notes


class UnreachableError(IOError):
    """Every provider of a CID is partitioned away, down, or churned out."""


@dataclass(frozen=True)
class TransferRecord:
    kind: str   # 'fetch' | 'replica' | 'reroute' | 'replicate' | 'prefetch'
    #             | 'chain' (consensus block gossip / catch-up)
    #             | 'light' (header announcements + inclusion proofs)
    #             | 'edge'  (edge<->silo model up/down within a fleet)
    src: str
    dst: str
    cid: str
    nbytes: int
    t_start: float
    t_end: float


def _link_key(a: str, b: str) -> Tuple[str, str]:
    return (a, b) if a <= b else (b, a)


# scavenger-class kinds: yield the link to demand traffic
_BACKGROUND = ("prefetch", "replicate")


class NetFabric:
    def __init__(self, env, topology: Topology, *,
                 chunk_bytes: int = 1 << 20, seed: int = 0,
                 bandwidth_model: str = "lanes", trace_cap: int = 0,
                 qos_weights: Tuple[Tuple[str, float], ...] = ()):
        import random
        if bandwidth_model not in ("lanes", "fair-share"):
            raise ValueError(f"unknown bandwidth_model {bandwidth_model!r}")
        self.env = env
        self.topology = topology
        self.chunk_bytes = int(chunk_bytes)
        self.bandwidth_model = bandwidth_model
        self._rng = random.Random(0xFAB ^ seed)
        # membership / provider records are insertion-ordered dicts used as
        # sets: O(1) registration and publish at thousand-node scale, with
        # the same deterministic iteration order a list gave us
        self._nodes: Dict[str, None] = {}
        self._down: Set[str] = set()
        self._groups: Optional[Dict[str, int]] = None   # partition map
        self._degraded: Dict[Tuple[str, str], float] = {}
        self._busy: Dict[Tuple[str, str], float] = {}   # link -> busy-until
        self._providers: Dict[str, Dict[str, None]] = {}  # cid -> node ids
        self._origin: Dict[str, str] = {}
        self._sizes: Dict[str, int] = {}
        self._subscribers: List[Callable[[str, str, int], None]] = []
        self._inflight: Dict[Any, Tuple[str, str]] = {} # key -> (src, dst)
        self.trace: Trace = Trace(cap=trace_cap)
        self.stats = StatsView("fabric")
        self._flows: Optional[fairshare.FlowTable] = None
        if bandwidth_model == "fair-share":
            self._flows = fairshare.FlowTable(
                env, pair_cap=self._pair_cap_bytes,
                access_cap=self._access_cap_bytes,
                kind_weights=dict(qos_weights), stats=self.stats,
                on_rate_change=self._observe_rate)
            self._flow_seq = itertools.count()
            env.add_batch_hook(self._flows.settle)

    # -- membership --------------------------------------------------------- #
    def register_node(self, node_id: str) -> None:
        if node_id not in self._nodes:
            self._nodes[node_id] = None

    @property
    def nodes(self) -> List[str]:
        return list(self._nodes)

    @property
    def node_count(self) -> int:
        """O(1) membership size (avoids copying ``nodes`` in hot loops)."""
        return len(self._nodes)

    @property
    def flow_count(self) -> int:
        """Flows currently in the fair-share table (0 under the lane model)."""
        return len(self._flows) if self._flows is not None else 0

    def is_up(self, node_id: str) -> bool:
        return node_id not in self._down

    # -- provider records (DHT) --------------------------------------------- #
    def publish(self, cid: str, node_id: str, nbytes: int) -> None:
        """Record a provider for ``cid`` (put / cached fetch / replica)."""
        self.register_node(node_id)
        self._providers.setdefault(cid, {}).setdefault(node_id)
        self._sizes[cid] = int(nbytes)
        self._origin.setdefault(cid, node_id)

    def add_provider(self, cid: str, node_id: str) -> None:
        self._providers.setdefault(cid, {}).setdefault(node_id)

    def drop_provider(self, cid: str, node_id: str) -> None:
        provs = self._providers.get(cid)
        if provs is not None:
            provs.pop(node_id, None)

    def providers(self, cid: str) -> List[str]:
        return list(self._providers.get(cid, ()))

    def origin(self, cid: str) -> Optional[str]:
        return self._origin.get(cid)

    def size_of(self, cid: str) -> int:
        return self._sizes.get(cid, self.chunk_bytes)

    def known(self, cid: str) -> bool:
        return bool(self._providers.get(cid))

    # -- announcements ------------------------------------------------------ #
    def subscribe(self, fn: Callable[..., None]) -> None:
        """fn(cid, owner, nbytes, base_cid='') fires on every announced CID."""
        self._subscribers.append(fn)

    def announce(self, cid: str, owner: str, base_cid: str = "") -> None:
        """Owner advertises a fresh CID (a submitted model): gossip + prefetch
        subscribers react. ``base_cid`` names the delta-coding base so the
        subscribers can move the base chain alongside the delta envelope.
        Plain puts only ``publish`` provider records."""
        nbytes = self.size_of(cid)
        for fn in list(self._subscribers):
            fn(cid, owner, nbytes, base_cid)

    # -- reachability / faults ---------------------------------------------- #
    def reachable(self, a: str, b: str) -> bool:
        if a == b:
            return True
        if a in self._down or b in self._down:
            return False
        if self._groups is not None and \
                self._groups.get(a, 0) != self._groups.get(b, 0):
            return False
        return True

    def partition(self, *groups) -> None:
        """Split the swarm: nodes in different groups can't exchange blocks.
        Unlisted nodes join group 0."""
        gmap: Dict[str, int] = {}
        for gi, group in enumerate(groups):
            for nid in group:
                gmap[nid] = gi
        self._groups = gmap
        self.env.emit(obsev.net_partition(groups))

    def isolate(self, node_id: str) -> None:
        """Partition one node away from everyone else. Cumulative: nodes
        isolated earlier stay isolated until ``heal``."""
        gmap = dict(self._groups) if self._groups is not None \
            else {n: 0 for n in self._nodes}
        gmap[node_id] = max(gmap.values(), default=0) + 1
        self._groups = gmap
        self.env.emit(obsev.net_isolate(node_id))

    def heal(self) -> None:
        self._groups = None
        self.env.emit(obsev.net_heal())

    def node_down(self, node_id: str) -> None:
        """Churn a node out; every in-flight transfer touching it is
        cancelled through the SimEnv's keyed events (fair-share flows are
        also dropped from the share table, freeing their bandwidth)."""
        self._down.add(node_id)
        for key, (src, dst) in list(self._inflight.items()):
            if node_id in (src, dst):
                hit = self.env.cancel(key)
                if self._flows is not None \
                        and self._flows.remove(key) is not None:
                    hit = True
                if hit:
                    self.stats["cancelled"] += 1
                del self._inflight[key]
        if self._flows is not None:
            # sync-transfer flows (not in _inflight) touching the node:
            # their bytes already moved, but stop them holding bandwidth
            for key, f in list(self._flows.flows.items()):
                if node_id in (f.src, f.dst):
                    self._flows.remove(key)
                    self.env.cancel(key)
        self.env.emit(obsev.net_down(node_id))

    def node_up(self, node_id: str) -> None:
        self._down.discard(node_id)
        self.env.emit(obsev.net_up(node_id))

    def degrade_link(self, a: str, b: str, factor: float) -> None:
        """Scale a link's bandwidth by 1/factor (slow-link straggler)."""
        if factor <= 0:
            raise ValueError("degrade factor must be > 0")
        self._degraded[_link_key(a, b)] = float(factor)
        if self._flows is not None:
            self._flows.mark_dirty()    # reprice active flows on the link
        self.env.emit(obsev.net_slow_link(a, b, factor))

    # -- transfer scheduling ------------------------------------------------ #
    def _cost_parts(self, src: str, dst: str,
                    nbytes: int) -> Tuple[float, float]:
        """(serialization seconds, propagation latency + jitter seconds)."""
        prof = self.topology.link(src, dst)
        factor = self._degraded.get(_link_key(src, dst), 1.0)
        n_blocks = max(1, -(-int(nbytes) // self.chunk_bytes))
        jitter = self._rng.uniform(0.0, prof.jitter_s) if prof.jitter_s else 0.0
        return (n_blocks * prof.block_s(self.chunk_bytes) * factor,
                prof.latency_s + jitter)

    def _wire_bytes(self, nbytes: int) -> float:
        """Block-padded payload size: the fair-share flow moves whole
        chunks, matching the lane model's per-block charging."""
        return float(max(1, -(-int(nbytes) // self.chunk_bytes))
                     * self.chunk_bytes)

    def _pair_cap_bytes(self, a: str, b: str) -> float:
        prof = self.topology.link(a, b)
        factor = self._degraded.get(_link_key(a, b), 1.0)
        return prof.bandwidth_mibps * MIB / factor

    def _access_cap_bytes(self, node_id: str) -> float:
        return self.topology.access_mibps(node_id) * MIB

    def _observe_rate(self, f: fairshare.Flow) -> None:
        tr = self.env.tracer
        if tr.enabled:
            lk = _link_key(f.src, f.dst)
            tr.event("net.rate", f"link/{lk[0]}~{lk[1]}/flows", self.env.now,
                     kind=f.kind, src=f.src, dst=f.dst, cid=f.cid[:_CID_W],
                     mibps=round(f.rate / MIB, 3))

    def transfer(self, src: str, dst: str, cid: str, nbytes: int, *,
                 kind: str = "fetch") -> float:
        """Reserve the (src, dst) link for one chunked CID transfer starting
        now; returns the simulated seconds the *destination* is charged
        (queue wait + serialization). Raises UnreachableError on faults."""
        if not self.reachable(src, dst):
            raise UnreachableError(f"{src}->{dst} unreachable "
                                   f"(partition or churn)")
        if self._flows is not None:
            return self._transfer_fair(src, dst, cid, nbytes, kind=kind)
        ser, lat = self._cost_parts(src, dst, nbytes)
        duration = ser + lat
        lk = _link_key(src, dst)
        fg, bg, ctl = (lk, "fg"), (lk, "bg"), (lk, "ctl")
        if kind in ("chain", "light"):
            # control plane: consensus messages (and light-client header /
            # proof sync, which is consensus-read traffic) are tiny and
            # pipeline — they serialize only among themselves, and only
            # their *transmission* time occupies the lane (propagation
            # latency is concurrent, not head-of-line blocking). A fork
            # storm therefore never starves model transfers off the link.
            lane = "ctl"
            start = max(self.env.now, self._busy.get(ctl, 0.0))
            self._busy[ctl] = start + ser
            duration = ser + lat        # the receiver still waits for both
        elif kind in _BACKGROUND:
            # background waits for every lane; demand never waits for it
            lane = "bg"
            start = max(self.env.now, self._busy.get(fg, 0.0),
                        self._busy.get(bg, 0.0), self._busy.get(ctl, 0.0))
            self._busy[bg] = start + duration
        else:
            lane = "fg"
            start = max(self.env.now, self._busy.get(fg, 0.0))
            self._busy[fg] = start + duration
        end = start + duration
        self.trace.append(TransferRecord(kind, src, dst, cid, int(nbytes),
                                         start, end))
        tr = self.env.tracer
        if tr.enabled:
            # span = lane *occupancy*; ctl spans end at start+ser so
            # pipelined consensus messages never overlap within the lane
            occ_end = start + ser if kind in ("chain", "light") else end
            tr.span_at(f"net.{kind}", f"link/{lk[0]}~{lk[1]}/{lane}",
                       start, occ_end, src=src, dst=dst, cid=cid[:_CID_W],
                       nbytes=int(nbytes))
        self.env.emit(obsev.net_transfer(kind, src, dst, cid, lane=lane,
                                         nbytes=int(nbytes)))
        self.stats["transfers"] += 1
        self.stats["bytes"] += int(nbytes)
        self.stats["queue_wait_s"] += start - self.env.now
        self.stats["busy_s"] += duration
        if kind == "reroute":
            self.stats["reroutes"] += 1
        if kind in ("replica", "reroute"):
            self.stats["replica_serves"] += 1
        if kind == "chain":
            # consensus traffic class: block gossip / catch-up (small,
            # latency-critical — pipelines in its own control lane above)
            self.stats["chain_bytes"] += int(nbytes)
        elif kind == "light":
            self.stats["light_bytes"] += int(nbytes)
        elif kind == "edge":
            self.stats["edge_bytes"] += int(nbytes)
        return end - self.env.now

    # -- fair-share flow path ----------------------------------------------- #
    def _count_transfer(self, kind: str, src: str, dst: str, cid: str,
                        nbytes: int, lane: str) -> None:
        """Admission-time accounting shared with the lane model."""
        self.env.emit(obsev.net_transfer(kind, src, dst, cid, lane=lane,
                                         nbytes=int(nbytes)))
        self.stats["transfers"] += 1
        self.stats["bytes"] += int(nbytes)
        if kind == "reroute":
            self.stats["reroutes"] += 1
        if kind in ("replica", "reroute"):
            self.stats["replica_serves"] += 1
        if kind == "chain":
            self.stats["chain_bytes"] += int(nbytes)
        elif kind == "light":
            self.stats["light_bytes"] += int(nbytes)
        elif kind == "edge":
            self.stats["edge_bytes"] += int(nbytes)

    def _transfer_fair(self, src: str, dst: str, cid: str, nbytes: int, *,
                       kind: str) -> float:
        """Synchronous charge under fair sharing: admit the flow, settle
        rates, and return the admission-time projection (current contention,
        no future arrivals). The flow stays in the share table until its
        projected completion — departures may retire it earlier; the charge
        is the commitment, like the lane model's busy-until reservation."""
        flows = self._flows
        assert flows is not None
        _, lat = self._cost_parts(src, dst, nbytes)  # same rng draw order
        wire = self._wire_bytes(nbytes)
        key = ("flow", next(self._flow_seq))
        flows.settle()

        def done():
            flows.complete(key)

        f = flows.add(key, src, dst, cid, kind, wire, lat, done,
                      note=f"net:flowdone:{kind}:{dst}:{cid[:_CID_W]}")
        flows.settle()      # reprice with the new flow admitted
        start = self.env.now
        end = f.scheduled_eta
        if end is None:     # starved at admission (non-demand sync caller)
            est = max(1.0, flows.rate_estimate(src, dst, kind))
            end = start + lat + wire / est
        lane = fairshare.qos_class(kind)
        self.trace.append(TransferRecord(kind, src, dst, cid, int(nbytes),
                                         start, end))
        tr = self.env.tracer
        if tr.enabled:
            lk = _link_key(src, dst)
            tr.span_at(f"net.{kind}", f"link/{lk[0]}~{lk[1]}/{lane}",
                       start, end, src=src, dst=dst, cid=cid[:_CID_W],
                       nbytes=int(nbytes),
                       mibps=round(f.rate / MIB, 3))
        self._count_transfer(kind, src, dst, cid, nbytes, lane)
        self.stats["busy_s"] += end - start
        return end - start

    def _transfer_async_fair(self, src: str, dst: str, cid: str, nbytes: int,
                             on_land: Callable[[], None], *, kind: str,
                             key: Any) -> float:
        flows = self._flows
        assert flows is not None
        _, lat = self._cost_parts(src, dst, nbytes)  # same rng draw order
        wire = self._wire_bytes(nbytes)

        def land():
            f = flows.complete(key)
            self._inflight.pop(key, None)
            now = self.env.now
            if f is not None:
                lane = fairshare.qos_class(kind)
                self.trace.append(TransferRecord(kind, src, dst, cid,
                                                 int(nbytes), f.t_start, now))
                self.stats["busy_s"] += now - f.t_start
                tr = self.env.tracer
                if tr.enabled:
                    lk = _link_key(src, dst)
                    tr.span_at(f"net.{kind}",
                               f"link/{lk[0]}~{lk[1]}/{lane}",
                               f.t_start, now, src=src, dst=dst,
                               cid=cid[:_CID_W], nbytes=int(nbytes),
                               rate_changes=f.rate_changes,
                               mean_mibps=round(f.mean_mibps(now), 3))
            on_land()

        f = flows.add(key, src, dst, cid, kind, wire, lat, land,
                      note=f"net:land:{kind}:{dst}:{cid[:_CID_W]}")
        self._inflight[key] = (src, dst)
        self._count_transfer(kind, src, dst, cid, nbytes,
                             fairshare.qos_class(kind))
        eta = f.scheduled_eta
        return (eta - self.env.now) if eta is not None else 0.0

    def transfer_async(self, src: str, dst: str, cid: str, nbytes: int,
                       on_land: Callable[[], None], *, kind: str,
                       key: Any = None) -> float:
        """Like ``transfer`` but the payload only *lands* (``on_land``) after
        the charged time elapses — an in-flight, cancellable transfer.
        Under fair sharing the land event is rescheduled live as contention
        changes; the return value is the admission-time projection."""
        key = key if key is not None else (kind, dst, cid)
        if self._flows is not None:
            if not self.reachable(src, dst):
                raise UnreachableError(f"{src}->{dst} unreachable "
                                       f"(partition or churn)")
            return self._transfer_async_fair(src, dst, cid, nbytes, on_land,
                                             kind=kind, key=key)
        charged = self.transfer(src, dst, cid, nbytes, kind=kind)
        self._inflight[key] = (src, dst)

        def land():
            self._inflight.pop(key, None)
            on_land()

        self.env.schedule(charged, land,
                          f"net:land:{kind}:{dst}:{cid[:_CID_W]}", key=key)
        return charged

    def in_flight(self, key: Any) -> bool:
        """Is a keyed async transfer still in flight (not landed/cancelled)?"""
        return key in self._inflight

    # -- replica selection -------------------------------------------------- #
    def best_provider(self, dst: str, cid: str,
                      exclude: Tuple[str, ...] = ()) -> Optional[str]:
        """Cheapest reachable provider, node id as the deterministic
        tiebreak. Lane model: queue wait + latency + payload time off the
        static profile. Fair-share: congestion-aware — latency + payload
        over the provider's *current residual* demand-class bandwidth, so
        fan-in on a hot origin steers fetches to idle replicas."""
        nbytes = self.size_of(cid)
        best, best_cost = None, None
        if self._flows is not None:
            # no settle here: estimates tolerate intra-batch staleness.
            # Flow *membership* (the competing-weight term) is indexed at
            # admission, so it is always current; only higher-tier consumed
            # rates can lag a batch, and for demand-class ranking (the one
            # callers use) there is no higher tier — the estimate is exact
            # w.r.t. membership either way, and ranking stays O(providers)
            # instead of forcing a full reprice per query.
            wire = self._wire_bytes(nbytes)
            for p in self._providers.get(cid, ()):
                if p == dst or p in exclude or not self.reachable(p, dst):
                    continue
                est = self._flows.rate_estimate(p, dst, "fetch")
                prof = self.topology.link(p, dst)
                t = prof.latency_s + (wire / est if est > 0.0
                                      else float("inf"))
                cost = (t, p)
                if best_cost is None or cost < best_cost:
                    best, best_cost = p, cost
            return best
        for p in self._providers.get(cid, ()):
            if p == dst or p in exclude or not self.reachable(p, dst):
                continue
            wait = max(0.0, self._busy.get((_link_key(p, dst), "fg"), 0.0)
                       - self.env.now)
            cost = (wait + self.topology.base_cost_s(p, dst, nbytes,
                                                     self.chunk_bytes), p)
            if best_cost is None or cost < best_cost:
                best, best_cost = p, cost
        return best

    def has_unreachable_provider(self, dst: str, cid: str,
                                 exclude: Tuple[str, ...] = ()) -> bool:
        return any(p != dst and (p in exclude or not self.reachable(p, dst))
                   for p in self._providers.get(cid, ()))

    def nearest(self, node_id: str, k: int,
                exclude: Tuple[str, ...] = ()) -> List[str]:
        """The k cheapest reachable peers of ``node_id`` (one-block cost)."""
        cands = []
        for other in self._nodes:
            if other == node_id or other in exclude \
                    or not self.reachable(node_id, other):
                continue
            cost = self.topology.base_cost_s(node_id, other,
                                             self.chunk_bytes,
                                             self.chunk_bytes)
            cands.append((cost, other))
        cands.sort()
        return [nid for _, nid in cands[:max(0, k)]]
