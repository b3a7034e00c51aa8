"""Weighted max-min fair bandwidth sharing for the WAN fabric.

The lane model (``NetFabric`` with ``bandwidth_model='lanes'``) serializes a
link's transfers behind per-lane busy-until floats — concurrent transfers
never actually contend. This module is the ``'fair-share'`` alternative:
every in-flight transfer is a *flow* with progress tracking, and bandwidth
is split by progressive filling (water-filling) over three resources per
flow — the (src, dst) pair link plus both endpoints' access ports
(``Topology.access_mibps``), which is what actually contends under
hot-provider fan-in at thousand-silo scale.

QoS classes map onto *strict* priority tiers — demand (fetch / replica /
reroute) > control (chain) > scavenger (prefetch / replicate) — mirroring
the lane model's ordering guarantees: demand traffic never waited for
control or scavenger lanes, so finite inter-class weight ratios would be a
regression (a lone demand flow would lose bandwidth to background noise).
*Within* a class, flows share by weighted max-min; per-kind weights come
from ``NetConfig.qos_weights``.

``allocate_rates`` is the pure allocator (numpy over active-flow arrays);
``FlowTable`` owns flow state, progress advancement, and land-event
(re)scheduling through the SimEnv's keyed cancel-and-replace. Rates are
*settled* lazily: joins/leaves mark the table dirty, and the SimEnv batch
hook (or any fabric read that needs fresh rates) triggers one vectorized
recompute for the whole batch instead of one per event.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.net.topology import MIB

# transfer kind -> QoS class; unlisted kinds are demand traffic
QOS_CLASS: Dict[str, str] = {
    "chain": "control",
    "light": "control",     # header/proof sync rides the consensus class
    "prefetch": "scavenger",
    "replicate": "scavenger",
}
# strict priority: lower tier number allocates first and owns the capacity
TIER: Dict[str, int] = {"demand": 0, "control": 1, "scavenger": 2}

_REL_TOL = 1e-12


def qos_class(kind: str) -> str:
    return QOS_CLASS.get(kind, "demand")


def allocate_rates(weights, tiers, res_idx, caps) -> np.ndarray:
    """Strict-priority weighted max-min allocation.

    ``weights``: (F,) positive within-class weights.
    ``tiers``: (F,) ints — lower allocates first (strict priority).
    ``res_idx``: (F, K) resource indices; each row's entries must be
    distinct (a flow consumes each of its resources once).
    ``caps``: (R,) resource capacities (bytes/s).

    Returns (F,) rates: within each tier, progressive filling raises every
    flow's normalized rate ``rate/weight`` together until a resource
    saturates, freezes the flows it bottlenecks, and continues — the
    classic weighted max-min water-fill — against the capacity left over
    by all higher tiers.
    """
    w = np.asarray(weights, dtype=float)
    t = np.asarray(tiers)
    ridx = np.atleast_2d(np.asarray(res_idx, dtype=np.intp))
    caps0 = np.asarray(caps, dtype=float)
    n = w.shape[0]
    rates = np.zeros(n)
    if n == 0:
        return rates
    if np.any(w <= 0.0):
        raise ValueError("flow weights must be positive")
    remaining = caps0.copy()
    floor = 1e-9 * np.maximum(caps0, 1.0)
    for tier in np.unique(t):
        sel = np.nonzero(t == tier)[0]
        r = _weighted_maxmin(w[sel], ridx[sel], remaining)
        rates[sel] = r
        for c in range(ridx.shape[1]):
            np.subtract.at(remaining, ridx[sel, c], r)
        np.maximum(remaining, 0.0, out=remaining)
        remaining[remaining <= floor] = 0.0  # squash float residue so a
        # saturated resource reads as exactly full to lower tiers
    return rates


def _weighted_maxmin(w: np.ndarray, ridx: np.ndarray,
                     caps: np.ndarray) -> np.ndarray:
    n = w.shape[0]
    rates = np.zeros(n)
    if n == 0:
        return rates
    nres = caps.shape[0]
    rem = caps.copy()
    active = np.ones(n, dtype=bool)
    for _ in range(n + 1):
        if not active.any():
            break
        wsum = np.zeros(nres)
        for c in range(ridx.shape[1]):
            np.add.at(wsum, ridx[active, c], w[active])
        used = wsum > 0.0
        theta = np.full(nres, math.inf)
        np.divide(rem, wsum, out=theta, where=used)
        th = theta.min()
        if not math.isfinite(th):
            break
        sat = used & (theta <= th * (1.0 + _REL_TOL) + 1e-18)
        touch = np.zeros(n, dtype=bool)
        for c in range(ridx.shape[1]):
            touch |= sat[ridx[:, c]]
        newly = active & touch
        if not newly.any():     # numerical guard: freeze the rest
            newly = active.copy()
        rates[newly] = w[newly] * th
        for c in range(ridx.shape[1]):
            np.subtract.at(rem, ridx[newly, c], rates[newly])
        np.maximum(rem, 0.0, out=rem)
        active &= ~newly
    return rates


class Flow:
    """One in-flight transfer under fair sharing. ``remaining`` counts wire
    bytes still to move; once they finish (``bytes_done_t`` set) the flow
    stops consuming bandwidth and lands ``lat`` seconds later."""

    __slots__ = ("key", "src", "dst", "cid", "kind", "tier", "weight",
                 "nbytes", "remaining", "lat", "rate", "last_t", "t_start",
                 "bytes_done_t", "scheduled_eta", "fire", "note",
                 "rate_changes")

    def __init__(self, key: Any, src: str, dst: str, cid: str, kind: str,
                 tier: int, weight: float, nbytes: float, lat: float,
                 t_start: float, fire: Callable[[], None], note: str):
        self.key = key
        self.src = src
        self.dst = dst
        self.cid = cid
        self.kind = kind
        self.tier = tier
        self.weight = weight
        self.nbytes = float(nbytes)
        self.remaining = float(nbytes)
        self.lat = float(lat)
        self.rate = 0.0
        self.last_t = t_start
        self.t_start = t_start
        self.bytes_done_t: Optional[float] = None
        self.scheduled_eta: Optional[float] = None
        self.fire = fire
        self.note = note
        self.rate_changes = 0

    @property
    def resources(self) -> Tuple[Tuple, Tuple, Tuple]:
        a, b = (self.src, self.dst) if self.src <= self.dst \
            else (self.dst, self.src)
        return (("p", a, b), ("u", self.src), ("d", self.dst))

    def mean_mibps(self, t_end: float) -> float:
        wire_s = (self.bytes_done_t if self.bytes_done_t is not None
                  else t_end) - self.t_start
        if wire_s <= 0.0:
            return 0.0
        return (self.nbytes - self.remaining) / MIB / wire_s


class FlowTable:
    """Active flows + lazy rate settling for one ``NetFabric``.

    ``pair_cap(a, b)`` / ``access_cap(n)`` return current capacities in
    bytes/s (the fabric closes over its degrade factors). ``on_rate_change``
    (optional) observes every repriced flow — the fabric forwards it to the
    obs tracer as a flow-rate instant."""

    def __init__(self, env, *, pair_cap: Callable[[str, str], float],
                 access_cap: Callable[[str], float],
                 kind_weights: Optional[Dict[str, float]] = None,
                 stats=None,
                 on_rate_change: Optional[Callable[[Flow], None]] = None):
        self.env = env
        self.flows: Dict[Any, Flow] = {}
        # per-resource flow index: rate_estimate / best_provider probe only
        # the three resources a candidate flow would touch, not every flow
        # in the table (O(fan-in) instead of O(total) at thousand-silo scale)
        self._by_res: Dict[Tuple, Dict[Any, Flow]] = {}
        self._pair_cap = pair_cap
        self._access_cap = access_cap
        self._kind_weights = dict(kind_weights or {})
        for k, v in self._kind_weights.items():
            if v <= 0.0:
                raise ValueError(f"qos weight for kind {k!r} must be > 0")
        self.stats = stats
        self.on_rate_change = on_rate_change
        self._dirty = False

    # ------------------------------------------------------------------ #
    # membership
    # ------------------------------------------------------------------ #

    def weight_of(self, kind: str) -> float:
        return self._kind_weights.get(kind, 1.0)

    def add(self, key: Any, src: str, dst: str, cid: str, kind: str,
            nbytes: float, lat: float, fire: Callable[[], None],
            note: str = "") -> Flow:
        """Admit a flow and schedule a *provisional* land (solo-rate bound
        plus the batch-epsilon margin, so it can never fire before the next
        settle corrects it). Marks the table dirty; the batch hook or the
        next fresh-rate read reprices everything."""
        prior = self.flows.pop(key, None)
        if prior is not None:       # cancel-and-replace, mirroring SimEnv
            prior.scheduled_eta = None
            self._unindex(prior)
        now = self.env.now
        f = Flow(key, src, dst, cid, kind, TIER[qos_class(kind)],
                 self.weight_of(kind), nbytes, lat, now, fire, note)
        self.flows[key] = f
        for rk in f.resources:
            self._by_res.setdefault(rk, {})[key] = f
        solo = min(self._pair_cap(src, dst),
                   self._access_cap(src), self._access_cap(dst))
        margin = getattr(self.env, "batch_epsilon_s", 0.0)
        eta = now + margin + lat + (nbytes / solo if solo > 0.0 else 0.0)
        self.env.schedule(eta - now, f.fire, f.note, key=key)
        f.scheduled_eta = eta
        self._dirty = True
        return f

    def _unindex(self, f: Flow) -> None:
        for rk in f.resources:
            d = self._by_res.get(rk)
            if d is not None:
                d.pop(f.key, None)
                if not d:
                    del self._by_res[rk]

    def remove(self, key: Any) -> Optional[Flow]:
        """Drop a flow without landing it (churn cancellation). The caller
        cancels the keyed land event."""
        f = self.flows.pop(key, None)
        if f is not None:
            self._unindex(f)
            self._dirty = True
        return f

    def complete(self, key: Any) -> Optional[Flow]:
        """A land event fired: account final progress, retire the flow."""
        f = self.flows.pop(key, None)
        if f is None:
            return None
        self._unindex(f)
        self._advance(f, self.env.now)
        f.scheduled_eta = None
        self._dirty = True
        return f

    def mark_dirty(self) -> None:
        self._dirty = True

    def __len__(self) -> int:
        return len(self.flows)

    # ------------------------------------------------------------------ #
    # settling
    # ------------------------------------------------------------------ #

    @staticmethod
    def _advance(f: Flow, now: float) -> None:
        if f.bytes_done_t is None and f.rate > 0.0 and now > f.last_t:
            need = f.remaining / f.rate
            dt = now - f.last_t
            if dt >= need - 1e-15:
                f.bytes_done_t = f.last_t + need
                f.remaining = 0.0
            else:
                f.remaining -= f.rate * dt
        f.last_t = now

    def settle(self) -> None:
        """Advance every flow's progress to ``env.now``, reallocate rates,
        and (re)schedule land events whose ETA moved. No-op unless dirty —
        registered as the SimEnv batch hook, so the whole batch's churn
        costs one vectorized recompute."""
        if not self._dirty:
            return
        self._dirty = False
        if not self.flows:
            return
        now = self.env.now
        flows = list(self.flows.values())
        for f in flows:
            self._advance(f, now)
        active = [f for f in flows if f.bytes_done_t is None]
        if active:
            res_index: Dict[Tuple, int] = {}
            ridx = np.empty((len(active), 3), dtype=np.intp)
            for i, f in enumerate(active):
                for c, rk in enumerate(f.resources):
                    j = res_index.get(rk)
                    if j is None:
                        j = res_index[rk] = len(res_index)
                    ridx[i, c] = j
            caps = np.fromiter((self._cap(rk) for rk in res_index),
                               dtype=float, count=len(res_index))
            w = np.fromiter((f.weight for f in active), dtype=float,
                            count=len(active))
            tiers = np.fromiter((f.tier for f in active), dtype=np.intp,
                                count=len(active))
            rates = allocate_rates(w, tiers, ridx, caps)
            if self.stats is not None:
                self.stats["settles"] += 1
            for f, r in zip(active, rates):
                r = float(r)
                if r != f.rate:
                    f.rate = r
                    f.rate_changes += 1
                    if self.on_rate_change is not None:
                        self.on_rate_change(f)
        for f in flows:
            self._sync_land(f, now)

    def _cap(self, rk: Tuple) -> float:
        if rk[0] == "p":
            return self._pair_cap(rk[1], rk[2])
        return self._access_cap(rk[1])

    def _sync_land(self, f: Flow, now: float) -> None:
        if f.bytes_done_t is not None:
            eta = f.bytes_done_t + f.lat
        elif f.rate > 1e-9:
            eta = now + f.remaining / f.rate + f.lat
        else:
            # starved (a higher tier owns every resource): park the flow —
            # the next settle that frees capacity re-arms its land
            if f.scheduled_eta is not None:
                self.env.cancel(f.key)
                f.scheduled_eta = None
                if self.stats is not None:
                    self.stats["reschedules"] += 1
            return
        prev = f.scheduled_eta
        if prev is not None and abs(eta - prev) <= _REL_TOL * max(1.0, eta):
            return
        self.env.schedule(max(0.0, eta - now), f.fire, f.note, key=f.key)
        f.scheduled_eta = eta
        if prev is not None and self.stats is not None:
            self.stats["reschedules"] += 1

    # ------------------------------------------------------------------ #
    # congestion-aware estimates (provider selection)
    # ------------------------------------------------------------------ #

    def rate_estimate(self, src: str, dst: str, kind: str) -> float:
        """Residual-share estimate (bytes/s) for a hypothetical new flow:
        per resource, capacity left by strictly-higher tiers split by
        weight against same-tier occupants; the minimum across the pair
        link and both access ports. Membership is always current (indexed
        at admission); consumed higher-tier rates may lag by one batch
        between settles — exact for demand-class queries, which have no
        higher tier. Pure estimate — nothing is admitted."""
        tier = TIER[qos_class(kind)]
        w = self.weight_of(kind)
        a, b = (src, dst) if src <= dst else (dst, src)
        est = math.inf
        for rk, cap in ((("p", a, b), self._pair_cap(src, dst)),
                        (("u", src), self._access_cap(src)),
                        (("d", dst), self._access_cap(dst))):
            higher = 0.0
            competing = 0.0
            for f in self._by_res.get(rk, {}).values():
                if f.bytes_done_t is not None:
                    continue
                if f.tier < tier:
                    higher += f.rate
                elif f.tier == tier:
                    competing += f.weight
            avail = max(0.0, cap - higher)
            est = min(est, avail * w / (w + competing))
        return est
