"""Link-level model of the store network (paper §2.4: silo IPFS nodes talk
over a WAN; §4.1: the testbed spans machines on different networks).

A ``Topology`` assigns every unordered node pair a ``LinkProfile`` —
bandwidth, propagation latency, and a jitter bound. Profiles are derived
*deterministically* from ``(preset, seed, pair)`` via SHA-256, so membership
is dynamic (any node id resolves to the same link without pre-registration)
and two topologies built with the same preset+seed are identical.

Presets
-------
``lan``                one switch, 10 GbE class: flat fast links.
``wan-uniform``        every pair is a 100 Mbit/s, 30 ms WAN hop.
``wan-heterogeneous``  pairs draw one of three tiers (fiber / commodity DSL /
                       congested long-haul), the regime where stragglers and
                       replica placement dominate wall-clock.
``paper-testbed``      approximation of the paper's evaluation fabric: a mix
                       of campus-LAN pairs (1 Gbit/s, 2 ms) and cross-site
                       pairs (100 Mbit/s, 25 ms), roughly half and half.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Tuple

MIB = float(1 << 20)

PRESETS = ("lan", "wan-uniform", "wan-heterogeneous", "paper-testbed")


@dataclass(frozen=True)
class LinkProfile:
    bandwidth_mibps: float   # MiB of payload per simulated second
    latency_s: float         # one-shot propagation delay per transfer
    jitter_s: float = 0.0    # uniform [0, jitter_s) extra delay per transfer

    def block_s(self, chunk_bytes: int) -> float:
        """Simulated seconds to push one chunk-sized block down this link."""
        return (chunk_bytes / MIB) / self.bandwidth_mibps


# preset -> (access tiers MiB/s, cumulative weights); a node hashes into the
# table. The access port caps the node's *aggregate* up/down rate under the
# fair-share bandwidth model (hot-provider fan-in is what actually contends
# at thousand-silo scale — distinct pair links rarely carry two flows at
# once). Every tier is >= the preset's fastest pair link, so a *solo*
# transfer is never access-limited and matches the lane model exactly.
_ACCESS: Dict[str, Tuple[Tuple[float, ...], Tuple[int, ...]]] = {
    "lan": ((2500.0,), (1,)),
    "wan-uniform": ((50.0,), (1,)),
    "wan-heterogeneous": ((500.0, 250.0, 125.0), (1, 3, 5)),
    "paper-testbed": ((250.0,), (1,)),
}

# preset -> (tiers, cumulative weights); a pair hashes into the weight table
_TIERS: Dict[str, Tuple[Tuple[LinkProfile, ...], Tuple[int, ...]]] = {
    "lan": ((LinkProfile(1250.0, 0.0002, 0.0),), (1,)),
    "wan-uniform": ((LinkProfile(12.5, 0.03, 0.002),), (1,)),
    "wan-heterogeneous": (
        (LinkProfile(125.0, 0.005, 0.001),    # metro fiber
         LinkProfile(12.5, 0.04, 0.005),      # commodity broadband
         LinkProfile(2.5, 0.12, 0.02)),       # congested long-haul
        (1, 3, 5),
    ),
    "paper-testbed": (
        (LinkProfile(125.0, 0.002, 0.0005),   # same-campus pair
         LinkProfile(12.5, 0.025, 0.002)),    # cross-site pair
        (1, 2),
    ),
}


class Topology:
    """Deterministic pair -> LinkProfile map for one preset + seed."""

    def __init__(self, preset: str = "lan", seed: int = 0):
        if preset not in _TIERS:
            raise ValueError(f"unknown topology preset {preset!r} "
                             f"(choose from {PRESETS})")
        self.preset = preset
        self.seed = seed
        self._cache: Dict[Tuple[str, str], LinkProfile] = {}
        self._access_cache: Dict[str, float] = {}

    def link(self, a: str, b: str) -> LinkProfile:
        if a == b:
            raise ValueError(f"no self-link for node {a!r}")
        pair = (a, b) if a <= b else (b, a)
        prof = self._cache.get(pair)
        if prof is None:
            tiers, weights = _TIERS[self.preset]
            if len(tiers) == 1:
                prof = tiers[0]
            else:
                h = hashlib.sha256(
                    f"{self.preset}:{self.seed}:{pair[0]}|{pair[1]}"
                    .encode()).digest()
                total = weights[-1]
                draw = int.from_bytes(h[:8], "big") % total
                idx = next(i for i, w in enumerate(weights) if draw < w)
                prof = tiers[idx]
            self._cache[pair] = prof
        return prof

    def access_mibps(self, node_id: str) -> float:
        """The node's symmetric access-port capacity (MiB/s): the aggregate
        rate cap across all its concurrent transfers under the fair-share
        model. Deterministic in (preset, seed, node)."""
        cap = self._access_cache.get(node_id)
        if cap is None:
            tiers, weights = _ACCESS[self.preset]
            if len(tiers) == 1:
                cap = tiers[0]
            else:
                h = hashlib.sha256(
                    f"{self.preset}:{self.seed}:access:{node_id}"
                    .encode()).digest()
                draw = int.from_bytes(h[:8], "big") % weights[-1]
                idx = next(i for i, w in enumerate(weights) if draw < w)
                cap = tiers[idx]
            self._access_cache[node_id] = cap
        return cap

    def base_cost_s(self, a: str, b: str, nbytes: int,
                    chunk_bytes: int) -> float:
        """Latency + block-serialized payload time, ignoring queueing and
        jitter — the ranking metric for nearest-replica selection."""
        prof = self.link(a, b)
        n_blocks = max(1, -(-int(nbytes) // int(chunk_bytes)))
        return prof.latency_s + n_blocks * prof.block_s(chunk_bytes)
