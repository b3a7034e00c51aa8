"""Edge device profiles: where heterogeneous train delays come from.

The paper's edge workload (Table 6) mixes Raspberry Pi and Jetson class
devices; an edge fleet is never uniform. Each simulated edge client is
assigned one named profile — deterministically, from a sha256 draw over
``(silo, index, seed)`` like the topology's link-tier assignment — and its
per-round training delay is ``base + epochs * per_epoch + U(0, jitter)``
simulated seconds, with the jitter drawn from the caller's seeded RNG so
runs are bit-reproducible.

Profiles are *simulated-clock* costs only: the actual gradient math runs
on the host at full speed (same convention as ``time_scale`` for silo
compute).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    base_s: float        # fixed per-round overhead (wakeup, load, serialize)
    per_epoch_s: float   # marginal cost of one local epoch
    jitter_s: float      # uniform jitter bound (thermal / scheduling noise)


DEVICE_PROFILES: Dict[str, DeviceProfile] = {
    "rpi4": DeviceProfile("rpi4", base_s=2.4, per_epoch_s=1.1,
                          jitter_s=0.6),
    "jetson-nano": DeviceProfile("jetson-nano", base_s=0.9, per_epoch_s=0.4,
                                 jitter_s=0.25),
    "laptop": DeviceProfile("laptop", base_s=0.3, per_epoch_s=0.12,
                            jitter_s=0.08),
}

# fleet mix: (profile, cumulative weight) — ~50% rpi4, 30% jetson, 20% laptop
_MIX: Tuple[Tuple[str, int], ...] = (("rpi4", 5), ("jetson-nano", 8),
                                     ("laptop", 10))


def assign_profile(silo_id: str, index: int, seed: int = 0) -> DeviceProfile:
    """Deterministic profile draw for edge client ``index`` of ``silo_id``."""
    h = hashlib.sha256(f"edge:{seed}:{silo_id}:{index}".encode()).digest()
    draw = int.from_bytes(h[:8], "big") % _MIX[-1][1]
    for name, cum in _MIX:
        if draw < cum:
            return DEVICE_PROFILES[name]
    return DEVICE_PROFILES[_MIX[-1][0]]


def train_delay_s(profile: DeviceProfile, epochs: int, rng) -> float:
    """One round's simulated training time on this device."""
    jitter = rng.uniform(0.0, profile.jitter_s) if profile.jitter_s else 0.0
    return profile.base_s + epochs * profile.per_epoch_s + jitter
