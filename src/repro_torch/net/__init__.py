"""repro_torch.net — simulated WAN fabric for the store network.

topology  -- per-link bandwidth/latency/jitter profiles; presets (lan,
             wan-uniform, wan-heterogeneous, paper-testbed)
fabric    -- transfer scheduler on SimEnv: chunked block charging, per-link
             serialization, DHT provider records, partitions/churn, in-flight
             cancellable transfers
gossip    -- proactive replication of announced CIDs to nearest peers
prefetch  -- async pull of announced peer CIDs into the decoded cache during
             the training window
faults    -- per-round / timed fault scenario injection
"""
from repro_torch.net.fabric import NetFabric, TransferRecord, UnreachableError
from repro_torch.net.faults import FaultInjector, apply_scenario
from repro_torch.net.gossip import GossipReplicator
from repro_torch.net.prefetch import Prefetcher
from repro_torch.net.topology import MIB, LinkProfile, PRESETS, Topology

__all__ = ["NetFabric", "TransferRecord", "UnreachableError", "FaultInjector",
           "apply_scenario", "GossipReplicator", "Prefetcher", "MIB",
           "LinkProfile", "PRESETS", "Topology"]
