"""repro_torch.edge — the hierarchical edge tier behind every silo (twin of
``repro.edge``).

The paper's multilevel-FL comparison made concrete: ``EdgeFleet`` manages
N simulated edge clients per silo (partial participation, Dirichlet data
shards, heterogeneous device-profile train delays) that train locally and
FedAvg up at the silo before the cross-silo round; edge<->silo traffic is
charged on the fabric's access ports (kind ``"edge"``), and edge nodes can
follow the chain as light clients (``repro_torch.chain.light``) instead of
full replicas. Configured entirely through ``FedConfig.edge_per_silo`` /
``edge_participation`` / ``edge_epochs`` / ``edge_light_clients``.

devices -- named device profiles (rpi4 / jetson-nano / laptop) +
           deterministic assignment and per-round delay draws
fleet   -- EdgeFleet (sampling, charged traffic, FedAvg-up) and
           ``fedavg_up``, the aggregation step shared with fed/hbfl.py
           (the ``weighted_sum`` kernel on the card)
"""
from repro_torch.edge.devices import (DEVICE_PROFILES, DeviceProfile,
                                      assign_profile, train_delay_s)
from repro_torch.edge.fleet import EdgeFleet, fedavg_up

__all__ = ["EdgeFleet", "fedavg_up", "DeviceProfile", "DEVICE_PROFILES",
           "assign_profile", "train_delay_s"]
