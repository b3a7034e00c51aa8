"""EdgeFleet: the simulated edge population behind one silo. Twin of
``repro.edge.fleet``.

The paper's multilevel comparison (hierarchical FL) puts device-grade
participants *under* each silo-grade participant: edge clients hold small
Dirichlet shards of the silo's data, train locally, and FedAvg up at the
silo before the silo enters the cross-silo round. ``EdgeFleet`` is that
tier as a first-class subsystem instead of the old ``hbfl.py`` strawman:

  * **partial participation** — each round samples
    ``ceil(participation * N)`` clients with a deterministic per-(silo,
    round) RNG;
  * **heterogeneous devices** — every client carries a device profile
    (``devices.py``); its simulated train time is profile-drawn, and the
    fleet's round time is the *slowest sampled device* (devices run in
    parallel, the silo waits for the last upload);
  * **charged traffic** — model down (silo -> edge) and update up
    (edge -> silo) move on the fabric as kind ``"edge"`` transfers, so a
    fleet's fan-in hammers the silo's *access port* under the fair-share
    model exactly like a thousand silos hammer the orchestrator's;
  * **aggregation** — sampled results FedAvg by sample count through the
    same kernel-backed ``fedavg_params`` the cross-silo tier uses
    (``fedavg_up``: ``ops.weighted_sum``, the CUDA kernel for tensors on
    the card, with the weights copied to the card above 64 clients);
    clients whose shard is smaller than one batch are skipped
    (``stats['skipped_empty']``) — with hundreds of clients per silo,
    Dirichlet shards legitimately go sub-batch.

``traffic_round`` drives the sampling + charging + delay model without any
ML — the synthetic path ``edgebench`` sweeps at 10/100/1000 clients per
silo. With ``fabric=None`` transfers are free and only device delays count
(the Table 1/5 baselines run fabric-less).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import tree
from repro_torch.edge.devices import assign_profile, train_delay_s
from repro_torch.fed.aggregator import fedavg_params
from repro_torch.obs.metrics import StatsView


def fedavg_up(results: Sequence[Tuple]) -> Optional[object]:
    """Sample-weighted FedAvg of ``[(params, n_samples, ...), ...]`` — the
    one aggregation-up step shared by the edge tier and the hbfl baseline
    (a single trusted top-level aggregator is the same operation with
    silos as the participants)."""
    results = [r for r in results if r[1] > 0]
    if not results:
        return None
    return fedavg_params([r[0] for r in results],
                         [float(r[1]) for r in results])


class EdgeFleet:
    def __init__(self, silo_id: str, clients: List, *,
                 participation: float = 1.0, epochs: int = 1,
                 seed: int = 0):
        if not clients:
            raise ValueError(f"{silo_id}: an edge fleet needs clients")
        self.silo_id = silo_id
        self.clients = clients
        self.participation = float(participation)
        self.epochs = int(epochs)
        self.seed = int(seed)
        self.profiles = [assign_profile(silo_id, j, seed)
                         for j in range(len(clients))]
        self.stats = StatsView("edge", silo_id)
        self.fabric = None
        self.env = None
        self.round = 0
        self.last_participants: List[int] = []
        self._model_nbytes = 0

    # -- wiring -------------------------------------------------------------- #
    def attach(self, fabric=None, env=None) -> None:
        """Late-bind the fabric/engine (the orchestrator owns both); edge
        node ids register so transfers and access ports resolve."""
        self.fabric = fabric
        self.env = env
        if fabric is not None:
            for nid in self.node_ids:
                fabric.register_node(nid)

    @property
    def node_ids(self) -> List[str]:
        return [c.client_id for c in self.clients]

    # -- sampling ------------------------------------------------------------- #
    def sample(self, rnd: int) -> List[int]:
        """Deterministic partial-participation draw for round ``rnd``."""
        n = max(1, round(self.participation * len(self.clients)))
        rng = random.Random(f"edge|{self.silo_id}|{rnd}|{self.seed}")
        return sorted(rng.sample(range(len(self.clients)), n))

    # -- traffic + delay model ------------------------------------------------ #
    def _model_bytes(self, params) -> int:
        """The model's bytes as the reference counts them (each leaf's
        elements times its itemsize): the size charged on the fabric."""
        if self._model_nbytes == 0:
            self._model_nbytes = int(sum(
                p.numel() * p.element_size() for p in tree.leaves(params)))
        return self._model_nbytes

    def traffic_round(self, rnd: int, nbytes: int
                      ) -> Tuple[float, int, List[int]]:
        """Charge one round of fleet traffic (no ML): global model down to
        every sampled client, update up from each — kind ``"edge"``, both
        directions through the silo's access port — plus device train
        delays. Returns ``(sim_seconds, total_bytes, reachable_indices)``
        where sim_seconds is the slowest sampled device's down+train+up
        path (devices run in parallel)."""
        idxs = self.sample(rnd)
        rng = random.Random(f"edgedelay|{self.silo_id}|{rnd}|{self.seed}")
        slowest, total, reachable = 0.0, 0, []
        for j in idxs:
            delay = train_delay_s(self.profiles[j], self.epochs, rng)
            down_s = up_s = 0.0
            nid = self.clients[j].client_id
            if self.fabric is not None:
                from repro_torch.net.fabric import UnreachableError
                try:
                    down_s = self.fabric.transfer(
                        self.silo_id, nid, f"edge:down:r{rnd}", nbytes,
                        kind="edge")
                    up_s = self.fabric.transfer(
                        nid, self.silo_id, f"edge:up:r{rnd}", nbytes,
                        kind="edge")
                except UnreachableError:
                    continue        # silo partitioned from its own fleet
            total += 2 * nbytes
            reachable.append(j)
            slowest = max(slowest, down_s + delay + up_s)
            self.stats["train_s"] += delay
        self.stats["rounds"] += 1
        self.stats["participants"] += len(reachable)
        self.stats["bytes_down"] += nbytes * len(reachable)
        self.stats["bytes_up"] += nbytes * len(reachable)
        self.last_participants = reachable
        return slowest, total, reachable

    # -- the edge tier round --------------------------------------------------- #
    def train_round(self, params, *, local_epochs: Optional[int] = None
                    ) -> Tuple[object, Dict]:
        """One fleet round: sample, charge traffic, train each sampled
        client locally, FedAvg up by sample count. Returns
        ``(aggregated_params, metrics)`` — params unchanged when nothing
        trained (all sampled shards sub-batch or unreachable)."""
        nbytes = self._model_bytes(params)
        sim_s, total_bytes, idxs = self.traffic_round(self.round, nbytes)
        epochs = self.epochs if local_epochs is None else local_epochs
        results, losses, skipped = [], [], 0
        for j in idxs:
            c = self.clients[j]
            if c.n_samples < c.batch_size:
                skipped += 1        # shard too small for one batch: no step
                continue
            r = c.local_train(params, epochs)
            results.append(r)
            losses.append(r[2])
        self.stats["skipped_empty"] += skipped
        agg = fedavg_up(results)
        if self.env is not None:
            from repro_torch.obs import events as obsev
            self.env.emit(obsev.edge_round(self.silo_id, self.round,
                                           len(idxs), total_bytes))
        metrics = {
            "edge_participants": len(idxs),
            "edge_trained": len(results),
            "edge_skipped": skipped,
            "edge_sim_s": sim_s,
            "edge_bytes": total_bytes,
            "client_loss": float(sum(losses) / len(losses)) if losses
            else 0.0,
        }
        self.round += 1
        return (agg if agg is not None else params), metrics
