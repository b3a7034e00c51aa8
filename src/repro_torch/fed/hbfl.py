"""HBFL-style centralized multilevel FL baseline (paper §4.2 'Baseline').
Twin of ``repro.fed.hbfl``.

A trusted central aggregator FedAvgs every silo's local model each round and
pushes the global model back — the 'ideal' collaboration oracle UnifyFL is
compared against (paper Table 5 Run 1, Table 1 'Collab').

Both baselines share one round loop (``_run_rounds``); the multilevel case
is the same *edge-tier* operation the hierarchical subsystem runs per silo
(``repro_torch.edge.fleet.fedavg_up``, the ``weighted_sum`` kernel on the
card), just with the silos themselves as the participants of a single
trusted top-level aggregator.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.edge.fleet import fedavg_up
from repro_torch.fed.cluster import Cluster


def _run_rounds(clusters: List[Cluster], rounds: int, *,
                aggregate: bool) -> Dict:
    """The shared baseline loop: every silo trains a local round; with
    ``aggregate`` the top-level aggregator FedAvgs the silo models by total
    sample count and the next round starts from the global model."""
    history: List[Dict] = []
    global_params = None
    for r in range(rounds):
        submitted = []
        for c in clusters:
            if global_params is not None:
                c.params = global_params
            c.train_round()
            submitted.append((c.params,
                              sum(cl.n_samples for cl in c.clients)))
        entry: Dict = {"round": r}
        if aggregate:
            global_params = fedavg_up(submitted)
            entry["global"] = {c.silo_id: c.evaluate(global_params)
                               for c in clusters}
        entry["local"] = {c.silo_id: c.evaluate() for c in clusters}
        history.append(entry)
    out: Dict = {"history": history}
    if aggregate:
        out["global_params"] = global_params
    return out


def run_hbfl(clusters: List[Cluster], rounds: int) -> Dict:
    """Synchronous centralized multilevel FL. Returns metrics history."""
    return _run_rounds(clusters, rounds, aggregate=True)


def run_no_collab(clusters: List[Cluster], rounds: int) -> Dict:
    """Independent silos, no collaboration (paper Table 1 'No Collab')."""
    return _run_rounds(clusters, rounds, aggregate=False)
