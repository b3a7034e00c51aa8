"""The port's replicated chain over the WAN fabric: partition and heal, kill
and restart from the WAL, and fail-fast fault configs.

These runs have 4 silos or fork the chain, so CIDs reach the scorer draw and
the chain's smallest-head-hash tie-break, and CIDs differ from the
reference's by float rounding: the port is held to the invariants the
reference's own tests assert (``tests/test_chain.py``,
``tests/test_recovery.py``), not to its block hashes. Every silo runs at
``time_scale=0``, so the windows model compute and the runs are
deterministic. The tests marked ``gpu`` hold a fabric's decoded models on
the card: they skip where no CUDA device is visible, and this file imports
no JAX, so they also run where only the port is installed.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.chain import LedgerView
from repro_torch.config import FaultScenario, FedConfig, NetConfig
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.builder import SiloSpec, build_image_experiment
from repro_torch.core.simenv import SimEnv
from repro_torch.core.store import StoreNetwork
from repro_torch.net import (FaultInjector, NetFabric, Prefetcher,
                             Topology)


def _orch(scenarios, *, mode="sync", wal_dir="", n_silos=4,
          clients_per_silo=2, delays=None, device="cpu", **kw):
    fed = FedConfig(n_silos=n_silos, clients_per_silo=clients_per_silo,
                    rounds=3, local_epochs=1, mode=mode, scorer="accuracy",
                    agg_policy="all", score_policy="median",
                    round_deadline_s=3.0, scorer_deadline_s=2.0,
                    net=NetConfig(preset="wan-heterogeneous",
                                  replication_factor=1, prefetch=True,
                                  scenarios=scenarios, wal_dir=wal_dir), **kw)
    delays = delays or [1.0 + 0.05 * i for i in range(n_silos)]
    orch = build_image_experiment(
        get_config("paper-cnn"), fed, n_train=240, n_test=120, seed=1,
        silo_specs=[SiloSpec(extra_train_delay=d) for d in delays],
        device=device)
    for s in orch.silos:
        s.time_scale = 0.0        # windows model compute: deterministic
    return orch


def _converged(orch):
    """Drain the gossip in flight; then one head, one contract state, every
    replica's chain valid, identical federation views."""
    orch.env.run()
    chain = orch.chain
    assert chain.converged(), chain.heads()
    assert len(set(chain.state_digests().values())) == 1
    assert all(rep.verify() for rep in chain.replicas.values())
    views = [v.contract.get_latest_models_with_scores()
             for v in chain.views.values()]
    assert all(v == views[0] for v in views)


def test_partition_e2e_forks_heals_and_converges():
    """Twin of ``tests/test_chain.py::test_partition_e2e_forks_heals_and_
    converges``: a sealer partition splits the swarm for a round, both
    sides keep sealing (fork observed), and after the heal every replica
    converges to one head and one contract state while the run completes."""
    scenarios = (
        FaultScenario(action="partition", node="silo2,silo3",
                      round=2, when="train"),
        FaultScenario(action="heal", round=3, when="train"),
    )
    orch = _orch(scenarios)
    orch.run(3)
    assert all(s.rounds_done == 3 for s in orch.silos)
    for s in orch.silos:
        assert isinstance(s.ledger, LedgerView)
        assert s.contract is s.ledger.contract      # read-your-replica
    assert orch.chain.totals("forks_observed") >= 1
    assert orch.chain.totals("reorgs") >= 1
    assert orch.chain.stats["undeliverable"] >= 1
    _converged(orch)
    final = orch.contract.get_round_models(3)
    assert final and any(e.scores for e in final)
    assert orch.fabric.stats["chain_bytes"] > 0
    # round marks carry the cumulative WAN and chain bytes
    marks = orch.round_log
    assert [m["round"] for m in marks] == [1, 2, 3]
    assert all(0 < m["chain_bytes"] < m["wan_bytes"] for m in marks)
    assert all(a["wan_bytes"] < b["wan_bytes"]
               for a, b in zip(marks, marks[1:]))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_kill_restart_converges(tmp_path, mode):
    """Twin of ``tests/test_recovery.py::test_kill_restart_converge_through_
    sync_engine``, and the same fault through the Async engine: silo2 is
    killed in round 2 (its replica wiped, only its WAL survives) and
    restarted in round 3; the federation completes, the restart replays
    from disk at zero fabric cost, and every replica ends identical. In
    Async the restarted silo re-enters its loop from an event and finishes
    its rounds."""
    scenarios = (
        FaultScenario(action="kill", node="silo2", round=2, when="train"),
        FaultScenario(action="restart", node="silo2", round=3, when="train"),
    )
    wal = str(tmp_path / "wal")
    orch = _orch(scenarios, mode=mode, wal_dir=wal, clients_per_silo=1)
    orch.run(3)
    chain = orch.chain
    assert chain.stats["kills"] == 1
    assert chain.stats["restarts"] == 1
    assert chain.stats["wal_replayed"] > 0            # disk did real work
    assert chain.stats["restart_fabric_bytes"] == 0   # ... for free
    victim = orch._by_id("silo2")
    assert victim.alive and victim.rounds_done == 3
    assert all(s.rounds_done == 3 for s in orch.silos)
    if mode == "async":
        assert any(note == "silo2:restart" for _, note in orch.env.trace)
    _converged(orch)
    # per-node WAL segments, the engine's replica included
    assert sorted(os.listdir(wal)) == sorted(
        [f"{s.silo_id}.jsonl" for s in orch.silos] + ["orchestrator.jsonl"])


def test_async_restart_drops_the_crashed_window(tmp_path):
    """silo2, a straggler (a 2 s window where the others take none), is
    killed and restarted at the same simulated instant, inside its first
    training window. The crashed incarnation's window does not complete
    after the restart: silo2 runs one loop and submits each of its rounds
    once. (The reference lets the stale window finish as well, so its
    silo2 ends with 4 rounds of 3: ROADMAP.md, queue 3.)"""
    scenarios = (
        FaultScenario(action="kill", node="silo2", round=2, when="train"),
        FaultScenario(action="restart", node="silo2", round=3, when="train"),
    )
    orch = _orch(scenarios, mode="async", wal_dir=str(tmp_path / "wal"),
                 n_silos=3, clients_per_silo=1, delays=[0.0, 0.0, 2.0],
                 compression="int8-delta")
    orch.run(3)
    victim = orch._by_id("silo2")
    assert victim.incarnation == 1 and victim.alive
    assert [s.rounds_done for s in orch.silos] == [3, 3, 3]
    t = [m["t"] for m in victim.metrics]       # a window each, plus stalls
    assert len(t) == 3 and t[0] == 2.0
    assert all(b - a >= 2.0 for a, b in zip(t, t[1:]))
    marks = [m["round"] for m in orch.round_log if m["silo"] == "silo2"]
    assert marks == [1, 2, 3]
    assert orch.chain.stats["kills"] == orch.chain.stats["restarts"] == 1
    _converged(orch)


def test_fault_injector_rejects_unknown_nodes():
    """Twin of ``tests/test_recovery.py::test_fault_injector_rejects_
    unknown_nodes``; the engine checks its scenarios when it wires the
    fabric, before any round runs."""
    env = SimEnv()
    fab = NetFabric(env, Topology("lan", seed=0), seed=0)
    for n in ("a", "b"):
        fab.register_node(n)
    sc = FaultScenario(action="down", node="zz", round=1)
    with pytest.raises(ValueError, match="unknown node"):
        FaultInjector(fab, [sc], nodes=["a", "b"])
    sc = FaultScenario(action="partition", node="a,ghost", round=1)
    with pytest.raises(ValueError, match="ghost"):
        FaultInjector(fab, [sc], nodes=["a", "b"])
    FaultInjector(fab, [FaultScenario(action="down", node="a", round=1)],
                  nodes=["a", "b"])
    orch = _orch((FaultScenario(action="kill", node="silo9", round=2),),
                 n_silos=3, clients_per_silo=1)
    assert orch.silos[0].rounds_done == 0
    with pytest.raises(ValueError, match="silo9"):
        orch.run(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
def test_prefetched_delta_chain_decodes_on_the_card():
    """Store nodes on the card: the prefetcher's landings (simulated-time
    events) decode a whole int8 model and two int8-delta links into the
    nodes' caches on ``cuda``, and the chain rebuilds there bit for bit as
    on CPU nodes."""
    _cuda()
    rng = np.random.default_rng(0)
    vs = [torch.from_numpy(rng.normal(0, 0.1, 4000).astype(np.float32))
          for _ in range(3)]
    vecs = {}
    for device in ("cpu", "cuda"):
        env = SimEnv()
        fab = NetFabric(env, Topology("wan-uniform", seed=3), seed=3)
        net = StoreNetwork()
        for n in ("a", "b", "c"):
            net.add_node(n, device)
        net.attach_fabric(fab)
        pf = Prefetcher(fab, net)
        fab.subscribe(pf.on_announce)
        a = net.nodes["a"]
        cids, base, base_cid = [], None, ""
        for i in range(3):
            v = sum(vs[:i + 1]).to(device)
            env_ = wire.encode_vec(v, "int8-delta", base_vec=base,
                                   base_cid=base_cid)
            cid = a.put(env_.to_store())
            fab.announce(cid, "a", base_cid=base_cid)
            base, base_cid = a.get_decoded(cid, a.wire_decoder()).vec(), cid
            cids.append(cid)
        env.run()
        b = net.nodes["b"]
        assert all(b.has_decoded(c) for c in cids)
        dm = b.get_decoded(cids[2], b.wire_decoder())
        assert b.stats["prefetch_hits"] == 1
        v = dm.vec()
        assert v.device.type == device and dm.q.device.type == device
        vecs[device] = (cids, v.cpu())
    assert vecs["cuda"][0] == vecs["cpu"][0]
    assert torch.equal(vecs["cuda"][1], vecs["cpu"][1])


@pytest.mark.gpu
def test_async_wan_run_keeps_decoded_models_on_the_card(tmp_path):
    """An Async int8-delta run over ``wan-heterogeneous`` with gossip,
    prefetch and a kill and restart, on the card: every decoded model the
    stores hold (demand, gossip and prefetch decodes) is a tensor on
    ``cuda``, the params stay there, and the recovery invariants hold."""
    device = _cuda()
    scenarios = (
        FaultScenario(action="kill", node="silo1", round=2, when="train"),
        FaultScenario(action="restart", node="silo1", round=3, when="train"),
    )
    orch = _orch(scenarios, mode="async", wal_dir=str(tmp_path / "wal"),
                 n_silos=3, delays=[2.0, 2.0, 4.0], device=device,
                 compression="int8-delta")
    orch.run(3)
    assert all(s.rounds_done == 3 for s in orch.silos)
    held = 0
    for s in orch.silos:
        assert s.cluster.params["fc1"]["w"].is_cuda
        for dm in s.store._decoded.values():
            for t in (dm.q, dm.scales, dm._vec):
                assert t is None or t.is_cuda
            held += 1
    assert held > 0
    chain = orch.chain
    assert chain.stats["kills"] == chain.stats["restarts"] == 1
    assert chain.stats["wal_replayed"] > 0
    assert chain.stats["restart_fabric_bytes"] == 0
    _converged(orch)
