"""The port's edge tier (``repro_torch.edge``, the fleet wiring in the
builder, cluster and orchestrator, and ``fed.hbfl``) against
``repro.edge`` on shared seeds: the counterpart of ``tests/test_edge.py``.

What must be equal, not close: device profiles and delay draws (sha256 and
``random.Random``, copied verbatim), participation samples, the traffic
model's seconds and bytes on each package's fabric, ``skipped_empty``, and
on the plain ledger the picks, ledger height, submission times and every
round's edge metrics of a Sync and an Async run with the reference's init
carried across (``repro_torch.interop``). Tolerances:

- ``fedavg_up``: 1e-6 absolute on values of magnitude <= 4 (an M-term
  float32 weighted sum; the kernel's plain version sums in another order
  than XLA does).
- accuracy: ACC_TOL = 2/160 a silo on the global test set, loss 1e-5
  relative; the two runs take the same batches, and their parameters
  differ only by float32 rounding.
- client losses: 1e-5 relative (the same float32 rounding).

Runs over a fabric are held to the reference tests' invariants
(``tests/test_torch_light.py``): CIDs reach the replicated chain's
block-hash tie-breaks (ROADMAP.md §3, PR 17).
"""
import random

import jax
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JFed
from repro.configs import get_config as jget
from repro.core.builder import build_image_experiment as jbuild_exp
from repro.core.builder import global_eval as jglobal
from repro.core.simenv import SimEnv as JEnv
from repro.edge import EdgeFleet as JFleet
from repro.edge import assign_profile as jassign
from repro.edge import fedavg_up as jfedavg_up
from repro.edge import train_delay_s as jdelay
from repro.fed.hbfl import run_hbfl as jhbfl
from repro.fed.hbfl import run_no_collab as jno_collab
from repro.models import build_model as jbuild_model
from repro.net import NetFabric as JFabric
from repro.net import Topology as JTopology
from repro_torch.config import FedConfig as TFed
from repro_torch.configs import get_config as tget
from repro_torch.core.builder import build_image_experiment as tbuild_exp
from repro_torch.core.builder import global_eval as tglobal
from repro_torch.core.orchestrator import AsyncOrchestrator
from repro_torch.core.simenv import SimEnv as TEnv
from repro_torch.edge import DEVICE_PROFILES
from repro_torch.edge import EdgeFleet as TFleet
from repro_torch.edge import assign_profile as tassign
from repro_torch.edge import fedavg_up as tfedavg_up
from repro_torch.edge import train_delay_s as tdelay
from repro_torch.fed.client import Client
from repro_torch.fed.hbfl import run_hbfl as thbfl
from repro_torch.fed.hbfl import run_no_collab as tno_collab
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import build_model
from repro_torch.net import NetFabric as TFabric
from repro_torch.net import Topology as TTopology

ACC_TOL = 2 / 160
LOSS_REL = 1e-5
FEDAVG_ATOL = 1e-6
EDGE_KEYS = ("edge_participants", "edge_trained", "edge_skipped",
             "edge_sim_s", "edge_bytes")
PKG = {"ref": (JFed, jget, jbuild_exp), "port": (TFed, tget, tbuild_exp)}


class _Stub:
    def __init__(self, cid, n=0, bs=1):
        self.client_id, self.n_samples, self.batch_size = cid, n, bs


# --------------------------------------------------------------------------- #
# Devices, sampling and the traffic model
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("silo,seed", [("silo0", 0), ("silo2", 7),
                                       ("edge-hub", 123)])
def test_profiles_and_delays_are_bit_equal(silo, seed):
    """200 profile draws and two epochs' delays from one seeded RNG."""
    tp = [tassign(silo, j, seed) for j in range(200)]
    jp = [jassign(silo, j, seed) for j in range(200)]
    assert [(p.name, p.base_s, p.per_epoch_s, p.jitter_s) for p in tp] == \
        [(p.name, p.base_s, p.per_epoch_s, p.jitter_s) for p in jp]
    assert {p.name for p in tp} == set(DEVICE_PROFILES)
    for epochs in (1, 2):
        rt, rj = random.Random(seed), random.Random(seed)
        assert [tdelay(p, epochs, rt) for p in tp] == \
            [jdelay(p, epochs, rj) for p in jp]


@pytest.mark.parametrize("n,participation,seed", [(50, 0.2, 3), (20, 0.5, 2),
                                                  (200, 0.5, 0), (7, 1.0, 1),
                                                  (12, 0.25, 0)])
def test_participation_samples_equal_the_reference(n, participation, seed):
    stubs = [_Stub(f"e{j}") for j in range(n)]
    t = TFleet("silo1", stubs, participation=participation, seed=seed)
    j = JFleet("silo1", stubs, participation=participation, seed=seed)
    for rnd in range(6):
        assert t.sample(rnd) == j.sample(rnd) == sorted(t.sample(rnd))
    with pytest.raises(ValueError):
        TFleet("silo0", [])


@pytest.mark.parametrize("preset", [None, "lan", "wan-heterogeneous",
                                    "paper-testbed"])
def test_traffic_round_charges_what_the_reference_charges(preset):
    """Three rounds of fleet traffic (no ML) on each package's fabric, or
    none: the same seconds, bytes and reachable clients, and the same
    fabric and fleet counters."""
    def fleet(Fleet, Env, Fabric, Topology):
        f = Fleet("silo0", [_Stub(f"silo0/e{j}") for j in range(10)],
                  participation=0.5, epochs=2, seed=0)
        if preset is None:
            return f, None
        env = Env()
        fab = Fabric(env, Topology(preset, seed=0), seed=0)
        fab.register_node("silo0")
        f.attach(fab, env)
        return f, fab
    t, tfab = fleet(TFleet, TEnv, TFabric, TTopology)
    j, jfab = fleet(JFleet, JEnv, JFabric, JTopology)
    for rnd in range(3):
        got, want = t.traffic_round(rnd, 248_024), j.traffic_round(rnd,
                                                                   248_024)
        assert got == want
        assert len(got[2]) == 5 and got[1] == 2 * 248_024 * 5
    assert dict(t.stats) == dict(j.stats)
    if preset is not None:
        assert dict(tfab.stats) == dict(jfab.stats)
        assert tfab.stats["edge_bytes"] == 3 * 2 * 248_024 * 5


def test_model_bytes_are_the_reference_count():
    """The size charged on the fabric: the paper CNN's f32 leaves."""
    cfg = tget("paper-cnn")
    p = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    ref = jbuild_model(jget("paper-cnn")).init(jax.random.PRNGKey(0))
    want = JFleet("s", [_Stub("e")])._model_bytes(ref)
    assert TFleet("s", [_Stub("e")])._model_bytes(p) == want == 4 * 62_006


# --------------------------------------------------------------------------- #
# FedAvg up
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m", [1, 3, 10, 65, 100])
def test_fedavg_up_matches_the_reference(m):
    """M sample-weighted models (above 64 the kernel reads its weights on
    the card; on the CPU the plain version runs), a zero-count client
    dropped, within FEDAVG_ATOL of the reference."""
    rng = np.random.default_rng(m)
    models = [{"a": {"w": rng.uniform(-4, 4, (7, 5)).astype(np.float32)},
               "b": rng.uniform(-4, 4, (11,)).astype(np.float32)}
              for _ in range(m + 1)]
    counts = [int(c) for c in rng.integers(1, 60, m)] + [0]
    want = jfedavg_up([(p, n, 0.0) for p, n in zip(models, counts)])
    got = tfedavg_up([(params_from_numpy(p, "cpu"), n, 0.0)
                      for p, n in zip(models, counts)])
    got = params_to_numpy(got)
    for path in (("a", "w"), ("b",)):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=FEDAVG_ATOL)
    assert tfedavg_up([]) is None
    assert tfedavg_up([(params_from_numpy(models[0], "cpu"), 0, 0.0)]) is None


@pytest.mark.parametrize("n", [0, 3])
def test_a_sub_batch_shard_trains_nothing(n):
    """A client whose Dirichlet shard is empty or smaller than one batch
    (``min_size=0``) builds, and the fleet skips it; trained directly it
    takes no step and returns the params it got."""
    model = build_model(tget("paper-cnn"))
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            "y": rng.integers(0, 10, n).astype(np.int32)}
    c = Client("silo0/edge0", model, data, device="cpu", batch_size=4)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    out, count, loss = c.local_train(p, 1)
    assert count == n and loss == 0.0
    assert all(torch.equal(out[k][q], p[k][q]) for k in p for q in p[k])
    fleet = TFleet("silo0", [c], participation=1.0)
    agg, m = fleet.train_round(p)
    assert agg is p
    assert (m["edge_trained"], m["edge_skipped"]) == (0, 1)
    assert fleet.stats["skipped_empty"] == 1


# --------------------------------------------------------------------------- #
# The builder and the engines, on the plain ledger
# --------------------------------------------------------------------------- #

def _run(side, mode, *, rounds=2, init=None, **kw):
    Fed, get, build = PKG[side]
    base = dict(n_silos=3, clients_per_silo=2, rounds=rounds,
                local_epochs=1, mode=mode, scorer="accuracy",
                agg_policy="top_k", policy_k=2, edge_per_silo=8,
                edge_participation=0.5)
    base.update(kw)
    dev = {} if side == "ref" else {"device": "cpu"}
    orch = build(get("paper-cnn"), Fed(**base), n_train=400, n_test=160,
                 batch_size=8, seed=0, **dev)
    if init is None:
        init = jax.tree.map(np.asarray, orch.silos[0].cluster.params)
    for s in orch.silos:
        s.time_scale = 0.0
        if side == "port":
            s.cluster.params = params_from_numpy(init, "cpu")
    orch.run(rounds)
    return orch, init


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_edge_run_matches_the_reference(mode):
    """Two rounds, 3 silos x 8 edge clients at participation 0.5: the same
    edge shards, picks, ledger height, simulated submission times and,
    each round, the same edge participants, trained and skipped clients,
    simulated edge seconds and bytes; client losses and accuracy within
    tolerance."""
    ref, init = _run("ref", mode)
    port, _ = _run("port", mode, init=init)
    assert isinstance(port, AsyncOrchestrator) == (mode == "async")
    for t, j in zip(port.silos, ref.silos):
        tf, jf = t.cluster.edge_fleet, j.cluster.edge_fleet
        assert [c.client_id for c in tf.clients] == \
            [c.client_id for c in jf.clients]
        assert [c.n_samples for c in tf.clients] == \
            [c.n_samples for c in jf.clients]
        assert len(t.metrics) == len(j.metrics) == 2
        for mt, mj in zip(t.metrics, j.metrics):
            assert [mt[k] for k in EDGE_KEYS] == [mj[k] for k in EDGE_KEYS]
            assert mt["t"] == mj["t"] and mt["round"] == mj["round"]
            assert mt["client_loss"] == pytest.approx(mj["client_loss"],
                                                      rel=LOSS_REL)
        assert dict(tf.stats) == pytest.approx(dict(jf.stats))
    assert [s.pick_log for s in port.silos] == [s.pick_log for s in ref.silos]
    assert any(p["owners"] for s in port.silos for p in s.pick_log)
    assert sum(m["edge_skipped"] for s in port.silos for m in s.metrics) > 0
    assert port.ledger.height == ref.ledger.height
    assert port.ledger.verify()
    ja, ta = jglobal(ref), tglobal(port)
    for sid in ja:
        assert abs(ta[sid]["accuracy"] - ja[sid]["accuracy"]) <= ACC_TOL, sid
        assert ta[sid]["loss"] == pytest.approx(ja[sid]["loss"], rel=1e-4)


def test_builder_assembles_edge_fleets_and_round_trains():
    """Twin of the reference's builder test: 8 named edge clients a silo,
    one delegated round of 4 participants."""
    fed = TFed(n_silos=2, clients_per_silo=2, rounds=1, local_epochs=1,
               edge_per_silo=8, edge_participation=0.5)
    orch = tbuild_exp(tget("paper-cnn"), fed, n_train=400, n_test=100,
                      batch_size=4, seed=0, device="cpu")
    for s in orch.silos:
        fleet = s.cluster.edge_fleet
        assert [c.client_id for c in fleet.clients] == \
            [f"{s.silo_id}/edge{j}" for j in range(8)]
        assert s.cluster.clients is fleet.clients
    m = orch.silos[0].cluster.train_round()
    assert m["edge_participants"] == 4
    assert m["edge_trained"] + m["edge_skipped"] <= 4
    assert m["round"] == 1 and m["wall_s"] > 0
    assert orch.silos[0].cluster.edge_fleet.stats["rounds"] == 1


# --------------------------------------------------------------------------- #
# The centralized baselines
# --------------------------------------------------------------------------- #

def _clusters(side, init=None):
    Fed, get, build = PKG[side]
    fed = Fed(n_silos=2, clients_per_silo=2, rounds=2, local_epochs=1)
    dev = {} if side == "ref" else {"device": "cpu"}
    orch = build(get("paper-cnn"), fed, n_train=300, n_test=100, seed=0,
                 **dev)
    clusters = [s.cluster for s in orch.silos]
    if init is None:
        init = jax.tree.map(np.asarray, clusters[0].params)
    if side == "port":
        for c in clusters:
            c.params = params_from_numpy(init, "cpu")
    return clusters, init


@pytest.mark.parametrize("aggregate", [True, False])
def test_hbfl_and_no_collab_match_the_reference(aggregate):
    """Two rounds of ``run_hbfl`` (the trusted aggregator FedAvgs the silo
    models through ``fedavg_up``) or ``run_no_collab``: the same history
    shape, and every evaluation within tolerance of the reference's."""
    jc, init = _clusters("ref")
    tc, _ = _clusters("port", init)
    want = (jhbfl if aggregate else jno_collab)(jc, 2)
    got = (thbfl if aggregate else tno_collab)(tc, 2)
    assert set(got) == set(want) == ({"history", "global_params"}
                                     if aggregate else {"history"})
    assert [h["round"] for h in got["history"]] == [0, 1]
    for hg, hw in zip(got["history"], want["history"]):
        assert set(hg) == set(hw)
        for key in set(hg) - {"round"}:
            assert set(hg[key]) == {"silo0", "silo1"}
            for sid, ev in hg[key].items():
                assert abs(ev["accuracy"] - hw[key][sid]["accuracy"]) \
                    <= ACC_TOL, (key, sid)
                assert ev["loss"] == pytest.approx(hw[key][sid]["loss"],
                                                   rel=1e-4)
    if aggregate:
        g = params_to_numpy(got["global_params"])
        w = jax.tree.map(np.asarray, want["global_params"])
        for k in w:
            for q in w[k]:
                np.testing.assert_allclose(g[k][q], w[k][q], rtol=0,
                                           atol=1e-5)
