"""The Async engine (paper §3.3) in both packages, at ``time_scale=0``.

3 silos x 2 clients, n_train=300, n_test=160, top_k with k=2, seed 0, and
the reference's init installed in the port's clusters. Host compute is not
charged to the simulated clock (``time_scale=0`` on every silo), so event
order, and with it who is scored and picked when, depends only on the
configuration; straggling comes from ``SiloSpec(extra_train_delay=...)``.
With 3 silos every model's scorer set is both other silos whatever its CID,
so the float noise that makes the packages' CIDs differ cannot change who
scores or who is picked: picks, ledger height, rounds and each silo's
simulated submission times must be equal.

Over a replicated chain (``FedConfig.net``) CIDs also reach the chain's
smallest-head-hash tie-break, and the reference itself moves its ledger
height and picks under a 1e-6 change of one bias there, so those runs are
held to the quantities that hash ties cannot move: per-round store WAN
bytes, rounds and submission times.

Accuracy tolerance: 2/160 per silo on the global test set. Both runs take
the same batches from the same seeds; their parameters differ only by
float32 rounding, which can flip a prediction that sits on a decision
boundary, not more.
"""
import jax
import numpy as np
import pytest

from repro.config import FaultScenario as JScenario
from repro.config import FedConfig as JFed
from repro.config import NetConfig as JNet
from repro.configs import get_config as jget
from repro.core.builder import SiloSpec as JSpec
from repro.core.builder import build_image_experiment as jbuild_exp
from repro.core.builder import global_eval as jglobal
from repro_torch.config import FaultScenario as TScenario
from repro_torch.config import FedConfig as TFed
from repro_torch.config import NetConfig as TNet
from repro_torch.configs import get_config as tget
from repro_torch.core.builder import SiloSpec as TSpec
from repro_torch.core.builder import build_image_experiment as tbuild_exp
from repro_torch.core.builder import global_eval as tglobal
from repro_torch.core.orchestrator import AsyncOrchestrator
from repro_torch.interop import params_from_numpy

ACC_TOL = 2 / 160
PKG = {"ref": (JFed, JNet, JScenario, JSpec, jget, jbuild_exp, jglobal),
       "port": (TFed, TNet, TScenario, TSpec, tget, tbuild_exp, tglobal)}


def _run(side, *, rounds=3, delays=(0.0, 0.0, 0.0), net=None, init=None,
         **kw):
    """Build and run one package's experiment at time_scale=0. ``net``:
    NetConfig kwargs (None: the single-replica ledger). ``init``: the
    reference's init (numpy) for the port's clusters. Returns the
    orchestrator and its init."""
    Fed, Net, Scenario, Spec, get, build, _ = PKG[side]
    if net is not None:
        net = dict(net)
        net["scenarios"] = tuple(Scenario(**s) for s in net.get("scenarios",
                                                                ()))
        net = Net(**net)
    base = dict(n_silos=3, clients_per_silo=2, rounds=rounds, mode="async",
                scorer="accuracy", agg_policy="top_k", policy_k=2, net=net)
    base.update(kw)
    dev = {} if side == "ref" else {"device": "cpu"}
    orch = build(get("paper-cnn"), Fed(**base), partition="niid", alpha=0.2,
                 n_train=300, n_test=160, seed=0,
                 silo_specs=[Spec(extra_train_delay=d) for d in delays],
                 **dev)
    if init is None:
        init = jax.tree.map(np.asarray, orch.silos[0].cluster.params)
    for s in orch.silos:
        s.time_scale = 0.0
        if side == "port":
            s.cluster.params = params_from_numpy(init, "cpu")
    orch.run(rounds)
    return orch, init


def _both(**kw):
    ref, init = _run("ref", **kw)
    port, _ = _run("port", init=init, **kw)
    return ref, port


def _times(orch):
    return [[m["t"] for m in s.metrics] for s in orch.silos]


def _store_bytes(orch):
    """Per-round-mark store WAN bytes (consensus gossip taken out)."""
    marks = [m["wan_bytes"] - m["chain_bytes"] for m in orch.round_log]
    return [b - a for a, b in zip([0] + marks, marks)]


@pytest.mark.parametrize("compression", ["none", "int8", "int8-delta"])
def test_async_matches_reference(compression):
    """Three Async rounds, silo2 straggling by 0.5 s a round: the same picks
    (silo1 and silo2 merge scored peers from round 2), ledger height,
    rounds, submission times and round marks; accuracy within ACC_TOL."""
    ref, port = _both(compression=compression, delays=(0.0, 0.0, 0.5))
    assert isinstance(port, AsyncOrchestrator)
    assert [s.pick_log for s in port.silos] == [s.pick_log for s in ref.silos]
    assert any(p["owners"] for s in port.silos for p in s.pick_log)
    assert port.ledger.height == ref.ledger.height
    assert port.ledger.verify()
    assert [s.rounds_done for s in port.silos] == [3, 3, 3]
    assert _times(port) == _times(ref)
    assert [(m["round"], m["silo"], m["t"]) for m in port.round_log] == \
        [(m["round"], m["silo"], m["t"]) for m in ref.round_log]
    ja, ta = jglobal(ref), tglobal(port)
    for sid in ja:
        assert abs(ta[sid]["accuracy"] - ja[sid]["accuracy"]) <= ACC_TOL, sid


def test_async_beats_sync_with_straggler_as_reference():
    """Twin of ``tests/test_system.py::test_async_runs_and_is_faster_than_
    sync_with_straggler`` (paper §4.2.4), in simulated seconds: the fast
    silos finish before Sync's barrier-bound run, at the reference's
    times."""
    kw = dict(rounds=2, delays=(0.0, 0.0, 2.0), agg_policy="all",
              compression="none")
    ref_async, init = _run("ref", **kw)
    runs = {"ref": (ref_async, _run("ref", mode="sync", **kw)[0]),
            "port": (_run("port", init=init, **kw)[0],
                     _run("port", init=init, mode="sync", **kw)[0])}
    done, sync_now = {}, {}
    for side, (asyn, sync) in runs.items():
        fast = [s for s in asyn.silos if s.extra_train_delay == 0.0]
        done[side] = max(m["t"] for s in fast for m in s.metrics)
        sync_now[side] = sync.env.now
    assert done["port"] == done["ref"]
    assert sync_now["port"] == sync_now["ref"] == 4.0
    assert done["port"] < sync_now["port"]


def test_async_round_phased_down_fault_as_reference():
    """Twin of ``tests/test_net.py::test_async_round_phased_fault_injection``:
    a round-phased ``down`` fires once, on the first silo's transition into
    round 2; the victim stops, the survivors finish all rounds, as in the
    reference."""
    net = dict(preset="lan", replication_factor=0, prefetch=False,
               scenarios=(dict(action="down", node="silo2", round=2,
                               when="train"),))
    ref, port = _both(net=net, agg_policy="all", score_policy="median",
                      compression="none")
    victim = port._by_id("silo2")
    assert not victim.alive and victim.rounds_done < 3
    assert all(s.rounds_done == 3 for s in port.silos if s is not victim)
    downs = [note for _, note in port.env.trace if note == "net:down:silo2"]
    assert len(downs) == 1
    assert [s.rounds_done for s in port.silos] == \
        [s.rounds_done for s in ref.silos]
    assert _times(port) == _times(ref)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_store_wan_bytes_match_reference(mode):
    """Per-round store WAN bytes over ``wan-uniform`` with gossip and
    prefetch, for int8 and int8-delta: equal to the reference's, mark for
    mark, with the same rounds. Each store node pulls each model once,
    by prefetch, gossip or demand fetch, whichever comes first, so the
    bytes do not depend on the order in which transfers land. In Async no
    silo waits on a training window, so no score lands before the next
    pull and the submission times are equal too; Sync's fetch stalls queue
    behind chain gossip, whose fork ties fall by block hash."""
    net = dict(preset="wan-uniform", replication_factor=1, prefetch=True)
    for comp in ("int8", "int8-delta"):
        ref, port = _both(net=net, compression=comp, mode=mode,
                          agg_policy="all", score_policy="median")
        assert port.ledger.verify()
        assert [s.rounds_done for s in port.silos] == [3, 3, 3]
        if mode == "async":
            assert _times(port) == _times(ref)
        got = _store_bytes(port)
        assert got == _store_bytes(ref), comp
        assert all(b >= 0 for b in got) and sum(got) > 0


def test_delta_wire_halves_sync_store_wan_bytes():
    """Twin of ``tests/test_net.py::test_delta_wire_cuts_wan_bytes_per_
    round`` (Sync over ``wan-uniform``, gossip and prefetch; a 1 s training
    window stands in for the host compute the reference charges): from
    round 2 on, int8-delta envelopes move at most half of int8's store WAN
    bytes. Which prefetches land inside a window depends on chain traffic,
    whose fork ties fall by block hash, so this run is held to the
    reference test's bound, not to its byte counts."""
    net = dict(preset="wan-uniform", replication_factor=1, prefetch=True)
    per = {}
    for comp in ("int8", "int8-delta"):
        port, _ = _run("port", net=net, compression=comp, mode="sync",
                       delays=(1.0, 1.0, 1.0), agg_policy="all",
                       score_policy="median")
        assert port.ledger.verify()
        per[comp] = _store_bytes(port)
        assert all(b > 0 for b in per[comp])
    for r in (1, 2):
        assert per["int8-delta"][r] <= 0.5 * per["int8"][r], (r, per)


def test_restart_within_a_window_runs_one_loop_where_the_reference_runs_two(
        tmp_path):
    """silo2 (a 2 s window, the others none) is killed and restarted at one
    simulated instant, inside its first window. The reference lets the
    crashed window finish after the restart while ``_resume_loop`` starts a
    second loop (``src/repro/core/orchestrator.py:292-293``, ``:548-558``),
    so its silo2 submits 4 rounds of 3; the port drops the crashed
    incarnation's window and runs 3. The other silos match."""
    net = dict(preset="wan-heterogeneous", replication_factor=1,
               prefetch=True,
               scenarios=(dict(action="kill", node="silo2", round=2,
                               when="train"),
                          dict(action="restart", node="silo2", round=3,
                               when="train")))
    kw = dict(delays=(0.0, 0.0, 2.0), compression="int8-delta")
    ref, init = _run("ref", net={**net, "wal_dir": str(tmp_path / "ref")},
                     **kw)
    port, _ = _run("port", net={**net, "wal_dir": str(tmp_path / "port")},
                   init=init, **kw)
    for orch in (ref, port):
        assert orch.chain.stats["kills"] == orch.chain.stats["restarts"] == 1
    assert [s.rounds_done for s in ref.silos] == [3, 3, 4]
    assert [s.rounds_done for s in port.silos] == [3, 3, 3]
