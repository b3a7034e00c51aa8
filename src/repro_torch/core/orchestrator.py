"""UnifyFL orchestration engines (paper §3.1–§3.3).

Twin of ``repro.core.orchestrator``. ``SiloRuntime`` wires one FL cluster to
the ledger/contract and its store node. ``SyncOrchestrator`` runs the
phase-locked cycle (training window -> scoring window -> finalize);
stragglers that miss the submission window are deferred to the next round
and late scores are disregarded, exactly per §3.2. Scoring is per model
(accuracy or loss, batched per scorer) or MultiKRUM over the whole round.
``AsyncOrchestrator`` lets every silo loop independently; the contract
assigns scorers from idle aggregators the moment a CID lands (§3.3).
Fault tolerance: scorer reassignment on deadline, CAS-backed
checkpoint/restart, and, over a fabric, kill and restart from the WAL.

Orchestration state lives in the single-replica ``Ledger``, or, when
``FedConfig.net`` configures a network fabric, in one ``repro_torch.chain``
replica per silo (plus one for the engine's own control txs): every submit
goes via the submitter's *local* replica (sealed immediately, gossiped as
charged fabric transfers) and every read is read-your-replica — stale
during partitions, reconciled by fork choice + contract re-execution after
the heal. A tx that reverts against a stale local replica retries after a
short resync delay. With ``FedConfig.edge_per_silo`` every silo trains
through its ``EdgeFleet`` (``repro_torch.edge``), whose simulated cost
enters the silo's training window; with ``edge_light_clients`` the sampled
edge nodes light-verify their silo's submission (``chain.LightSync``).
"""
from __future__ import annotations

import hashlib
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.config import SCORERS, FedConfig, SimConfig
from repro_torch.core import wire
from repro_torch.core.contract import UnifyFLContract
from repro_torch.core.ledger import Ledger
from repro_torch.core.policies import select_models
from repro_torch.core.scoring import multikrum_scores_for_decoded
from repro_torch.core.simenv import SimEnv
from repro_torch.core.store import StoreNetwork, StoreNode, store_tensor
from repro_torch.fed import scorebatch
from repro_torch.fed.cluster import Cluster
from repro_torch.kernels import ops
from repro_torch.obs import Observability, events as obsev


@dataclass
class SiloPolicy:
    agg_policy: str = "all"
    score_policy: str = "median"
    k: int = 2


ORCH_NODE = "orchestrator"   # the engine's own chain replica / tx sender
CHAIN_RETRY_S = 0.25         # resubmit delay after a stale-replica revert
CHAIN_RETRIES = 8            # bounded: 8 x 0.25s covers any preset's RTT
COLLUDE_SCORE = 0.99         # the inflated score a colluding clique submits


class SiloRuntime:
    """One organization: cluster + store node + ledger client."""

    def __init__(self, cluster: Cluster, store: StoreNode,
                 contract: UnifyFLContract, env: SimEnv, fed: FedConfig, *,
                 policy: Optional[SiloPolicy] = None,
                 extra_train_delay: float = 0.0,
                 extra_score_delay: float = 0.0,
                 time_scale: float = 1.0):
        self.cluster = cluster
        self.store = store
        self.ledger: Optional[Ledger] = None  # bound late via bind_ledger
        self.contract = contract
        self.env = env
        self.fed = fed
        self.policy = policy or SiloPolicy(fed.agg_policy, fed.score_policy,
                                           fed.policy_k)
        self.extra_train_delay = extra_train_delay
        self.extra_score_delay = extra_score_delay
        self.time_scale = time_scale
        self.alive = True
        # bumped by fail(): work a crashed incarnation scheduled (a training
        # or scoring window, a resubmit) does not complete after a restart
        self.incarnation = 0
        self.rounds_done = 0
        self.last_cid: Optional[str] = None
        # the silo's last announced model CID: the delta-coding base its next
        # envelope references (receivers resolve it from their own stores)
        self.last_global_cid: Optional[str] = None
        self.last_self_score = float("-inf")
        self.metrics: List[Dict] = []
        # injected scorer fault (adversarial scenarios): None, or a
        # ("collude", clique) / ("byzantine", _) pair set by the fault layer
        self.scorer_fault: Optional[tuple] = None
        # per-round aggregation picks ({round, owners})
        self.pick_log: List[Dict] = []
        if fed.scorer not in SCORERS:
            raise ValueError(f"unknown scorer {fed.scorer!r} "
                             f"(choose from {SCORERS})")
        self.score_method = fed.scorer if fed.scorer in ("accuracy", "loss") \
            else "accuracy"
        self._rng = random.Random(cluster.silo_id)
        self._flat_spec = None  # cached flatten spec of this config's params
        self._announces = 0     # envelopes announced (keyframe cadence)
        # bound by the orchestrator when fed.edge_light_clients: the hub
        # through which this silo's edge fleet follows the chain
        self.light_sync = None

    # ------------------------------------------------------------------ #
    @property
    def silo_id(self) -> str:
        return self.cluster.silo_id

    def bind_ledger(self, ledger):
        self.ledger = ledger
        contract = getattr(ledger, "contract", None)
        if contract is not None:
            self.contract = contract

    def _submit(self, method: str, *, _retries: int = 0, **args):
        """Submit a tx; a revert retries after a short delay, bounded, and an
        exhausted or non-retried revert is traced and dropped (the paper's
        'blockchain will no longer accept' semantics)."""
        try:
            return self.ledger.submit(self.silo_id, method,
                                      logical_time=self.env.now, **args)
        except PermissionError:
            if _retries > 0 and self.alive:
                inc = self.incarnation
                self.env.schedule(
                    CHAIN_RETRY_S,
                    lambda: (self._submit(method, _retries=_retries - 1,
                                          **args)
                             if self._current(inc) else None),
                    f"{self.silo_id}:resubmit:{method}")
            else:
                self.env.emit(obsev.tx_revert(self.silo_id, method))
            return None

    def register(self):
        self._submit("register")

    def heartbeat(self):
        if self.alive:
            self._submit("heartbeat")

    def _current(self, inc: int) -> bool:
        """Alive, and still the incarnation that scheduled the work."""
        return self.alive and self.incarnation == inc

    def fail(self):
        """Crash the silo (stops reacting to events). What it had in flight
        is lost with the process: a restart before that work's event fires
        does not bring it back (the reference lets it complete, so a silo
        killed and restarted within one window ran two loops)."""
        self.alive = False
        self.incarnation += 1
        # a crashed silo's open phase span ends here, marked aborted
        self.env.tracer.close_track(f"{self.silo_id}/phases", self.env.now)

    # -- training ---------------------------------------------------------- #
    def flat_spec(self):
        """Flatten spec of this silo's params (derived once per config)."""
        if self._flat_spec is None:
            self._flat_spec = ops.make_flatten_spec(self.cluster.params)
        return self._flat_spec

    def _read_contract(self) -> UnifyFLContract:
        """The contract view aggregation reads: the live head (default) or,
        with ``fed.finality_depth = k > 0``, the canonical chain truncated k
        blocks below head."""
        k = self.fed.finality_depth
        if k > 0 and self.ledger is not None:
            return self.ledger.finalized_contract(k)
        return self.contract

    def get_decoded(self, cid: str) -> wire.DecodedModel:
        """Pull a peer model via the store's decoded cache: fetched/decoded
        at most once per silo, int8 payloads kept packed for the fused
        kernels."""
        return self.store.get_decoded(cid, self.store.wire_decoder())

    def pull_and_merge(self):
        """Paper step 4-5: query orchestrator, pick models by policy, merge.

        Runs in flat-vector space: own params flatten against the cached
        spec, quantized peers flow straight into the fused weighted sum, and
        the merged vector unflattens into ``cluster.params`` exactly once.
        Peer pulls may cross the WAN fabric: their transfer time accumulates
        in the store node and is folded into the next training duration;
        unreachable peers (partition/churn) are skipped, not fatal.
        With ``fed.reputation_weighted`` the per-model score collapse is
        weighted by on-chain reputation."""
        src = self._read_contract()
        entries = src.get_latest_models_with_scores(exclude_owner=self.silo_id)
        reputation = dict(src.reputation) if self.fed.reputation_weighted \
            else None
        picked = select_models(entries, agg_policy=self.policy.agg_policy,
                               score_policy=self.policy.score_policy,
                               k=self.policy.k,
                               self_score=self.last_self_score, rng=self._rng,
                               reputation=reputation)
        self.pick_log.append({"round": self.rounds_done + 1,
                              "owners": sorted(c.owner for c in picked)})
        if not picked:
            return 0
        peers = []
        for c in picked:  # may hit IPFS peers over the fabric
            try:
                dm = self.get_decoded(c.cid)
                if dm.needs_base:
                    dm.vec()  # resolve the delta base chain (may fetch)
                peers.append(dm)
            except (KeyError, IOError):
                self.env.emit(obsev.pull_fail(self.silo_id, c.cid))
        if not peers:
            return 0
        weights = [1.0] * (1 + len(peers))
        own_vec, _ = ops.flatten_pytree(self.cluster.params, self.flat_spec())
        new_vec = self.cluster.aggregator.apply_cross_silo_vec(
            own_vec, peers, weights)
        self.cluster.params = ops.unflatten_pytree(new_vec, self.flat_spec())
        return len(peers)

    def _delta_base(self):
        """(base_cid, base_vec) for delta coding: the silo's last announced
        model as receivers decode it.

        Every ``fed.keyframe_every``-th announced envelope ships whole (no
        base), so a late joiner never walks more than ``keyframe_every - 1``
        delta links."""
        if self.last_global_cid is None or \
                not wire.resolve_method(self.fed.compression).endswith("-delta"):
            return ("", None)
        k = self.fed.keyframe_every
        if k > 0 and self._announces % k == 0:
            return ("", None)
        try:
            return (self.last_global_cid,
                    self.get_decoded(self.last_global_cid).vec())
        except (KeyError, IOError):
            return ("", None)

    def _encode(self):
        """Wire-encode this silo's params (``repro_torch.core.wire``)."""
        return wire.encode_update(self.cluster.params, self.fed,
                                  spec=self.flat_spec(),
                                  base=self._delta_base()).to_store()

    def train_and_submit(self, on_done: Callable):
        """Run a local FL round; put weights in the store; submit the CID."""
        if not self.alive:
            return
        t0 = time.perf_counter()
        m = self.cluster.train_round()
        compute = (time.perf_counter() - t0) * self.time_scale
        fleet = self.cluster.edge_fleet
        # hierarchical mode: the edge tier's simulated cost (slowest sampled
        # device's down+train+up path) enters the clock alongside the
        # silo-side compute; sampled clients are the awake set for head
        # pushes until the next round's draw
        edge_s = m.get("edge_sim_s", 0.0)
        if fleet is not None and self.light_sync is not None:
            self.light_sync.set_awake(
                self.silo_id, [fleet.clients[j].client_id
                               for j in fleet.last_participants])
        # WAN time spent pulling peer models for this round's merge enters
        # the simulated clock here (network charge is not time_scale'd)
        net_wait = self.store.drain_transfer_time()
        duration = compute + edge_s + self.extra_train_delay + net_wait
        tr = self.env.tracer
        t0_sim = self.env.now
        track = f"{self.silo_id}/phases"
        if net_wait > 0:
            # the pulls happened during pull_and_merge; their WAN charge
            # stalls the head of this round's window
            tr.span_at("phase.fetch-stall", track, t0_sim, t0_sim + net_wait,
                       round=self.rounds_done + 1)
        sp = tr.begin("phase.edge" if fleet is not None else "phase.train",
                      track, t0_sim, round=self.rounds_done + 1)
        inc = self.incarnation

        def finish():
            if not self._current(inc):
                return
            tr.end(sp, self.env.now)
            payload = self._encode()
            cid = self.store.put(payload)
            self.last_cid = cid
            self.last_global_cid = cid
            self._announces += 1
            fab = self.store.fabric
            if fab is not None:
                # advertise the fresh CID (and its delta base, so replication
                # and prefetch can move the base chain alongside the delta)
                fab.announce(cid, self.silo_id,
                             base_cid=wire.base_cid_of_store(payload))
            ev = self.cluster.evaluate()
            self.last_self_score = ev["accuracy"] if self.fed.scorer != "loss" \
                else -ev["loss"]
            self.metrics.append({"round": self.rounds_done, "t": self.env.now,
                                 "local": ev, **m})
            # the submission doubles as the heartbeat (the contract refreshes
            # it in tx_submit_model): the liveness signal the deadline-based
            # scorer reassignment keys on (paper §3.2)
            self._submit("submit_model", cid=cid, _retries=CHAIN_RETRIES)
            if self.light_sync is not None:
                # the round's sampled edge clients light-verify that their
                # silo's submission landed: header + Merkle inclusion proof
                # round-trips on the ctl lane, never full block replay
                lcs = None
                if fleet is not None:
                    lcs = [self.light_sync.clients[nid] for nid in
                           (fleet.clients[j].client_id
                            for j in fleet.last_participants)
                           if nid in self.light_sync.clients]
                self.light_sync.verify_submission(self.silo_id, clients=lcs)
            on_done(self, cid)

        self.env.schedule(duration, finish, f"{self.silo_id}:submit")

    # -- scoring ------------------------------------------------------------- #
    def score_round(self, cids: Sequence[str]):
        """Score every assigned CID of a round in ONE batched engine pass.

        All K pulled models stack through the q8-direct ingest and evaluate
        in one pass with one device->host transfer; the per-model scores
        fan back into the ledger. The simulated score ``duration`` derives
        from the measured batched cost."""
        cids = list(cids)
        if not self.alive or not cids:
            return
        self._submit("set_busy", busy=True)
        t0 = time.perf_counter()
        decoded, kept = [], []
        for cid in cids:
            try:
                dm = self.get_decoded(cid)
                if dm.needs_base:
                    dm.vec()  # resolve the base now
                decoded.append(dm)
                kept.append(cid)
            except (KeyError, IOError):
                # model unreachable (partition/churn): drop this assignment
                self.env.emit(obsev.score_fetch_fail(self.silo_id, cid))
        if not kept:
            self._submit("set_busy", busy=False)
            return
        scores = scorebatch.score_round_batch(
            self.cluster, decoded, self.flat_spec(), method=self.score_method)
        compute = (time.perf_counter() - t0) * self.time_scale
        net_wait = self.store.drain_transfer_time()
        duration = compute + self.extra_score_delay + net_wait
        tr = self.env.tracer
        t0_sim = self.env.now
        track = f"{self.silo_id}/phases"
        if net_wait > 0:
            tr.span_at("phase.fetch-stall", track, t0_sim, t0_sim + net_wait,
                       k=len(kept))
        sp = tr.begin("phase.score", track, t0_sim, k=len(kept))
        inc = self.incarnation

        def finish():
            if not self._current(inc):
                return
            tr.end(sp, self.env.now)
            for cid, score in zip(kept, scores):
                val = self._score_value(cid, float(score))
                if self.fed.commit_reveal:
                    # commit H(score|salt) first, reveal immediately after;
                    # the contract verifies the reveal against the commitment
                    salt = hashlib.sha256(
                        f"{self.silo_id}|{cid}".encode()).hexdigest()[:16]
                    self._submit(
                        "commit_score", cid=cid,
                        commit=UnifyFLContract.score_commitment(val, salt),
                        _retries=CHAIN_RETRIES)
                    self._submit("submit_score", cid=cid, score=val,
                                 salt=salt, _retries=CHAIN_RETRIES)
                else:
                    self._submit("submit_score", cid=cid, score=val,
                                 _retries=CHAIN_RETRIES)
            self._submit("set_busy", busy=False)

        self.env.schedule(duration, finish,
                          f"{self.silo_id}:score:{kept[0][:8]}x{len(kept)}")

    def _score_value(self, cid: str, score: float) -> float:
        """Apply an injected scorer fault: a colluding clique inflates
        clique-owned models (and stays honest elsewhere), a byzantine scorer
        inverts every score. The perturbed value is what gets committed AND
        revealed — adversaries are internally consistent, so only settlement
        catches them."""
        if self.scorer_fault is None:
            return score
        mode, clique = self.scorer_fault
        if mode == "collude":
            entry = self.contract.models.get(cid)
            if entry is not None and entry.owner in clique:
                return COLLUDE_SCORE
            return score
        if mode == "byzantine":
            return min(1.0, max(0.0, 1.0 - score))
        return score

    def score_async(self, cid: str, owner: str):
        """Single-CID assignment (Async engine / scorer reassignment): a
        K=1 batch through the same engine."""
        if owner == self.silo_id:
            return
        self.score_round([cid])

    # -- checkpoint / restart -------------------------------------------------- #
    def checkpoint(self) -> str:
        state = {"params": self.cluster.params,
                 "round": np.asarray(self.rounds_done)}
        return self.store.put(state)

    def restore_from(self, cid: str):
        state = self.store.get(cid)
        self.cluster.params = _rebuild_like(self.cluster.params,
                                            {k: v for k, v in state.items()
                                             if k.startswith("['params']")})
        return state


def _rebuild_like(like, flat: Dict[str, np.ndarray]):
    """Rebuild params from the store's flat path->array dict by flatten
    order (sorted keys on both sides), on ``like``'s devices and dtypes."""
    items = tree.leaves_with_paths(like)
    vals = list(flat.values())
    keys = list(flat.keys())
    if len(vals) != len(items):
        raise ValueError(f"leaf count mismatch {len(vals)} != {len(items)}")
    cast = []
    for i, (v, (_, l)) in enumerate(zip(vals, items)):
        t = store_tensor(v)
        if t.numel() != l.numel():
            raise ValueError(
                f"shape mismatch at leaf {i} ({keys[i]!r}): stored "
                f"{tuple(t.shape)} cannot reshape to expected "
                f"{tuple(l.shape)}")
        cast.append(t.reshape(l.shape).to(device=l.device, dtype=l.dtype))
    return tree.unflatten([p for p, _ in items], cast)


# --------------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------------- #

class BaseOrchestrator:
    def __init__(self, fed: FedConfig, *, ledger_path: Optional[str] = None):
        wire.resolve_method(fed.compression)   # an unknown method fails here
        self.fed = fed
        # observability bundle: null tracer + registry when fed.obs is unset
        # or disabled, so the hot paths stay no-op
        self.obs = Observability(fed.obs)
        sim = fed.sim if fed.sim is not None else SimConfig()
        self.env = SimEnv(trace_cap=self.obs.cfg.trace_cap,
                          batch_epsilon_s=sim.batch_epsilon_s,
                          compact_frac=sim.compact_frac,
                          compact_min=sim.compact_min,
                          reference=sim.reference)
        self.env.tracer = self.obs.tracer
        self.network = StoreNetwork()
        self.contract = UnifyFLContract(mode=fed.mode)
        self.silos: List[SiloRuntime] = []
        self._ledger_path = ledger_path
        self.ledger = None        # Ledger (single-replica) or chain.LedgerView
        self.chain = None         # chain.ChainNetwork in replicated mode
        self.light_sync = None    # chain.LightSync when fed.edge_light_clients
        self.fabric = None
        self.prefetcher = None
        self.gossip = None
        self._fault_injector = None
        # Async sets this to its per-silo loop so a restarted silo resumes
        self._resume_loop: Optional[Callable[[SiloRuntime], None]] = None
        # per-round marks: {round, silo, t, wan_bytes, chain_bytes}
        self.round_log: List[Dict] = []

    def add_silo(self, cluster: Cluster, **kw) -> SiloRuntime:
        store = self.network.add_node(cluster.silo_id, cluster.device)
        self.obs.adopt(store.stats)
        silo = SiloRuntime(cluster, store, self.contract, self.env,
                           self.fed, **kw)
        self.silos.append(silo)
        return silo

    def _build_net(self):
        """Stand up the simulated WAN fabric described by ``fed.net``."""
        from repro_torch.net import (FaultInjector, GossipReplicator,
                                     NetFabric, Prefetcher, Topology)
        net = self.fed.net
        topo = Topology(net.preset, seed=net.seed)
        self.fabric = NetFabric(self.env, topo, chunk_bytes=net.chunk_bytes,
                                seed=net.seed,
                                bandwidth_model=net.bandwidth_model,
                                trace_cap=net.transfer_trace_cap,
                                qos_weights=net.qos_weights)
        self.obs.adopt(self.fabric.stats)
        self.network.attach_fabric(self.fabric)
        if net.replication_factor > 0:
            self.gossip = GossipReplicator(self.fabric, self.network,
                                           factor=net.replication_factor)
            self.obs.adopt(self.gossip.stats)
            self.fabric.subscribe(self.gossip.on_announce)
        if net.prefetch:
            # lands decoded models on each node's device (warm_decoded)
            self.prefetcher = Prefetcher(self.fabric, self.network,
                                         delay_s=net.prefetch_delay_s,
                                         fanout=net.prefetch_fanout)
            self.obs.adopt(self.prefetcher.stats)
            self.fabric.subscribe(self.prefetcher.on_announce)
        if net.scenarios:
            # _build_net runs after every add_silo, so the full node set is
            # known here: a scenario naming an unknown node aborts now, not
            # rounds into the run
            self._fault_injector = FaultInjector(
                self.fabric, net.scenarios, on_down=self._silo_net_down,
                on_restart=self._silo_restart,
                on_scorer_fault=self._set_scorer_fault,
                nodes=[s.silo_id for s in self.silos] + [ORCH_NODE])
            self._fault_injector.schedule_timed()

    def _silo_net_down(self, node_id: str):
        """Churned-out node == that silo stops participating."""
        for s in self.silos:
            if s.silo_id == node_id:
                s.fail()

    def _silo_restart(self, node_id: str):
        """A killed silo comes back: its chain replica has already recovered
        (WAL replay + peer resync, handled by the fault layer); here the
        *silo* resumes participating — Sync picks it up at the next round's
        ``live()`` pass, Async re-enters its loop from an event."""
        for s in self.silos:
            if s.silo_id == node_id:
                s.alive = True
                if self._resume_loop is not None:
                    self.env.schedule(0.0, lambda s=s: self._resume_loop(s),
                                      f"{s.silo_id}:restart")

    def _set_scorer_fault(self, node_id: str, mode: Optional[str],
                          clique: Sequence[str]):
        """Arm (or clear, mode=None) an adversarial scorer fault on a silo:
        its subsequent score submissions are perturbed at the source."""
        for s in self.silos:
            if s.silo_id == node_id:
                s.scorer_fault = None if mode is None \
                    else (mode, frozenset(clique))

    def _net_phase(self, rnd: int, when: str):
        if self._fault_injector is not None:
            self._fault_injector.on_phase(rnd, when)

    def _wire(self):
        if self.fed.net is not None and self.fabric is None:
            self._build_net()
        sealer_ids = [s.silo_id for s in self.silos]
        if self.fabric is not None:
            # replicated mode: one chain replica per silo + one for the
            # engine's control txs — no Ledger singleton anywhere; blocks
            # gossip as charged fabric transfers. With ``net.wal_dir`` set,
            # every replica also appends its blocks to a per-node JSONL
            # segment — a killed replica then restarts from disk (zero
            # fabric bytes) and only peer-syncs the gap.
            from repro_torch.chain import ChainNetwork
            wal_dir = self.fed.net.wal_dir if self.fed.net else ""
            if wal_dir:
                os.makedirs(wal_dir, exist_ok=True)

            def seg(nid: str) -> Optional[str]:
                return os.path.join(wal_dir, f"{nid}.jsonl") if wal_dir \
                    else None

            self.chain = ChainNetwork(self.env, self.fabric,
                                      sealers=sealer_ids + [ORCH_NODE])
            for s in self.silos:
                s.bind_ledger(self.chain.add_replica(
                    s.silo_id, UnifyFLContract(self.fed.mode),
                    segment_path=seg(s.silo_id)))
            self.ledger = self.chain.add_replica(ORCH_NODE, self.contract,
                                                 segment_path=seg(ORCH_NODE))
            self.obs.adopt(self.chain.stats)
            for rep in self.chain.replicas.values():
                self.obs.adopt(rep.stats)
            if self._fault_injector is not None:
                self._fault_injector.chain = self.chain
        else:
            self.ledger = Ledger(sealer_ids, path=self._ledger_path)
            self.ledger.attach_contract(self.contract)
            for s in self.silos:
                s.bind_ledger(self.ledger)
        # hierarchical edge tier: fleets late-bind the fabric/engine so their
        # per-round traffic is charged on the silos' access ports
        fleets = [(s, s.cluster.edge_fleet) for s in self.silos
                  if s.cluster.edge_fleet is not None]
        for s, fleet in fleets:
            fleet.attach(self.fabric, self.env)
            self.obs.adopt(fleet.stats)
        if self.fed.edge_light_clients and self.chain is not None:
            from repro_torch.chain import LightSync
            self.light_sync = LightSync(self.env, self.fabric,
                                        sealers=sealer_ids + [ORCH_NODE])
            self.light_sync.wire(self.chain)
            for s, fleet in fleets:
                for nid in fleet.node_ids:
                    self.light_sync.add_client(nid, s.silo_id)
                # devices sleep until their first sampling: no head pushes
                # to the 90%+ of the fleet that isn't participating yet
                self.light_sync.set_awake(s.silo_id, [])
                s.light_sync = self.light_sync
            self.obs.adopt(self.light_sync.stats)
        for s in self.silos:
            s.register()

    def _by_id(self, sid) -> Optional[SiloRuntime]:
        for s in self.silos:
            if s.silo_id == sid:
                return s
        return None

    def _mark_round(self, rnd: int, silo_id: Optional[str] = None):
        """Log a round boundary with the fabric's cumulative WAN bytes
        (``chain_bytes`` separates consensus gossip from store traffic)."""
        mark = {"round": rnd, "silo": silo_id, "t": self.env.now,
                "wan_bytes": self.fabric.stats["bytes"] if self.fabric else 0,
                "chain_bytes":
                    self.fabric.stats["chain_bytes"] if self.fabric else 0}
        if self.obs.enabled and self.obs.cfg.metrics_in_round_log:
            mark["metrics"] = self.obs.registry.flat()
        self.round_log.append(mark)

    def live(self) -> List[SiloRuntime]:
        return [s for s in self.silos if s.alive]

    def summary(self) -> Dict:
        return {s.silo_id: s.metrics for s in self.silos}

    # -- observability -------------------------------------------------------- #
    def _finish_obs(self):
        """End-of-run hook: close open spans and auto-export when the config
        names a trace path."""
        self.obs.finish(self.env.now)
        if self.obs.cfg.trace_path:
            self.obs.export(self.obs.cfg.trace_path)

    def export_trace(self, path: str) -> None:
        """Write the run's Chrome-trace JSON (with the flat metrics snapshot
        embedded). Callable any time after ``run()``; open spans are closed
        first so the export always has matched begin/end pairs."""
        self.obs.finish(self.env.now)
        self.obs.export(path)


class SyncOrchestrator(BaseOrchestrator):
    """Phase-locked rounds (paper §3.2). The training window closes when all
    live silos have submitted or the deadline lapses; late submissions defer
    to the next round (handled by the contract)."""

    def _run_window(self, deadline: Optional[float], done: Callable[[], bool]):
        """Run events until ``done()`` or the window's deadline. Closing
        early doesn't advance the clock; a window that times out spends its
        full duration."""
        while not done():
            nxt = self.env.peek()
            if nxt is None or (deadline is not None and nxt > deadline):
                break
            self.env.run(max_events=1)
        if deadline is not None and not done():
            self.env.run(until=deadline)

    def run(self, rounds: int) -> Dict:
        self._wire()
        tr = self.env.tracer
        submitted: Dict[int, set] = {}
        cids: Dict[int, set] = {}
        for r in range(1, rounds + 1):
            self.ledger.submit(ORCH_NODE, "start_training",
                               logical_time=self.env.now)
            self._net_phase(r, "train")
            t_round = self.env.now
            submitted[r] = set()
            cids[r] = set()
            sub_t: Dict[str, float] = {}   # silo -> submission time (spans)
            deadline = (self.env.now + self.fed.round_deadline_s
                        if self.fed.round_deadline_s > 0 else None)

            def on_submit(silo, cid, r=r, sub_t=sub_t):
                submitted[r].add(silo.silo_id)
                cids[r].add(cid)
                sub_t.setdefault(silo.silo_id, self.env.now)

            for s in self.live():
                s.pull_and_merge()
                s.train_and_submit(on_submit)

            def barrier(r=r):
                # all live silos submitted AND their submissions are visible
                # on the engine's own replica (read-your-replica: with a
                # replicated chain the blocks must *arrive* — a partitioned
                # silo's model never does, and the deadline breaks the wait)
                return all(s.silo_id in submitted[r] for s in self.live()) \
                    and all(c in self.contract.models for c in cids[r])

            self._run_window(deadline, barrier)
            if tr.enabled:
                t_close = self.env.now
                for sid, ts in sub_t.items():
                    if t_close > ts:
                        tr.span_at("phase.chain-wait", f"{sid}/phases",
                                   ts, t_close, round=r)
            self._net_phase(r, "score")
            assignments = self.ledger.submit(ORCH_NODE, "start_scoring",
                                             logical_time=self.env.now) or {}
            if self.fed.scorer == "multikrum":
                self._score_multikrum(r)
            else:
                self._score_per_model(r, t_round, assignments)
            self.ledger.submit(ORCH_NODE, "end_scoring",
                               logical_time=self.env.now)
            for s in self.live():
                s.rounds_done = r
                s.checkpoint()
            self._mark_round(r)
            if tr.enabled:
                tr.span_at("phase.round", "orchestrator/rounds",
                           t_round, self.env.now, round=r)
        self._finish_obs()
        return self.summary()

    def _score_per_model(self, r: int, t_round: float, assignments: Dict):
        """Per-model scoring: invert cid->scorers into scorer->cids, so each
        scorer makes ONE batched score_round call for its assignments; then
        the scoring window, dead-scorer reassignment and a second window."""
        by_scorer: Dict[str, List[str]] = {}
        for cid, scorers in assignments.items():
            entry = self.contract.models[cid]
            for sid in scorers:
                if sid != entry.owner:
                    by_scorer.setdefault(sid, []).append(cid)
        for sid in sorted(by_scorer):
            silo = self._by_id(sid)
            if silo and silo.alive:
                silo.score_round(by_scorer[sid])
        score_deadline = (self.env.now + self.fed.scorer_deadline_s
                          if self.fed.scorer_deadline_s > 0 else None)

        def scores_complete():
            return all(set(e.assigned) <= set(e.scores)
                       for e in self.contract.get_round_models(r))

        self._run_window(score_deadline, scores_complete)
        self._reassign_dead_scorers(r, t_round)
        self._run_window(
            (score_deadline + self.fed.scorer_deadline_s)
            if score_deadline is not None else None, scores_complete)

    def _score_multikrum(self, r: int):
        """MultiKRUM scores all models of the round at once (Sync only,
        paper Table 3). Models are pulled through the decoded cache; a fully
        int8 round is scored by the fused ``gram_q8`` kernel without any f32
        [M, N] stack. Every assigned scorer submits its model's score."""
        entries = self.contract.get_round_models(r)
        if len(entries) < 2:
            return
        silo0 = self.silos[0]
        reachable, decoded = [], []
        for e in entries:
            try:
                dm = silo0.get_decoded(e.cid)
                if dm.needs_base:
                    dm.vec()  # resolve the delta base chain
                decoded.append(dm)
                reachable.append(e)
            except (KeyError, IOError):
                self.env.emit(obsev.multikrum_fetch_fail(e.cid))
        if len(reachable) < 2:
            return
        scores = multikrum_scores_for_decoded(decoded, self.fed.multikrum_m)
        for e, sc in zip(reachable, scores):
            for sid in e.assigned:
                # each score submits via the scorer's own replica (replicated
                # mode); a stale-replica revert drops that one score
                silo = self._by_id(sid)
                led = silo.ledger if silo is not None and silo.ledger \
                    is not None else self.ledger
                try:
                    led.submit(sid, "submit_score", cid=e.cid,
                               score=float(sc), logical_time=self.env.now)
                except PermissionError:
                    self.env.emit(obsev.tx_revert(sid, "submit_score"))

    def _reassign_dead_scorers(self, r: int, t_round: float):
        # deadline pass (paper §3.2): any assigned scorer whose heartbeat
        # predates this round's start is resampled, and its eventual late
        # score is disregarded by the contract
        if self.env.now > t_round:
            stale = self.ledger.submit(ORCH_NODE, "reassign_stale",
                                       deadline_s=self.env.now - t_round,
                                       logical_time=self.env.now) or []
            for d in stale:
                rs = self._by_id(d["new"]) if d["new"] else None
                if rs and rs.alive:
                    rs.score_async(d["cid"],
                                   self.contract.models[d["cid"]].owner)
        # alive-flag pass: covers crashes the heartbeat hasn't aged out yet
        for e in self.contract.get_round_models(r):
            for sid in list(e.assigned):
                if sid in e.scores:
                    continue
                silo = self._by_id(sid)
                if silo is None or not silo.alive:
                    repl = self.ledger.submit(ORCH_NODE, "reassign_scorer",
                                              cid=e.cid, dead=sid,
                                              logical_time=self.env.now)
                    rs = self._by_id(repl) if repl else None
                    if rs and rs.alive:
                        rs.score_async(e.cid, e.owner)


class AsyncOrchestrator(BaseOrchestrator):
    """Independent silo loops (paper §3.3): no phase barrier; the contract
    assigns scorers from idle aggregators as soon as a CID is submitted.
    Scoring is per model: MultiKRUM is round-level, and with
    ``scorer="multikrum"`` each assignment falls back to accuracy
    (``SiloRuntime.score_method``), as in the reference."""

    def run(self, rounds: int) -> Dict:
        self._wire()
        # (no direct contract mutation here: the first submit_model tx opens
        # round 1 — all state changes go through the chain)
        # subscribe scorers to StartScoring events
        def on_event(event: str, payload: Dict):
            if event == "StartScoring":
                entry = self.contract.models[payload["cid"]]
                for sid in payload["scorers"]:
                    silo = self._by_id(sid)
                    if silo and silo.alive and sid != entry.owner:
                        silo.score_async(payload["cid"], entry.owner)

        self.ledger.subscribe(on_event)

        def loop(silo: SiloRuntime):
            if not silo.alive or silo.rounds_done >= rounds:
                return
            # round-phased fault injection: the first silo entering round r
            # fires that round's "train" scenarios
            self._net_phase(silo.rounds_done + 1, "train")
            silo.pull_and_merge()

            def done(s, cid):
                s.rounds_done += 1
                # ... and the first silo *finishing* round r fires "score"
                self._net_phase(s.rounds_done, "score")
                s.checkpoint()
                self._mark_round(s.rounds_done, s.silo_id)
                self.env.schedule(0.0, lambda: loop(s), f"{s.silo_id}:loop")

            silo.train_and_submit(done)

        self._resume_loop = loop   # a restarted silo re-enters its loop
        for s in self.silos:
            self.env.schedule(0.0, lambda s=s: loop(s), f"{s.silo_id}:start")
        self.env.run()
        self._finish_obs()
        return self.summary()
