"""UnifyFL orchestration engine (paper §3.1–§3.2), Sync mode.

Twin of ``repro.core.orchestrator``. ``SiloRuntime`` wires one FL cluster to
the ledger/contract and its store node. ``SyncOrchestrator`` runs the
phase-locked cycle (training window -> scoring window -> finalize);
stragglers that miss the submission window are deferred to the next round
and late scores are disregarded, exactly per §3.2. Fault tolerance: scorer
reassignment on deadline, CAS-backed checkpoint/restart.

Orchestration state lives in the single-replica ``Ledger``. Not ported yet
(ROADMAP.md, queue 1): the replicated chain over a WAN fabric
(``FedConfig.net``), MultiKRUM scoring, edge fleets and the Async engine —
each raises ``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
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
from repro_torch.core.simenv import SimEnv
from repro_torch.core.store import StoreNetwork, StoreNode
from repro_torch.fed import scorebatch
from repro_torch.fed.cluster import Cluster
from repro_torch.kernels import ops
from repro_torch.obs import Observability, events as obsev


@dataclass
class SiloPolicy:
    agg_policy: str = "all"
    score_policy: str = "median"
    k: int = 2


ORCH_NODE = "orchestrator"   # the engine's own tx sender
CHAIN_RETRY_S = 0.25         # resubmit delay after a revert
CHAIN_RETRIES = 8


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"queue 1 {item})")


def check_ported(fed: FedConfig) -> None:
    """Refuse the configurations whose code paths later slices port."""
    if fed.net is not None:
        raise _not_ported("FedConfig.net (replicated chain over the WAN "
                          "fabric)", "item 7, the net fabric path")
    if fed.scorer == "multikrum":
        raise _not_ported("scorer='multikrum'", "item 6, core/scoring.py")
    if fed.edge_per_silo > 0 or fed.edge_light_clients:
        raise _not_ported("the edge tier (edge_per_silo)", "item 7, "
                          "edge/fleet.py")
    if fed.mode != "sync":
        raise _not_ported(f"mode={fed.mode!r}", "item 7, AsyncOrchestrator")
    wire.resolve_method(fed.compression)


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
        self.rounds_done = 0
        self.last_cid: Optional[str] = None
        # the silo's last announced model CID: the delta-coding base its next
        # envelope references (receivers resolve it from their own stores)
        self.last_global_cid: Optional[str] = None
        self.last_self_score = float("-inf")
        self.metrics: List[Dict] = []
        # per-round aggregation picks ({round, owners})
        self.pick_log: List[Dict] = []
        if fed.scorer not in SCORERS:
            raise ValueError(f"unknown scorer {fed.scorer!r} "
                             f"(choose from {SCORERS})")
        self.score_method = fed.scorer if fed.scorer in ("accuracy", "loss") \
            else "accuracy"
        self._rng = random.Random(cluster.silo_id)
        self._flat_spec = None  # cached flatten spec of this config's params

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
                self.env.schedule(
                    CHAIN_RETRY_S,
                    lambda: (self._submit(method, _retries=_retries - 1,
                                          **args) if self.alive else None),
                    f"{self.silo_id}:resubmit:{method}")
            else:
                self.env.emit(obsev.tx_revert(self.silo_id, method))
            return None

    def register(self):
        self._submit("register")

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
        for c in picked:
            try:
                dm = self.get_decoded(c.cid)
                if dm.needs_base:
                    dm.vec()  # resolve the delta base chain
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
        model as receivers decode it."""
        if self.last_global_cid is None or \
                not wire.resolve_method(self.fed.compression).endswith("-delta"):
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
        duration = compute + self.extra_train_delay
        tr = self.env.tracer
        track = f"{self.silo_id}/phases"
        sp = tr.begin("phase.train", track, self.env.now,
                      round=self.rounds_done + 1)

        def finish():
            if not self.alive:
                return
            tr.end(sp, self.env.now)
            cid = self.store.put(self._encode())
            self.last_cid = cid
            self.last_global_cid = cid
            ev = self.cluster.evaluate()
            self.last_self_score = ev["accuracy"] if self.fed.scorer != "loss" \
                else -ev["loss"]
            self.metrics.append({"round": self.rounds_done, "t": self.env.now,
                                 "local": ev, **m})
            # the submission doubles as the heartbeat (the contract refreshes
            # it in tx_submit_model): the liveness signal the deadline-based
            # scorer reassignment keys on (paper §3.2)
            self._submit("submit_model", cid=cid, _retries=CHAIN_RETRIES)
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
                self.env.emit(obsev.score_fetch_fail(self.silo_id, cid))
        if not kept:
            self._submit("set_busy", busy=False)
            return
        scores = scorebatch.score_round_batch(
            self.cluster, decoded, self.flat_spec(), method=self.score_method)
        compute = (time.perf_counter() - t0) * self.time_scale
        duration = compute + self.extra_score_delay
        tr = self.env.tracer
        sp = tr.begin("phase.score", f"{self.silo_id}/phases", self.env.now,
                      k=len(kept))

        def finish():
            if not self.alive:
                return
            tr.end(sp, self.env.now)
            for cid, score in zip(kept, scores):
                val = float(score)
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

    def score_async(self, cid: str, owner: str):
        """Single-CID assignment (scorer reassignment): a K=1 batch through
        the same engine."""
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
        arr = np.asarray(v)
        if arr.size != l.numel():
            raise ValueError(
                f"shape mismatch at leaf {i} ({keys[i]!r}): stored "
                f"{arr.shape} cannot reshape to expected {tuple(l.shape)}")
        cast.append(torch.from_numpy(np.array(arr)).reshape(l.shape)
                    .to(device=l.device, dtype=l.dtype))
    return tree.unflatten([p for p, _ in items], cast)


# --------------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------------- #

class BaseOrchestrator:
    def __init__(self, fed: FedConfig, *, ledger_path: Optional[str] = None):
        check_ported(fed)
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
        self.ledger: Optional[Ledger] = None
        self.round_log: List[Dict] = []

    def add_silo(self, cluster: Cluster, **kw) -> SiloRuntime:
        store = self.network.add_node(cluster.silo_id, cluster.device)
        self.obs.adopt(store.stats)
        silo = SiloRuntime(cluster, store, self.contract, self.env,
                           self.fed, **kw)
        self.silos.append(silo)
        return silo

    def _wire(self):
        self.ledger = Ledger([s.silo_id for s in self.silos],
                             path=self._ledger_path)
        self.ledger.attach_contract(self.contract)
        for s in self.silos:
            s.bind_ledger(self.ledger)
        for s in self.silos:
            s.register()

    def _by_id(self, sid) -> Optional[SiloRuntime]:
        for s in self.silos:
            if s.silo_id == sid:
                return s
        return None

    def _mark_round(self, rnd: int, silo_id: Optional[str] = None):
        mark = {"round": rnd, "silo": silo_id, "t": self.env.now}
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
                return all(s.silo_id in submitted[r] for s in self.live()) \
                    and all(c in self.contract.models for c in cids[r])

            self._run_window(deadline, barrier)
            if tr.enabled:
                t_close = self.env.now
                for sid, ts in sub_t.items():
                    if t_close > ts:
                        tr.span_at("phase.chain-wait", f"{sid}/phases",
                                   ts, t_close, round=r)
            # scoring phase: invert cid->scorers into scorer->cids, so each
            # scorer makes ONE batched score_round call for its assignments
            assignments = self.ledger.submit(ORCH_NODE, "start_scoring",
                                             logical_time=self.env.now) or {}
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
    """Independent silo loops (paper §3.3): not ported yet."""

    def __init__(self, fed: FedConfig, **kw):
        raise _not_ported("AsyncOrchestrator", "item 7, the Async engine")
