"""The UnifyFL smart contract (paper Algorithm 1) as a deterministic state
machine executed by the ledger.

  startTraining()                 -- opens the training phase (Sync), emits
                                     StartTraining to subscribed aggregators.
  submitModel(cid)                -- validated trainer submits a model CID.
                                     Async: scorers are assigned immediately
                                     from idle aggregators.
  startScoring()                  -- Sync: samples floor(N/2)+1 scorers per
                                     submitted model (de-biased majority,
                                     paper step 2), emits StartScoring.
  submitScore(cid, score)         -- validated, *assigned* scorer submits a
                                     score; late Sync scores are disregarded
                                     (paper §3.2 'blockchain will no longer
                                     accept scores').
  getLatestModelsWithScores()     -- view: latest model set + score lists.

Scorer sampling uses content-addressed randomness (CID + round + membership
digest): on-chain deterministic *and* stable across chain reorgs. Elastic
membership (register/deregister), heartbeats, and deadline-based scorer
reassignment extend the paper's design to node-failure handling.

Trust layer (stake-weighted score consensus, all consensus state):

  commitScore(cid, commit)        -- scorer commits H(score|salt) ahead of
                                     the reveal; a later submitScore carrying
                                     a salt must match the commitment or the
                                     score is disregarded and the scorer
                                     penalized (commit->publish->aggregate
                                     round, autoppia-style).
  reportEquivocation(a, b)        -- carries two conflicting sealed headers
                                     (same sealer, same height, different
                                     hash); verified in-contract, the sealer
                                     is slashed once per (sealer, height).
  addSealer / removeSealer        -- sealer-set governance: reputation-
                                     weighted votes from registered
                                     aggregators; applied at quorum
                                     (> 1/2 of total live reputation).

Per-silo reputation starts at REP_INIT on registration and is clamped to
[REP_MIN, REP_MAX]. When a model settles (end_scoring in Sync, assignment
completion in Async) each scorer is judged by robust z-score against the
per-model median: outliers lose REP_OUTLIER_PENALTY, agreeing scorers
recover REP_AGREE_REWARD, committed-but-unrevealed scorers lose
REP_NOREVEAL_PENALTY. Reputation feeds the reputation-weighted score
collapse in ``core.policies``.

The contract is a *pure re-executable* state machine: every mutation happens
inside a ``tx_*`` handler, ``reset()`` restores genesis state in place (so
views held by runtimes stay valid across a chain reorg's re-execution), and
``state_digest()`` canonically hashes the full state — two replicas that
executed the same chain are byte-identical.
"""
from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

PHASE_IDLE = "idle"
PHASE_TRAINING = "training"
PHASE_SCORING = "scoring"

# -- reputation economics (consensus constants: every replica must agree) --- #
REP_INIT = 1.0                 # granted at registration
REP_MAX = 2.0                  # accrual ceiling
REP_MIN = 0.0                  # slash floor
REP_AGREE_REWARD = 0.05        # per settled model scored within tolerance
REP_OUTLIER_PENALTY = 0.25     # robust-z outlier vs the per-model median
REP_NOREVEAL_PENALTY = 0.15    # committed H(score|salt) but never revealed
REP_SLASH_EQUIVOCATION = 0.6   # per proven (sealer, height) equivocation
GOV_EVICT_REP = 0.5            # sealer-governance threshold: below -> evictable
OUTLIER_Z = 3.5                # robust z cutoff (0.6745*|s-med|/MAD)
OUTLIER_ATOL = 1e-6            # fallback tolerance when MAD ~ 0


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


@dataclass
class ModelEntry:
    cid: str
    owner: str
    round: int
    scores: Dict[str, float] = field(default_factory=dict)
    assigned: List[str] = field(default_factory=list)
    replaced: Set[str] = field(default_factory=set)  # reassigned-away scorers
    finalized: bool = False
    settled: bool = False  # reputation settlement ran (exactly once)


class UnifyFLContract:
    def __init__(self, mode: str = "sync"):
        assert mode in ("sync", "async")
        self.mode = mode
        self.aggregators: Set[str] = set()
        self.round = 0
        self.phase = PHASE_IDLE
        self.models: Dict[str, ModelEntry] = {}          # cid -> entry
        self.latest_by_owner: Dict[str, str] = {}        # owner -> cid
        self.deferred: List[Dict] = []                   # sync stragglers
        # scores that arrived before their model / its assignment (the
        # replicated chain merges forks by re-sealing, so cross-origin tx
        # order is not causal): buffered deterministically, drained when the
        # model is assigned. Part of state — digested.
        self.pending_scores: Dict[str, Dict[str, Dict]] = {}
        self.busy: Set[str] = set()                      # async idle tracking
        self.heartbeats: Dict[str, float] = {}
        # trust layer (all consensus state — digested)
        self.reputation: Dict[str, float] = {}           # silo -> [REP_MIN, REP_MAX]
        self.commits: Dict[str, Dict[str, str]] = {}     # cid -> scorer -> H(score|salt)
        self.sealer_set: Set[str] = set()                # governed sealer membership
        self.gov_votes: Dict[str, List[str]] = {}        # "add:x"/"remove:x" -> voters
        self.equivocation_reports: Dict[str, Dict] = {}  # "sealer@height" -> proof
        self._emit = lambda e, p: None                   # wired by ledger
        self.log: List[Dict] = []

    def reset(self) -> None:
        """Back to genesis state, in place: the chain adapter re-executes the
        canonical chain after a reorg; references held by runtimes survive."""
        emit = self._emit
        self.__init__(self.mode)
        self._emit = emit

    def state_digest(self) -> str:
        """Canonical SHA-256 over the whole contract state — replicas that
        executed the same chain produce the same digest, byte for byte."""
        body = {
            "mode": self.mode, "round": self.round, "phase": self.phase,
            "aggregators": sorted(self.aggregators),
            "busy": sorted(self.busy),
            "heartbeats": {k: self.heartbeats[k]
                           for k in sorted(self.heartbeats)},
            "latest_by_owner": dict(sorted(self.latest_by_owner.items())),
            "deferred": self.deferred,
            "pending_scores": {cid: {s: dict(sorted(rec.items()))
                                     for s, rec in sorted(sc.items())}
                               for cid, sc in sorted(self.pending_scores.items())},
            "models": {cid: {"owner": e.owner, "round": e.round,
                             "scores": dict(sorted(e.scores.items())),
                             "assigned": e.assigned,
                             "replaced": sorted(e.replaced),
                             "finalized": e.finalized,
                             "settled": e.settled}
                       for cid, e in sorted(self.models.items())},
            "reputation": {k: self.reputation[k]
                           for k in sorted(self.reputation)},
            "commits": {cid: dict(sorted(c.items()))
                        for cid, c in sorted(self.commits.items())},
            "sealer_set": sorted(self.sealer_set),
            "gov_votes": {k: sorted(v)
                          for k, v in sorted(self.gov_votes.items())},
            "equivocation_reports": {k: dict(sorted(p.items()))
                                     for k, p in
                                     sorted(self.equivocation_reports.items())},
        }
        return hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()).hexdigest()

    # -- snapshot / restore (crash-restart durability) -------------------- #
    def snapshot_state(self) -> Dict:
        """Deep JSON-able copy of the FULL contract state — a superset of
        ``state_digest``'s body (adds the execution log and preserves
        insertion order everywhere it matters for later execution). Feeding
        it back through ``restore_state`` reproduces the digest byte for
        byte."""
        return {
            "mode": self.mode, "round": self.round, "phase": self.phase,
            "aggregators": sorted(self.aggregators),
            "busy": sorted(self.busy),
            "heartbeats": dict(self.heartbeats),
            "latest_by_owner": dict(self.latest_by_owner),
            "deferred": [dict(d) for d in self.deferred],
            "pending_scores": {cid: {s: dict(rec) for s, rec in sc.items()}
                               for cid, sc in self.pending_scores.items()},
            "models": {cid: {"owner": e.owner, "round": e.round,
                             "scores": dict(e.scores),
                             "assigned": list(e.assigned),
                             "replaced": sorted(e.replaced),
                             "finalized": e.finalized,
                             "settled": e.settled}
                       for cid, e in self.models.items()},
            "reputation": dict(self.reputation),
            "commits": {cid: dict(c) for cid, c in self.commits.items()},
            "sealer_set": sorted(self.sealer_set),
            "gov_votes": {k: list(v) for k, v in self.gov_votes.items()},
            "equivocation_reports": {k: dict(p) for k, p in
                                     self.equivocation_reports.items()},
            "log": [dict(r) for r in self.log],
        }

    def restore_state(self, state: Dict) -> None:
        """Inverse of ``snapshot_state``, in place (references held by
        runtimes survive, like ``reset``). No re-execution happens — this
        is the raw-state restore path a snapshot restart uses instead of
        replaying the chain from genesis."""
        emit = self._emit
        self.__init__(state["mode"])
        self._emit = emit
        self.round = int(state["round"])
        self.phase = state["phase"]
        self.aggregators = set(state["aggregators"])
        self.busy = set(state["busy"])
        self.heartbeats = {k: float(v)
                           for k, v in state["heartbeats"].items()}
        self.latest_by_owner = dict(state["latest_by_owner"])
        self.deferred = [dict(d) for d in state["deferred"]]
        self.pending_scores = {cid: {s: dict(rec) for s, rec in sc.items()}
                               for cid, sc in state["pending_scores"].items()}
        self.models = {
            cid: ModelEntry(cid=cid, owner=e["owner"], round=int(e["round"]),
                            scores={s: float(v)
                                    for s, v in e["scores"].items()},
                            assigned=list(e["assigned"]),
                            replaced=set(e["replaced"]),
                            finalized=bool(e["finalized"]),
                            settled=bool(e.get("settled", False)))
            for cid, e in state["models"].items()}
        self.reputation = {k: float(v)
                           for k, v in state.get("reputation", {}).items()}
        self.commits = {cid: dict(c)
                        for cid, c in state.get("commits", {}).items()}
        self.sealer_set = set(state.get("sealer_set", []))
        self.gov_votes = {k: list(v)
                          for k, v in state.get("gov_votes", {}).items()}
        self.equivocation_reports = {
            k: dict(p) for k, p in
            state.get("equivocation_reports", {}).items()}
        self.log = [dict(r) for r in state["log"]]

    # ------------------------------------------------------------------ #
    def execute(self, tx, blk) -> Any:
        handler = getattr(self, "tx_" + tx.method, None)
        if handler is None:
            raise ValueError(f"unknown contract method {tx.method}")
        ret = handler(sender=tx.sender, blk=blk, **tx.args)
        self.log.append({"method": tx.method, "sender": tx.sender,
                         "block": blk.height})
        return ret

    def _require(self, cond: bool, msg: str):
        if not cond:
            raise PermissionError(f"contract revert: {msg}")

    # -- reputation ------------------------------------------------------- #
    def _bump_rep(self, node: str, delta: float, reason: str,
                  cid: str = "") -> float:
        cur = self.reputation.get(node, REP_INIT)
        new = min(REP_MAX, max(REP_MIN, cur + delta))
        self.reputation[node] = new
        self._emit("ReputationUpdated", {"node": node, "rep": new,
                                         "delta": new - cur,
                                         "reason": reason, "cid": cid})
        return new

    @staticmethod
    def score_commitment(score: float, salt: str) -> str:
        """Canonical H(score|salt) — scorers compute the same hex digest
        off-chain that ``tx_submit_score`` verifies on-chain."""
        return hashlib.sha256(
            f"{float(score)!r}|{salt}".encode()).hexdigest()

    # -- membership (elastic) ------------------------------------------- #
    def tx_register(self, sender: str, blk=None, **_) -> bool:
        self.aggregators.add(sender)
        self.heartbeats[sender] = blk.logical_time if blk else 0.0
        # reputation survives re-registration: a slashed sealer cannot wash
        # its record by deregistering and joining again
        self.reputation.setdefault(sender, REP_INIT)
        if self.reputation[sender] >= GOV_EVICT_REP:
            self.sealer_set.add(sender)
        self._emit("AggregatorRegistered", {"agg": sender})
        return True

    def tx_deregister(self, sender: str, blk=None, **_) -> bool:
        self.aggregators.discard(sender)
        self.busy.discard(sender)
        self.sealer_set.discard(sender)
        self._emit("AggregatorDeregistered", {"agg": sender})
        return True

    def tx_heartbeat(self, sender: str, blk=None, **_) -> bool:
        self.heartbeats[sender] = blk.logical_time if blk else 0.0
        return True

    def tx_set_busy(self, sender: str, busy: bool, blk=None, **_) -> bool:
        (self.busy.add if busy else self.busy.discard)(sender)
        return True

    # -- training phase --------------------------------------------------- #
    def tx_start_training(self, sender: str, blk=None, **_) -> int:
        self._require(self.mode == "sync", "start_training is a Sync call")
        self.round += 1
        self.phase = PHASE_TRAINING
        # deferred straggler submissions land in this round (paper §3.2)
        for d in self.deferred:
            self._accept_model(d["cid"], d["owner"])
        self.deferred = []
        self._emit("StartTraining", {"round": self.round})
        return self.round

    # -- model submission --------------------------------------------------- #
    def _accept_model(self, cid: str, owner: str):
        entry = ModelEntry(cid=cid, owner=owner, round=self.round)
        self.models[cid] = entry
        self.latest_by_owner[owner] = cid
        self._emit("ModelSubmitted", {"cid": cid, "owner": owner,
                                      "round": self.round})
        return entry

    def tx_submit_model(self, sender: str, cid: str, blk=None, **_) -> bool:
        self._require(sender in self.aggregators, f"{sender} not registered")
        # a model submission is itself a liveness proof: it refreshes the
        # sender's heartbeat, so deadline-based scorer reassignment
        # (tx_reassign_stale) keys on "did this silo's work land this round"
        # without a separate heartbeat tx per round
        self.heartbeats[sender] = blk.logical_time if blk else 0.0
        if self.mode == "sync":
            if self.phase != PHASE_TRAINING:
                # straggler: submission deferred to the next round
                self.deferred.append({"cid": cid, "owner": sender})
                self._emit("SubmissionDeferred", {"cid": cid, "owner": sender})
                return False
            self._accept_model(cid, sender)
            return True
        # async: accept anytime; assign scorers immediately from idle aggs
        if self.round == 0:
            self.round = 1
        entry = self._accept_model(cid, sender)
        self._assign_scorers(entry, blk)
        return True

    # -- scoring phase ------------------------------------------------------ #
    def _sample_scorers(self, entry: ModelEntry, blk, pool: List[str]) -> List[str]:
        n = len(self.aggregators)
        need = n // 2 + 1  # the paper's de-biasing majority
        # content-addressed randomness: seeded by the model CID (itself a
        # SHA-256 of the weights), the round, and the membership snapshot —
        # on-chain deterministic AND reorg-stable. Seeding from the containing
        # block's hash would re-sample assignments whenever a fork re-seals
        # the tx into a different block, invalidating scores already
        # dispatched against the first assignment. (Python's str hash is
        # per-process salted — unusable in a contract either way.)
        seed_src = f"{entry.cid}|{entry.round}|{','.join(sorted(pool))}"
        rng = random.Random(int.from_bytes(
            hashlib.sha256(seed_src.encode()).digest()[:8], "big"))
        pool = sorted(pool)
        rng.shuffle(pool)
        return pool[:need]

    def _assign_scorers(self, entry: ModelEntry, blk):
        if self.mode == "async":
            idle = [a for a in self.aggregators if a not in self.busy]
            pool = idle if len(idle) > len(self.aggregators) // 2 \
                else sorted(self.aggregators)
        else:
            pool = sorted(self.aggregators)
        # a silo never scores its own model (when the pool allows it)
        non_owner = [a for a in pool if a != entry.owner]
        n = len(self.aggregators)
        if len(non_owner) >= n // 2 + 1:
            pool = non_owner
        entry.assigned = self._sample_scorers(entry, blk, pool)
        self._emit("StartScoring", {"cid": entry.cid,
                                    "scorers": entry.assigned,
                                    "round": entry.round})
        # drain scores that arrived ahead of this assignment (fork merges)
        for sender, rec in sorted(
                self.pending_scores.pop(entry.cid, {}).items()):
            if sender in entry.assigned:
                self._apply_score(entry, sender, rec["score"],
                                  rec.get("salt"))

    def tx_start_scoring(self, sender: str, blk=None, **_) -> Dict[str, List[str]]:
        self._require(self.mode == "sync", "start_scoring is a Sync call")
        self._require(self.phase == PHASE_TRAINING, "not in training phase")
        self.phase = PHASE_SCORING
        out = {}
        for cid, entry in self.models.items():
            if entry.round == self.round and not entry.finalized:
                self._assign_scorers(entry, blk)
                out[cid] = entry.assigned
        return out

    def _apply_score(self, entry: ModelEntry, sender: str,
                     score: float, salt: Optional[str] = None) -> bool:
        if sender in entry.replaced:
            # reassigned away (missed its deadline): the late score is
            # disregarded, not a revert (paper §3.2)
            self._emit("ScoreRejectedReassigned", {"cid": entry.cid,
                                                   "scorer": sender})
            return False
        self._require(sender in entry.assigned,
                      f"{sender} not an assigned scorer for {entry.cid}")
        if self.mode == "sync" and (self.phase != PHASE_SCORING
                                    or entry.round != self.round):
            # late score: disregarded (paper §3.2)
            self._emit("ScoreRejectedLate", {"cid": entry.cid,
                                             "scorer": sender})
            return False
        # commit->reveal: once a commitment exists for (cid, scorer), the
        # reveal must carry a matching salt; mismatches are disregarded
        # (not reverts) and cost reputation. Reveals with no prior commit
        # stay accepted — commit-reveal is opt-in per scorer.
        commit = self.commits.get(entry.cid, {}).get(sender)
        if commit is not None and \
                (salt is None
                 or self.score_commitment(score, salt) != commit):
            self._emit("ScoreRejectedCommitMismatch",
                       {"cid": entry.cid, "scorer": sender})
            self._bump_rep(sender, -REP_OUTLIER_PENALTY,
                           "commit-mismatch", entry.cid)
            return False
        entry.scores[sender] = float(score)
        self._emit("ScoreSubmitted", {"cid": entry.cid, "scorer": sender,
                                      "score": float(score)})
        if self.mode == "async" and not entry.settled \
                and set(entry.assigned) <= set(entry.scores):
            # async has no end_scoring barrier: settle when the last
            # assigned scorer reveals
            self._settle_model(entry)
        return True

    def tx_commit_score(self, sender: str, cid: str, commit: str,
                        blk=None, **_) -> bool:
        """Commit H(score|salt) ahead of the reveal. First commit wins —
        overwriting after seeing others' reveals would defeat the point."""
        self._require(sender in self.aggregators, f"{sender} not registered")
        prior = self.commits.setdefault(cid, {}).get(sender)
        if prior is not None:
            return prior == str(commit)
        self.commits[cid][sender] = str(commit)
        self._emit("ScoreCommitted", {"cid": cid, "scorer": sender})
        return True

    def tx_submit_score(self, sender: str, cid: str, score: float,
                        salt: Optional[str] = None, blk=None, **_) -> bool:
        self._require(sender in self.aggregators, f"{sender} not registered")
        entry = self.models.get(cid)
        if entry is None or not entry.assigned:
            # fork merges re-seal txs, so a score can land *before* its
            # model or before the model's scorer assignment — buffer it;
            # _assign_scorers drains the buffer through the same validation
            rec: Dict[str, Any] = {"score": float(score)}
            if salt is not None:
                rec["salt"] = str(salt)
            self.pending_scores.setdefault(cid, {})[sender] = rec
            self._emit("ScoreBuffered", {"cid": cid, "scorer": sender})
            return False
        return self._apply_score(entry, sender, score, salt)

    def _settle_model(self, entry: ModelEntry) -> None:
        """Reputation settlement, exactly once per model: judge every
        revealed score by robust z vs the per-model median, penalize
        committed-but-unrevealed scorers. Deterministic (sorted iteration,
        clamped float ops) — runs inside tx execution on every replica."""
        if entry.settled:
            return
        entry.settled = True
        committed = self.commits.get(entry.cid, {})
        for s in sorted(committed):
            if s not in entry.scores:
                self._bump_rep(s, -REP_NOREVEAL_PENALTY, "no-reveal",
                               entry.cid)
        scores = entry.scores
        if not scores:
            return
        if len(scores) < 3:
            # too few reveals for robust stats: participation is rewarded
            for s in sorted(scores):
                self._bump_rep(s, REP_AGREE_REWARD, "scored", entry.cid)
            return
        vals = list(scores.values())
        med = _median(vals)
        mad = _median([abs(v - med) for v in vals])
        for s in sorted(scores):
            dev = abs(scores[s] - med)
            if mad > 1e-12:
                outlier = 0.6745 * dev / mad > OUTLIER_Z
            else:
                outlier = dev > OUTLIER_ATOL
            if outlier:
                self._bump_rep(s, -REP_OUTLIER_PENALTY, "outlier", entry.cid)
            else:
                self._bump_rep(s, REP_AGREE_REWARD, "agree", entry.cid)

    def tx_end_scoring(self, sender: str, blk=None, **_) -> int:
        self._require(self.mode == "sync", "end_scoring is a Sync call")
        self.phase = PHASE_IDLE
        for cid in sorted(self.models):
            entry = self.models[cid]
            if entry.round == self.round:
                entry.finalized = True
                self._settle_model(entry)
        self._emit("RoundFinalized", {"round": self.round})
        return self.round

    def _reassign(self, entry: ModelEntry, dead: str, blk) -> Optional[str]:
        """Resample one non-responsive scorer's assignment (block-hash
        randomness); its eventual late score is disregarded via ``replaced``."""
        if dead not in entry.assigned or dead in entry.scores:
            return None
        entry.replaced.add(dead)
        candidates = [a for a in sorted(self.aggregators)
                      if a not in entry.assigned and a != entry.owner]
        if not candidates:
            entry.assigned.remove(dead)
            return None
        # reorg-stable resampling (see _sample_scorers)
        seed_src = f"{entry.cid}|{dead}|{','.join(candidates)}"
        rng = random.Random(int.from_bytes(
            hashlib.sha256(seed_src.encode()).digest()[:8], "big"))
        repl = rng.choice(candidates)
        entry.assigned[entry.assigned.index(dead)] = repl
        self._emit("ScorerReassigned", {"cid": entry.cid, "dead": dead,
                                        "new": repl})
        return repl

    def tx_reassign_scorer(self, sender: str, cid: str, dead: str,
                           blk=None, **_) -> Optional[str]:
        """Straggler/failure mitigation: replace a non-responsive scorer."""
        entry = self.models.get(cid)
        self._require(entry is not None, f"unknown model {cid}")
        return self._reassign(entry, dead, blk)

    def tx_reassign_stale(self, sender: str, deadline_s: float,
                          blk=None, **_) -> List[Dict]:
        """Deadline-based failure detection (paper §3.2): every assigned
        scorer of the current round whose last heartbeat is older than
        ``deadline_s`` (vs block time) and who hasn't scored is resampled."""
        now = blk.logical_time if blk else 0.0
        out = []
        for entry in self.models.values():
            if entry.round != self.round or entry.finalized:
                continue
            for sid in list(entry.assigned):
                if sid in entry.scores:
                    continue
                if self.heartbeats.get(sid, 0.0) + deadline_s < now:
                    repl = self._reassign(entry, sid, blk)
                    out.append({"cid": entry.cid, "dead": sid, "new": repl})
        return out

    # -- slashing ---------------------------------------------------------- #
    def tx_report_equivocation(self, sender: str, header_a: Dict,
                               header_b: Dict, blk=None, **_) -> bool:
        """Slash an equivocating sealer. The proof is self-contained: two
        sealed headers for the same (sealer, height) with different hashes,
        each hash recomputed in-contract. One slash per (sealer, height) —
        later duplicate reports (other replicas race to report the same
        twin) are accepted no-ops, not reverts."""
        from repro_torch.chain.replica import Block  # lazy: keep core import-light
        try:
            a = Block.from_json(dict(header_a))
            b = Block.from_json(dict(header_b))
        except Exception:
            self._require(False, "malformed equivocation headers")
        self._require(a.sealer == b.sealer, "headers name different sealers")
        self._require(a.height == b.height, "headers at different heights")
        self._require(a.prev_hash == b.prev_hash,
                      "headers on different parents: re-sealing a height "
                      "on another branch after a reorg is not equivocation")
        self._require(a.hash != b.hash, "headers are the same block")
        self._require(a.hash == a.compute_hash()
                      and b.hash == b.compute_hash(),
                      "header hash does not verify")
        key = f"{a.sealer}@{a.height}"
        if key in self.equivocation_reports:
            return False
        self.equivocation_reports[key] = {
            "reporter": sender, "sealer": a.sealer, "height": a.height,
            "hashes": sorted([a.hash, b.hash])}
        rep = self._bump_rep(a.sealer, -REP_SLASH_EQUIVOCATION,
                             "equivocation")
        self._emit("SealerSlashed", {"sealer": a.sealer, "height": a.height,
                                     "reporter": sender, "rep": rep})
        return True

    # -- sealer-set governance ---------------------------------------------- #
    def _gov_vote(self, op: str, target: str, voter: str) -> bool:
        """Record a reputation-weighted vote; apply at quorum (> 1/2 of the
        total reputation of registered aggregators). Returns True when the
        vote tipped the proposal over quorum."""
        key = f"{op}:{target}"
        voters = self.gov_votes.setdefault(key, [])
        if voter not in voters:
            voters.append(voter)
        total = sum(self.reputation.get(a, REP_INIT)
                    for a in sorted(self.aggregators))
        weight = sum(self.reputation.get(v, REP_INIT)
                     for v in voters if v in self.aggregators)
        self._emit("GovernanceVote", {"op": op, "target": target,
                                      "voter": voter, "weight": weight,
                                      "total": total})
        if total <= 0 or weight * 2 <= total:
            return False
        # quorum reached: apply and clear both pending proposals for target
        self.gov_votes.pop(f"add:{target}", None)
        self.gov_votes.pop(f"remove:{target}", None)
        return True

    def tx_add_sealer(self, sender: str, sealer: str, blk=None, **_) -> bool:
        """Vote to (re-)admit ``sealer``; requires its reputation to have
        recovered above the governance threshold."""
        self._require(sender in self.aggregators, f"{sender} not registered")
        self._require(self.reputation.get(sealer, REP_INIT) >= GOV_EVICT_REP,
                      f"{sealer} reputation below governance threshold")
        if not self._gov_vote("add", sealer, sender):
            return False
        self.sealer_set.add(sealer)
        self._emit("SealerAdded", {"sealer": sealer})
        return True

    def tx_remove_sealer(self, sender: str, sealer: str,
                         blk=None, **_) -> bool:
        """Vote to evict ``sealer``; only slashed sealers (reputation below
        the governance threshold) are evictable."""
        self._require(sender in self.aggregators, f"{sender} not registered")
        self._require(self.reputation.get(sealer, REP_INIT) < GOV_EVICT_REP,
                      f"{sealer} reputation not below governance threshold")
        if not self._gov_vote("remove", sealer, sender):
            return False
        self.sealer_set.discard(sealer)
        self._emit("SealerRemoved", {"sealer": sealer})
        return True

    def is_sealer(self, node: str) -> bool:
        """Governed sealer membership (applied at epoch boundaries by the
        deployment; live PoA seal validation keeps the genesis set so that
        replicas mid-vote never disagree on block validity)."""
        return node in self.sealer_set

    # -- views ---------------------------------------------------------------- #
    def get_latest_models_with_scores(self, exclude_owner: Optional[str] = None
                                      ) -> List[Dict]:
        out = []
        for owner, cid in sorted(self.latest_by_owner.items()):
            if owner == exclude_owner:
                continue
            e = self.models[cid]
            out.append({"cid": cid, "owner": owner, "round": e.round,
                        "scores": dict(e.scores)})
        return out

    def get_round_models(self, rnd: int) -> List[ModelEntry]:
        return [e for e in self.models.values() if e.round == rnd]

    def quorum(self) -> int:
        return len(self.aggregators) // 2 + 1
