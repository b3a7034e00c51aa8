"""Per-round / timed fault injection for the WAN fabric (and the chain).

Scenarios live in ``NetConfig.scenarios`` (plain frozen dataclasses, see
``repro_torch.config.FaultScenario``) so a FedConfig fully describes a faulty run:

  * round-phased (Sync engine): fire when round ``r`` enters its training or
    scoring phase — deterministic regardless of host compute noise;
  * timed (both engines): fire at an absolute simulated time.

Actions: ``down`` / ``up`` (node churn — cancels that node's in-flight
transfers), ``isolate`` / ``heal`` (link partitions), ``slow_link``
(bandwidth degraded by ``factor`` — a slow-link straggler), ``partition``
(group split of the swarm: both sides keep sealing their own chain forks),
``byzantine_sealer`` (the named replica's sealer equivocates), ``kill``
(process crash: the node goes down *and* its chain replica's entire
in-memory state — block tree, mempool, contract — is wiped; only its WAL
segment survives), ``restart`` (the node comes back, replays its WAL from
disk at zero fabric cost, then resyncs the remaining gap from peers),
``colluding_scorers`` (``node`` names a comma-separated clique whose
members inflate scores for clique-owned models), ``byzantine_scorer``
(the named silo inverts every score), ``heal_scorer`` (clears the named
silo's scorer fault). Scorer faults reach the silo runtimes through the
``on_scorer_fault(node, mode, clique)`` callback.

When a replicated chain is attached (``FaultInjector.chain``), ``heal``,
``up`` and ``restart`` also trigger ``ChainNetwork.resync()`` — reconnection
turns a healed partition / crash gap into catch-up traffic, reorgs, and
(eventually) one head.

Misconfigured scenarios fail **at construction**: an unknown action raises
from ``FaultScenario.__post_init__`` itself, and — when the injector is
given the known node set — a scenario naming an unknown node (including
``partition`` group members) raises from ``FaultInjector.__init__``, not
rounds into a simulated run.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

from repro_torch.config import FAULT_ACTIONS, FaultScenario
from repro_torch.net.fabric import NetFabric
from repro_torch.obs import events as obsev

ACTIONS = FAULT_ACTIONS

# actions whose ``node`` field must name a known node (when a node set is
# given); 'heal' takes no node, 'partition' and 'colluding_scorers' are
# validated group-by-group
_NODE_ACTIONS = ("down", "up", "isolate", "slow_link", "byzantine_sealer",
                 "kill", "restart", "byzantine_scorer", "heal_scorer")


def validate_scenarios(scenarios: Iterable[FaultScenario],
                       nodes: Optional[Sequence[str]] = None) -> None:
    """Reject bad scenario configs up front.

    Always checks the action name (defensive — ``FaultScenario`` already
    does); with ``nodes`` also checks that every named node (both
    ``slow_link`` endpoints, every ``partition`` group member) is known.
    """
    known = set(nodes) if nodes is not None else None
    for i, sc in enumerate(scenarios):
        if sc.action not in ACTIONS:
            raise ValueError(f"scenario[{i}]: unknown fault action "
                             f"{sc.action!r} (choose from {ACTIONS})")
        if known is None:
            continue
        named = []
        if sc.action in _NODE_ACTIONS:
            named.append(sc.node)
        if sc.action == "slow_link":
            named.append(sc.node_b)
        if sc.action == "partition":
            named.extend(n for g in (sc.node, sc.node_b)
                         for n in g.split(",") if n)
        if sc.action == "colluding_scorers":
            named.extend(n for n in sc.node.split(",") if n)
        bad = [n for n in named if n not in known]
        if bad:
            raise ValueError(
                f"scenario[{i}] ({sc.action!r}): unknown node(s) "
                f"{sorted(set(bad))} — known: {sorted(known)}")


def apply_scenario(fabric: NetFabric, sc: FaultScenario, *,
                   on_down: Optional[Callable[[str], None]] = None,
                   on_up: Optional[Callable[[str], None]] = None,
                   on_restart: Optional[Callable[[str], None]] = None,
                   on_scorer_fault: Optional[Callable] = None,
                   chain=None) -> None:
    if sc.action == "down":
        fabric.node_down(sc.node)
        if on_down is not None:
            on_down(sc.node)
    elif sc.action == "up":
        fabric.node_up(sc.node)
        if on_up is not None:
            on_up(sc.node)
    elif sc.action == "isolate":
        fabric.isolate(sc.node)
    elif sc.action == "heal":
        fabric.heal()
    elif sc.action == "slow_link":
        fabric.degrade_link(sc.node, sc.node_b, sc.factor)
    elif sc.action == "partition":
        groups = [[n for n in g.split(",") if n]
                  for g in (sc.node, sc.node_b) if g]
        if len(groups) == 1:
            # single-group spec: listed nodes split away from everyone else
            # (unlisted nodes always land in group 0)
            groups = [[], groups[0]]
        fabric.partition(*groups)
    elif sc.action == "byzantine_sealer":
        if chain is not None and sc.node in chain.replicas:
            chain.replicas[sc.node].byzantine = "equivocate"
            fabric.env.emit(obsev.chain_byzantine(sc.node))
    elif sc.action == "kill":
        # crash, not clean shutdown: in-flight transfers cancelled *and* the
        # replica forgets everything it hasn't written to its WAL segment
        fabric.node_down(sc.node)
        if chain is not None and sc.node in chain.replicas:
            chain.kill(sc.node)
        if on_down is not None:
            on_down(sc.node)
    elif sc.action == "restart":
        fabric.node_up(sc.node)
        if chain is not None and sc.node in chain.replicas:
            chain.restart(sc.node)
        if on_restart is not None:
            on_restart(sc.node)
    elif sc.action == "colluding_scorers":
        clique = tuple(n for n in sc.node.split(",") if n)
        for member in clique:
            fabric.env.emit(obsev.scorer_fault(member, "collude"))
            if on_scorer_fault is not None:
                on_scorer_fault(member, "collude", clique)
    elif sc.action == "byzantine_scorer":
        fabric.env.emit(obsev.scorer_fault(sc.node, "byzantine"))
        if on_scorer_fault is not None:
            on_scorer_fault(sc.node, "byzantine", (sc.node,))
    elif sc.action == "heal_scorer":
        fabric.env.emit(obsev.scorer_fault(sc.node, "healed"))
        if on_scorer_fault is not None:
            on_scorer_fault(sc.node, None, ())
    else:
        raise ValueError(f"unknown fault action {sc.action!r} "
                         f"(choose from {ACTIONS})")
    if sc.action in ("heal", "up", "restart") and chain is not None:
        chain.resync()


class FaultInjector:
    def __init__(self, fabric: NetFabric,
                 scenarios: Iterable[FaultScenario], *,
                 on_down: Optional[Callable[[str], None]] = None,
                 on_up: Optional[Callable[[str], None]] = None,
                 on_restart: Optional[Callable[[str], None]] = None,
                 on_scorer_fault: Optional[Callable] = None,
                 chain=None,
                 nodes: Optional[Sequence[str]] = None):
        self.scenarios = tuple(scenarios)
        validate_scenarios(self.scenarios, nodes)
        self.fabric = fabric
        self.on_down = on_down
        self.on_up = on_up
        self.on_restart = on_restart
        self.on_scorer_fault = on_scorer_fault
        self.chain = chain        # bound late by the orchestrator's _wire
        self._round_fired: set = set()  # scenario indices already applied

    def schedule_timed(self) -> None:
        """Arm every ``at_time`` scenario on the fabric's SimEnv."""
        env = self.fabric.env
        for i, sc in enumerate(self.scenarios):
            if sc.at_time >= 0.0:
                # index-unique key: two timed faults on the same node must
                # both fire, not cancel-and-replace each other
                env.schedule(max(0.0, sc.at_time - env.now),
                             lambda sc=sc: self._apply(sc),
                             f"net:fault:{i}:{sc.action}:{sc.node}")

    def on_phase(self, rnd: int, when: str) -> None:
        """Fire round-phased scenarios. Sync calls this once per (round,
        phase); the Async engine calls it on every silo's round transition,
        so each scenario is guarded to fire exactly once."""
        for i, sc in enumerate(self.scenarios):
            if sc.at_time < 0.0 and sc.round == rnd and sc.when == when \
                    and i not in self._round_fired:
                self._round_fired.add(i)
                self._apply(sc)

    def _apply(self, sc: FaultScenario) -> None:
        apply_scenario(self.fabric, sc, on_down=self.on_down,
                       on_up=self.on_up, on_restart=self.on_restart,
                       on_scorer_fault=self.on_scorer_fault,
                       chain=self.chain)
