"""Typed trace events for the simulated runtime (repro_torch.obs).

Every fabric / chain / orchestrator happening that used to be an ad-hoc
``env.trace.append((now, f"net:down:{nid}"))`` f-string is now a
``TraceEvent``: a frozen record with a dotted ``kind`` ("net.down",
"chain.seal", ...), the acting ``node``, the QoS ``lane`` for transfer
events, and free-form structured ``attrs``.

String compatibility is a hard contract, not a convenience: the legacy
rendering is pre-computed into ``text`` by the factory helpers below and

  * ``str(ev)`` is byte-identical to the old f-string,
  * ``ev == "net:down:silo2"`` compares against that text,
  * ``hash(ev) == hash(text)`` (events interchange with strings in sets),
  * ``ev.startswith(prefix)`` greps like a string,

so every existing ``for _, note in env.trace`` consumer — tests included —
keeps working unchanged while new consumers read ``ev.kind`` / ``ev.attrs``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence

CID_W = 12   # cid prefix width in net-plane trace notes
TX_W = 8     # cid prefix width in orchestrator tx-plane trace notes


class TraceEvent:
    """One structured event on the simulated clock (time lives in the
    ``(now, event)`` trace tuple / the tracer record, not here)."""

    __slots__ = ("kind", "text", "node", "lane", "attrs")

    def __init__(self, kind: str, text: str, node: str = "",
                 lane: str = "", attrs: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.text = text
        self.node = node
        self.lane = lane
        self.attrs = attrs or {}

    # -- string compatibility (legacy trace-grepping contract) -------------- #
    def __str__(self) -> str:
        return self.text

    def __repr__(self) -> str:
        return f"TraceEvent({self.kind!r}, {self.text!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, TraceEvent):
            return self.kind == other.kind and self.text == other.text
        if isinstance(other, str):
            return self.text == other
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash(self.text)

    def startswith(self, prefix, *args) -> bool:
        return self.text.startswith(prefix, *args)


# --------------------------------------------------------------------------- #
# Factories — one per legacy call site; each reproduces the legacy string
# byte-for-byte.
# --------------------------------------------------------------------------- #

def net_partition(groups: Sequence[Iterable[str]]) -> TraceEvent:
    text = "net:partition:" + "|".join(",".join(sorted(g)) for g in groups)
    return TraceEvent("net.partition", text,
                      attrs={"groups": [sorted(g) for g in groups]})


def net_isolate(node: str) -> TraceEvent:
    return TraceEvent("net.isolate", f"net:isolate:{node}", node=node)


def net_heal() -> TraceEvent:
    return TraceEvent("net.heal", "net:heal")


def net_down(node: str) -> TraceEvent:
    return TraceEvent("net.down", f"net:down:{node}", node=node)


def net_up(node: str) -> TraceEvent:
    return TraceEvent("net.up", f"net:up:{node}", node=node)


def net_slow_link(a: str, b: str, factor: float) -> TraceEvent:
    return TraceEvent("net.slow-link", f"net:slow-link:{a}~{b}:x{factor:g}",
                      node=a, attrs={"peer": b, "factor": factor})


def net_transfer(kind: str, src: str, dst: str, cid: str, *,
                 lane: str = "", nbytes: int = 0) -> TraceEvent:
    return TraceEvent(f"net.{kind}", f"net:{kind}:{src}->{dst}:{cid[:CID_W]}",
                      node=dst, lane=lane,
                      attrs={"src": src, "dst": dst, "cid": cid[:CID_W],
                             "nbytes": int(nbytes)})


def chain_kill(node: str) -> TraceEvent:
    return TraceEvent("chain.kill", f"chain:kill:{node}", node=node)


def chain_restart(node: str, wal_blocks: int) -> TraceEvent:
    return TraceEvent("chain.restart", f"chain:restart:{node}:wal={wal_blocks}",
                      node=node, attrs={"wal_blocks": int(wal_blocks)})


def chain_byzantine(node: str) -> TraceEvent:
    return TraceEvent("chain.byzantine", f"chain:byzantine:{node}", node=node)


def tx_revert(node: str, method: str) -> TraceEvent:
    return TraceEvent("tx.revert", f"{node}:tx-revert:{method}", node=node,
                      attrs={"method": method})


def pull_fail(node: str, cid: str) -> TraceEvent:
    return TraceEvent("pull.fail", f"{node}:pull-fail:{cid[:TX_W]}", node=node,
                      attrs={"cid": cid[:TX_W]})


def score_fetch_fail(node: str, cid: str) -> TraceEvent:
    return TraceEvent("score.fetch-fail",
                      f"{node}:score-fetch-fail:{cid[:TX_W]}", node=node,
                      attrs={"cid": cid[:TX_W]})


def multikrum_fetch_fail(cid: str) -> TraceEvent:
    return TraceEvent("score.fetch-fail", f"multikrum:fetch-fail:{cid[:TX_W]}",
                      attrs={"cid": cid[:TX_W]})


def scorer_fault(node: str, mode: str) -> TraceEvent:
    """An injected scorer fault changed state: 'collude' / 'byzantine'
    armed, or 'healed' (cleared)."""
    return TraceEvent("trust.scorer-fault", f"trust:scorer-fault:{node}:{mode}",
                      node=node, attrs={"mode": mode})


def equivocation_report(reporter: str, sealer: str, height: int) -> TraceEvent:
    """A replica observed two conflicting sealed headers and is submitting
    the slashing proof on-chain."""
    return TraceEvent("trust.equivocation-report",
                      f"trust:equivocation:{sealer}@{height}:by:{reporter}",
                      node=reporter,
                      attrs={"sealer": sealer, "height": int(height)})


def edge_round(silo: str, rnd: int, participants: int,
               nbytes: int) -> TraceEvent:
    """One edge-fleet aggregation round at a silo: sampled participants
    trained and FedAvg'd up before the cross-silo round."""
    return TraceEvent("edge.round",
                      f"edge:round:{silo}:r{rnd}:n={participants}",
                      node=silo, attrs={"round": int(rnd),
                                        "participants": int(participants),
                                        "nbytes": int(nbytes)})


def light_head(client: str, height: int) -> TraceEvent:
    """A light client accepted an announced head header."""
    return TraceEvent("light.head", f"light:head:{client}:h{height}",
                      node=client, attrs={"height": int(height)})


def light_verify(client: str, txid: str, ok: bool) -> TraceEvent:
    """A light client checked a per-tx Merkle inclusion proof against its
    header chain ('my silo's model landed on-chain')."""
    return TraceEvent("light.verify",
                      f"light:verify:{client}:{txid}:{'ok' if ok else 'FAIL'}",
                      node=client, attrs={"txid": txid, "ok": bool(ok)})
