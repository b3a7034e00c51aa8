"""Span tracer over the simulated clock (repro_torch.obs).

Two implementations behind one interface:

  * ``NullTracer`` — the shared, stateless no-op every ``SimEnv`` starts
    with. All methods are empty and ``enabled`` is False, so instrumented
    hot paths (fabric transfers, silo phases) cost one attribute read and a
    predictable branch when observability is off.
  * ``Tracer`` — records spans (begin/end or ``span_at``) and instant
    events onto named tracks, all timestamped with *simulated seconds*
    passed by the caller (the tracer never reads a clock — it stays usable
    for host-time benchmark sections too).

Track names follow a ``process/thread`` convention consumed by the Chrome
exporter: ``silo0/phases`` (per-silo round-phase lane), ``link/a~b/fg``
(per-link QoS-lane occupancy), ``silo0/chain`` (consensus events),
``orchestrator/rounds``. The part before the first ``/`` groups tracks into
one Perfetto process.

Spans may be left open by crashes (a killed silo never reaches its
``finish`` callback): ``close_track`` truncates a track's open spans at the
kill time (``aborted=True``), and ``finish`` closes everything that remains
at run end (``truncated=True``) — exported traces therefore always have
matched begin/end pairs, which the well-formedness tests assert.

When constructed with a ``MetricsRegistry``, every closed span feeds a
``span:<kind>`` duration histogram.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry


@dataclass
class Span:
    """One closed interval on a track (simulated seconds)."""
    kind: str
    track: str
    t0: float
    t1: float
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _OpenSpan:
    __slots__ = ("kind", "track", "t0", "attrs", "closed")

    def __init__(self, kind: str, track: str, t0: float,
                 attrs: Dict[str, Any]):
        self.kind = kind
        self.track = track
        self.t0 = t0
        self.attrs = attrs
        self.closed = False


class NullTracer:
    """Zero-overhead stand-in: obs off means these no-ops are the whole
    cost. Instrument sites may also branch on ``enabled`` to skip building
    attrs dicts entirely."""

    enabled = False

    def record(self, t: float, event) -> None:
        pass

    def event(self, kind: str, track: str, t: float, **attrs) -> None:
        pass

    def begin(self, kind: str, track: str, t: float, **attrs):
        return None

    def end(self, handle, t: float, **attrs) -> None:
        pass

    def span_at(self, kind: str, track: str, t0: float, t1: float,
                **attrs) -> None:
        pass

    def close_track(self, track: str, t: float, **attrs) -> None:
        pass

    def finish(self, t: float) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry
        self.spans: List[Span] = []
        # (t, kind, track, attrs) instants — typed events and point markers
        self.events: List[Tuple[float, str, str, Dict[str, Any]]] = []
        self._open: List[_OpenSpan] = []

    # -- instants ------------------------------------------------------------- #
    def record(self, t: float, event) -> None:
        """Ingest a ``SimEnv.emit``ed item: TraceEvent or plain string."""
        kind = getattr(event, "kind", "note")
        node = getattr(event, "node", "")
        attrs = dict(getattr(event, "attrs", ()) or {})
        attrs.setdefault("text", str(event))
        track = f"{node}/events" if node else "net/events"
        self.events.append((t, kind, track, attrs))

    def event(self, kind: str, track: str, t: float, **attrs) -> None:
        self.events.append((t, kind, track, attrs))

    # -- spans ---------------------------------------------------------------- #
    def begin(self, kind: str, track: str, t: float, **attrs) -> _OpenSpan:
        sp = _OpenSpan(kind, track, t, attrs)
        self._open.append(sp)
        return sp

    def end(self, handle: Optional[_OpenSpan], t: float, **attrs) -> None:
        """Close an open span. Closing an already-closed (or None) handle is
        a no-op: ``close_track`` may have truncated it at a crash first."""
        if handle is None or handle.closed:
            return
        handle.closed = True
        self._open.remove(handle)
        handle.attrs.update(attrs)
        self._commit(Span(handle.kind, handle.track, handle.t0, max(
            handle.t0, t), handle.attrs))

    def span_at(self, kind: str, track: str, t0: float, t1: float,
                **attrs) -> None:
        """Record a whole span after the fact (start/end both known)."""
        self._commit(Span(kind, track, t0, max(t0, t1), attrs))

    def close_track(self, track: str, t: float, **attrs) -> None:
        """Truncate every open span on ``track`` at ``t`` (crash/kill)."""
        for sp in [s for s in self._open if s.track == track]:
            self.end(sp, max(sp.t0, t), **(attrs or {"aborted": True}))

    def finish(self, t: float) -> None:
        """Run end: close whatever is still open so every exported trace has
        matched begin/end pairs."""
        for sp in list(self._open):
            self.end(sp, max(sp.t0, t), truncated=True)

    def _commit(self, span: Span) -> None:
        self.spans.append(span)
        if self.registry is not None:
            self.registry.histogram(f"span:{span.kind}").observe(
                span.duration)

    # -- introspection --------------------------------------------------------- #
    @property
    def open_count(self) -> int:
        return len(self._open)

    def spans_of(self, kind: str) -> List[Span]:
        return [s for s in self.spans if s.kind == kind]

    def tracks(self) -> List[str]:
        seen = {s.track for s in self.spans}
        seen.update(track for _, _, track, _ in self.events)
        return sorted(seen)
