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

Timed spans (``timed``) are the other clock: spans inside the multi-pod
round step (``core/exchange.py``), each timed on the host
(``time.perf_counter_ns``) and, where CUDA is available, on the device by
a pair of CUDA events recorded on the current stream. A span opened with
no timed span open is a root: it and every span opened inside it form one
round, all under the root's round id, and the tracer keeps only the last
``KEEP_ROUNDS`` rounds. Device times are resolved lazily (``rounds``),
once the device has passed a round's events: the tracer never
synchronizes. Nothing is put into a profiler's timeline (no
``record_function``, no NVTX range).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.obs.metrics import MetricsRegistry

KEEP_ROUNDS = 256      # timed rounds kept: more than a benchmark window's


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


@dataclass
class TimedSpan:
    """One timed span of a round step. Host times are ``perf_counter_ns``;
    device times are nanoseconds on the device from the start of the first
    round the tracer resolved, None until resolved or where the tracer
    times no device. ``parent`` is the id of the span it was opened in
    (None for a round's root); every span of a round has the root's
    ``round``."""
    kind: str
    track: str
    id: int
    parent: Optional[int]
    round: int
    host0_ns: int
    host1_ns: int = 0
    dev0_ns: Optional[float] = None
    dev1_ns: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)


class _NullTimed:
    """The one no-op context every ``NullTracer.timed`` call returns."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_TIMED = _NullTimed()


class NullTracer:
    """Zero-overhead stand-in: obs off means these no-ops are the whole
    cost. Instrument sites may also branch on ``enabled`` to skip building
    attrs dicts entirely."""

    enabled = False

    def timed(self, kind: str, track: Optional[str] = None, **attrs):
        return _NULL_TIMED

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


class _Round:
    """A kept round: its spans, the CUDA events of those not yet resolved
    ((span, start, end) in the order they opened), its root's start event
    (``origin``) and where that lies on the device (``base_ns``, from the
    first round's start)."""
    __slots__ = ("spans", "pending", "origin", "base_ns")

    def __init__(self):
        self.spans: List[TimedSpan] = []
        self.pending: List[Tuple[TimedSpan, Any, Any]] = []
        self.origin = None
        self.base_ns: Optional[float] = None


class _Timed:
    """The context ``Tracer.timed`` returns: opens the span on entry
    (yielding its ``TimedSpan``, whose ``attrs`` may take counters) and
    closes it on exit."""
    __slots__ = ("tracer", "kind", "track", "attrs", "span", "start")

    def __init__(self, tracer: "Tracer", kind: str, track: Optional[str],
                 attrs: Dict[str, Any]):
        self.tracer, self.kind, self.track, self.attrs = \
            tracer, kind, track, attrs

    def __enter__(self) -> TimedSpan:
        return self.tracer._open_timed(self)

    def __exit__(self, *exc) -> None:
        self.tracer._close_timed(self)


class Tracer(NullTracer):
    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry
        self.spans: List[Span] = []
        # (t, kind, track, attrs) instants — typed events and point markers
        self.events: List[Tuple[float, str, str, Dict[str, Any]]] = []
        self._open: List[_OpenSpan] = []
        # timed spans: the last KEEP_ROUNDS rounds, the open spans' stack
        self.cuda = torch.cuda.is_available()
        self._rounds: deque = deque()
        self._stack: List[_Timed] = []
        self._free: List[Any] = []           # CUDA events to reuse
        self._next_id = 0
        self._next_round = 0
        # the last round resolved, kept (with its origin) after it leaves
        # the ring until the next round is placed from it
        self._prev: Optional[_Round] = None

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

    # -- timed spans (host clock + CUDA events) ------------------------------ #
    def timed(self, kind: str, track: Optional[str] = None,
              **attrs) -> _Timed:
        """A span timed on the host and, where CUDA is available, on the
        device, as a context manager. ``track`` defaults to the enclosing span's
        (a root's to its kind)."""
        return _Timed(self, kind, track, attrs)

    def _event(self):
        ev = self._free.pop() if self._free else \
            torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _open_timed(self, t: _Timed) -> TimedSpan:
        parent = self._stack[-1].span if self._stack else None
        if parent is None:
            if len(self._rounds) >= KEEP_ROUNDS:
                self._evict()
            self._rounds.append(_Round())
            rid, self._next_round = self._next_round, self._next_round + 1
        else:
            rid = parent.round
        track = t.track or (parent.track if parent is not None else t.kind)
        sp = TimedSpan(t.kind, track, self._next_id,
                       None if parent is None else parent.id, rid,
                       time.perf_counter_ns(), attrs=t.attrs)
        self._next_id += 1
        t.span = sp
        t.start = self._event() if self.cuda else None
        rnd = self._rounds[-1]
        if parent is None and self.cuda:
            rnd.origin = t.start
        rnd.spans.append(sp)
        self._stack.append(t)
        return sp

    def _close_timed(self, t: _Timed) -> None:
        end = self._event() if self.cuda else None
        t.span.host1_ns = time.perf_counter_ns()
        self._stack.pop()
        if self.cuda:
            self._rounds[-1].pending.append((t.span, t.start, end))

    def _evict(self) -> None:
        """Drop the oldest round. What the device has passed is resolved
        first; an unresolved round's events go back to the pool. The last
        round resolved stays ``_prev``, its origin kept, so the next round
        still takes its place on the device from it."""
        self._resolve()
        old = self._rounds.popleft()
        for _, a, b in old.pending:
            self._free += [a, b]

    def _resolve(self) -> None:
        """Device times of every closed round the device has passed, in
        order: each span from its round's origin, each origin from the
        previous resolved round's (then returned to the pool), the first
        at 0. Stops at the first round whose last event the device has not
        reached."""
        for rnd in self._rounds:
            if self._stack and rnd is self._rounds[-1]:
                return                     # still open
            if not rnd.pending:
                continue
            if not rnd.pending[-1][2].query():
                return
            prev = self._prev
            rnd.base_ns = 0.0 if prev is None else prev.base_ns + \
                1e6 * prev.origin.elapsed_time(rnd.origin)
            for sp, a, b in rnd.pending:
                sp.dev0_ns = rnd.base_ns + 1e6 * rnd.origin.elapsed_time(a)
                sp.dev1_ns = rnd.base_ns + 1e6 * rnd.origin.elapsed_time(b)
                if a is not rnd.origin:
                    self._free.append(a)
                self._free.append(b)
            rnd.pending = []
            if prev is not None:
                self._free.append(prev.origin)
                prev.origin = None
            self._prev = rnd

    def rounds(self) -> List[List[TimedSpan]]:
        """The kept rounds, oldest first, each its spans in the order they
        opened; device times resolved for every round the device has
        passed (call after a synchronize to have them all)."""
        if self.cuda:
            self._resolve()
        return [list(r.spans) for r in self._rounds]

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
