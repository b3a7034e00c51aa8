"""Deterministic discrete-event runtime for the orchestrator.

Silo compute (client SGD, scoring forward passes) executes for real on this
host; the *clock* is simulated so device heterogeneity, stragglers, failures,
and phase windows are reproducible (and benchmark wall-clock comparisons
Sync-vs-Async match the paper's mechanism rather than host noise). Real
measured compute time can be folded into task durations via time_scale.

Events are cancellable handles and may carry a ``key`` (used by the network
fabric for in-flight transfers: node churn cancels every pending transfer
keyed to the dead node). A key maps to at most ONE live event: scheduling
under a key that already has a pending, non-cancelled event **cancels the
old event and replaces it** (cancel-and-replace). The fabric relies on this
— re-announcing a CID while a prefetch for it is still in flight must
supersede the stale transfer, not race it. ``run(until=deadline)`` advances
the clock *to* the deadline when the queue drains early — a deadline means
the orchestrator waited that long, so later events (e.g. a straggler's
submission) observe the elapsed window.

Two run loops share the same heap and semantics:

  * the **batched** engine (default) pops every event inside a
    ``batch_epsilon_s`` window off the heap as one batch and executes it in
    exact ``(time, counter)`` order — a merge guard re-checks the heap head
    before each batch item so callbacks that schedule *into* the window
    cannot be overtaken. Batch-level hooks (``add_batch_hook``) fire once
    per batch: the fair-share fabric uses them to settle flow rates once
    per window instead of once per event. Cancelled events are compacted
    out of the heap in bulk when their fraction crosses
    ``compact_frac`` (lazy deletion otherwise).
  * the **reference** engine (``reference=True``) is the pre-batching
    one-event-at-a-time loop, kept for span-for-span timeline parity checks
    and as the baseline for the ``netbench --scale`` events/sec sweep. It
    fires batch hooks after every executed event and never compacts.

With ``batch_epsilon_s == 0`` a batch is exactly the set of same-timestamp
events and the two engines produce identical timelines; a positive epsilon
coalesces nearby timestamps into one hook flush (events still execute in
exact order — only *hook frequency* coarsens).
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs.tracer import NULL_TRACER


class Trace:
    """The env's ``(time, note)`` event log. ``cap > 0`` bounds it as a
    ring buffer: appends beyond the cap evict oldest-first (O(1)), with the
    eviction count kept in ``dropped`` — thousand-silo sweeps stay bounded
    while recent history remains greppable. Notes are plain strings or
    ``repro_torch.obs.events.TraceEvent``s (string-compatible). Also reused by
    ``NetFabric.trace`` for TransferRecords; compares equal to any sequence
    with the same items so seeded-run equality checks keep working."""

    __slots__ = ("_items", "cap", "dropped")

    def __init__(self, cap: int = 0):
        self._items: deque = deque()
        self.cap = int(cap)
        self.dropped = 0

    def append(self, item) -> None:
        self._items.append(item)
        if self.cap > 0 and len(self._items) > self.cap:
            self._items.popleft()
            self.dropped += 1

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._items)[i]
        return self._items[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, Trace):
            return list(self._items) == list(other._items)
        if isinstance(other, (list, tuple, deque)):
            return list(self._items) == list(other)
        return NotImplemented

    def clear(self) -> None:
        self._items.clear()

    def __repr__(self) -> str:
        return f"Trace({list(self._items)!r}, cap={self.cap})"


class Event:
    """A scheduled callback. ``cancel()`` makes the runtime skip it."""

    __slots__ = ("time", "fn", "note", "key", "cancelled", "_env", "_in_q")

    def __init__(self, time: float, fn: Callable, note: str = "",
                 key: Any = None):
        self.time = time
        self.fn = fn
        self.note = note
        self.key = key
        self.cancelled = False
        self._env = None
        self._in_q = False

    def cancel(self) -> None:
        if self.cancelled:
            return
        self.cancelled = True
        # while still heap-resident, tell the env so it can track the
        # cancelled fraction and compact when lazy deletion piles up
        if self._env is not None and self._in_q:
            self._env._note_cancel()


class SimEnv:
    """Event scheduler. See the module docstring for the two run loops.

    ``batch_epsilon_s``: timestamps within this window of the batch head are
    popped as one batch (0.0 = exact same-timestamp batching only).
    ``compact_frac``/``compact_min``: rebuild the heap without cancelled
    entries once ``cancelled >= max(compact_min, compact_frac * len(heap))``.
    ``reference``: run the pre-batching loop (parity oracle / scale-sweep
    baseline).
    """

    def __init__(self, trace_cap: int = 0, *, batch_epsilon_s: float = 0.0,
                 compact_frac: float = 0.25, compact_min: int = 64,
                 reference: bool = False):
        self.now = 0.0
        self._q: List[Tuple[float, int, Event]] = []
        self._counter = itertools.count()
        self._keyed: Dict[Any, Event] = {}
        self.trace = Trace(cap=trace_cap)
        self.batch_epsilon_s = float(batch_epsilon_s)
        self.compact_frac = float(compact_frac)
        self.compact_min = int(compact_min)
        self.reference = bool(reference)
        self._cancelled_in_q = 0
        self._batch_hooks: List[Callable[[], None]] = []
        # counters for the scale sweep / engine introspection
        self.events_run = 0     # executed (non-cancelled) events
        self.batches = 0        # batches executed (batched engine only)
        self.compactions = 0    # heap compaction passes
        # span/instant tracer (repro_torch.obs): the shared no-op unless the
        # orchestrator installs a real one (ObsConfig.enabled)
        self.tracer = NULL_TRACER

    def emit(self, event) -> None:
        """Record a typed TraceEvent (or plain string) at the current
        simulated time: appended to ``trace`` for legacy greps and
        forwarded to the tracer as a structured instant."""
        self.trace.append((self.now, event))
        self.tracer.record(self.now, event)

    # ------------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------------ #

    def schedule(self, delay: float, fn: Callable, note: str = "",
                 key: Any = None) -> Event:
        """Schedule ``fn`` after ``delay``. Re-registering a live ``key``
        cancels the previous event (cancel-and-replace): the old callback
        never fires, and ``cancel(key)`` always refers to the newest."""
        ev = Event(self.now + max(0.0, delay), fn, note, key)
        ev._env = self
        if key is not None:
            prior = self._keyed.get(key)
            if prior is not None and not prior.cancelled:
                prior.cancel()
        ev._in_q = True
        heapq.heappush(self._q, (ev.time, next(self._counter), ev))
        if key is not None:
            self._keyed[key] = ev
        return ev

    def cancel(self, key: Any) -> bool:
        """Cancel the pending event registered under ``key`` (if any)."""
        ev = self._keyed.pop(key, None)
        if ev is None or ev.cancelled:
            return False
        ev.cancel()
        return True

    def add_batch_hook(self, fn: Callable[[], None]) -> None:
        """Register ``fn`` to run once per executed batch (reference engine:
        once per executed event), plus once on ``run()`` entry. The fabric's
        fair-share flow table settles rates here."""
        self._batch_hooks.append(fn)

    # ------------------------------------------------------------------ #
    # heap hygiene
    # ------------------------------------------------------------------ #

    def _note_cancel(self) -> None:
        self._cancelled_in_q += 1
        if (not self.reference
                and self._cancelled_in_q >= self.compact_min
                and self._cancelled_in_q >= self.compact_frac * len(self._q)):
            self._compact()

    def _compact(self) -> None:
        """Rebuild the heap without cancelled entries. Mutates ``self._q``
        in place so live aliases inside ``run()`` stay valid."""
        q = self._q
        live = []
        for item in q:
            ev = item[2]
            if ev.cancelled:
                ev._in_q = False
            else:
                live.append(item)
        q[:] = live
        heapq.heapify(q)
        self._cancelled_in_q = 0
        self.compactions += 1

    def _pop_cancelled_head(self) -> None:
        _, _, ev = heapq.heappop(self._q)
        ev._in_q = False
        self._cancelled_in_q = max(0, self._cancelled_in_q - 1)

    def _fire_hooks(self) -> None:
        for fn in self._batch_hooks:
            fn()

    # ------------------------------------------------------------------ #
    # run loops
    # ------------------------------------------------------------------ #

    def run(self, until: Optional[float] = None, max_events: int = 10_000_000):
        if self.reference:
            return self._run_reference(until, max_events)
        return self._run_batched(until, max_events)

    def _execute(self, t: float, ev: Event) -> None:
        if ev.key is not None and self._keyed.get(ev.key) is ev:
            del self._keyed[ev.key]
        self.now = max(self.now, t)
        if ev.note:
            self.trace.append((self.now, ev.note))
        ev.fn()
        self.events_run += 1

    def _run_batched(self, until: Optional[float], max_events: int):
        q = self._q
        if self._batch_hooks:
            self._fire_hooks()  # settle anything staged outside run()
        n = 0
        while q and n < max_events:
            while q and q[0][2].cancelled:
                self._pop_cancelled_head()
            if not q:
                break
            t0 = q[0][0]
            if until is not None and t0 > until:
                # beyond the deadline: leave the head untouched (peek, not
                # pop-and-re-push) so its (time, counter) tie rank survives
                # the run() boundary intact
                break
            limit = t0 + self.batch_epsilon_s
            if until is not None and limit > until:
                limit = until
            batch: List[Tuple[float, int, Event]] = []
            while q and len(batch) < max_events - n and q[0][0] <= limit:
                item = heapq.heappop(q)
                item[2]._in_q = False
                if item[2].cancelled:
                    self._cancelled_in_q = max(0, self._cancelled_in_q - 1)
                    continue
                batch.append(item)
            i = 0
            while i < len(batch):
                # merge guard: a callback may have scheduled an event that
                # sorts before the rest of the batch — run it first so the
                # global (time, counter) order is preserved
                while q and q[0] < batch[i]:
                    item = heapq.heappop(q)
                    item[2]._in_q = False
                    if item[2].cancelled:
                        self._cancelled_in_q = max(
                            0, self._cancelled_in_q - 1)
                        continue
                    if n >= max_events:
                        heapq.heappush(q, item)
                        item[2]._in_q = True
                        break
                    self._execute(item[0], item[2])
                    n += 1
                if n >= max_events:
                    break
                ev = batch[i][2]
                if not ev.cancelled:
                    self._execute(batch[i][0], ev)
                    n += 1
                i += 1
            # budget exhausted mid-batch: unexecuted tail goes back on the
            # heap under its original (time, counter) tuples
            for item in batch[i:]:
                if not item[2].cancelled:
                    heapq.heappush(q, item)
                    item[2]._in_q = True
            self.batches += 1
            if self._batch_hooks:
                self._fire_hooks()
        if until is not None:
            while q and q[0][2].cancelled:
                self._pop_cancelled_head()
            if not q or q[0][0] > until:
                self.now = max(self.now, until)
        return self.now

    def _run_reference(self, until: Optional[float], max_events: int):
        """Pre-batching loop: one event per pop, lazy deletion only, hooks
        after every executed event. Kept as the timeline-parity oracle and
        the ``netbench --scale`` baseline engine."""
        if self._batch_hooks:
            self._fire_hooks()
        n = 0
        while self._q and n < max_events:
            if until is not None and self._q[0][0] > until:
                break
            t, _, ev = heapq.heappop(self._q)
            ev._in_q = False
            n += 1
            if ev.cancelled:
                self._cancelled_in_q = max(0, self._cancelled_in_q - 1)
                continue
            self._execute(t, ev)
            if self._batch_hooks:
                self._fire_hooks()
        # deadline semantics: waiting until a deadline spends that time even
        # if every queued event fired earlier
        if until is not None and (not self._q or self._q[0][0] > until):
            self.now = max(self.now, until)
        return self.now

    def peek(self) -> Optional[float]:
        """Time of the next *live* queued event, or None. Cancelled heads
        are pruned on the way (so the answer stays correct across heap
        compactions and lazy deletions alike)."""
        q = self._q
        while q and q[0][2].cancelled:
            self._pop_cancelled_head()
        return q[0][0] if q else None

    def idle(self) -> bool:
        return self.peek() is None
