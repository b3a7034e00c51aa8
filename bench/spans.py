"""Spans of the program's round step, timed on the device, and where they
put the profiled steps' device time.

The spans are the program's own (``core/exchange.py`` times ``round``,
each pod's ``train`` with ``train.forward``, ``train.backward`` and
``train.update`` inside, and ``exchange`` with ``exchange.q8``,
``exchange.score`` and ``exchange.merge``), recorded by the port's
``obs.tracer.Tracer`` with a pair of CUDA events a span. Importing this
module installs one in the program where a CUDA device is visible. The
harness loads the readers, and with them this module, only in traced runs
(``--trace 1``): an untraced run keeps the program's no-op tracer. A
program without timed spans (an earlier version) gets no tracer, and
every reader then returns None.

A traced run's round steps, in order: ``checked_steps`` (set-up), one
warm step, ``window_steps`` (the window), ``profiled_steps`` (the
device-only profiler session) and, on a card, one step with the host's
operations recorded. The window's rounds give each span's device wall
(CUDA events; no profiler runs). The profiled rounds are placed on the
profiler's device timeline by one anchor, the end of the last profiled
``round`` on the end of the trace's last device interval: every kernel
runs in order on the one stream, and after the last step only the
synchronize follows. Each stretch of the profiled steps' device time,
busy or idle, is then charged to the innermost span whose placed interval
holds it, and each kernel to the one that holds its middle; the idle
readers take a span's placed wall less its busy time there, where the
harness does not synchronize. The window's walls (the ``*_ms`` readers)
lie between the harness's synchronizes before each pod's train step and
around the exchange, so the first span inside each holds the drained
queue's wait for the host's first launches. A span boundary is an event
recorded between two launches on the stream, so it lies in a gap between
device intervals where the two clocks agree: how far one falls inside an
interval is the anchor's error.
"""
from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict

import torch

from bench import program
from bench.trace import short

Q8_BYTES = 6           # bf16 read, int8 written, int8 read, bf16 written


def install():
    """A recording tracer in the program's round step (timing the device
    where CUDA is available); None (and nothing installed) where the
    program has no timed spans."""
    program.path()
    from repro_torch.core import exchange
    from repro_torch.obs import tracer as obs_tracer
    if not hasattr(exchange, "tracer") or \
            not hasattr(obs_tracer.Tracer, "timed"):
        return None
    exchange.tracer = obs_tracer.Tracer()
    return exchange.tracer


def uninstall() -> None:
    program.path()
    from repro_torch.core import exchange
    from repro_torch.obs.tracer import NULL_TRACER
    exchange.tracer = NULL_TRACER


def installed():
    """The program's recording tracer, or None."""
    mod = sys.modules.get("repro_torch.core.exchange")
    tr = getattr(mod, "tracer", None)
    return tr if getattr(tr, "enabled", False) else None


def _overlap(busy, starts, a, b) -> float:
    """Length of [a, b] covered by the sorted, disjoint ``busy``."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    got = 0.0
    while i < len(busy) and busy[i][0] < b:
        got += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return got


def _first_busy(busy, starts, a, b):
    i = max(0, bisect.bisect_right(starts, a) - 1)
    while i < len(busy) and busy[i][0] < b:
        if busy[i][1] > a:
            return max(a, busy[i][0])
        i += 1
    return None


def _inside(dev, dev_starts, t) -> float:
    """How far ``t`` lies inside a device interval (0 in a gap)."""
    i = bisect.bisect_left(dev_starts, t)
    got = 0.0
    # one stream: only the last few started can still run at t
    for s, e, _ in dev[max(0, i - 8):i]:
        if s < t < e:
            got = max(got, min(t - s, e - t))
    return got


def charge(rounds, trace) -> dict:
    """The profiled ``rounds`` placed on ``trace`` (µs) by the anchor (the
    last round's end on the trace's last device interval), and what each
    span kind holds a step: ``busy`` (the busy union inside its spans),
    ``self_busy`` / ``self_idle`` / ``kernels`` / ``top`` (what falls in
    no span inside them), ``wall`` (placed), ``lead`` (device time from a
    span's start to its first busy stretch); and the checks:
    ``anchor_error_us`` (the farthest a placed span boundary falls inside
    a device interval), ``outside_pct`` (device time outside every round,
    of all device time), ``charged_pct`` (busy time charged to spans, of
    the busy union)."""
    k = len(rounds)
    spans = [sp for r in rounds for sp in r]
    byid = {sp.id: sp for sp in spans}
    off = max(e for _, e, _ in trace.device) - rounds[-1][0].dev1_ns / 1e3
    at = {sp.id: (sp.dev0_ns / 1e3 + off, sp.dev1_ns / 1e3 + off)
          for sp in spans}
    depth = {}
    for sp in spans:                       # parents open before children
        depth[sp.id] = 0 if sp.parent not in depth else depth[sp.parent] + 1
    busy = trace.busy_intervals()
    starts = [s for s, _ in busy]

    # the innermost span of each stretch between span boundaries
    edges = sorted({t for ab in at.values() for t in ab})
    segs = []
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        held = [i for i, (s, e) in at.items() if s <= mid < e]
        if held:
            segs.append((a, b, max(held, key=depth.__getitem__)))
    seg_starts = [a for a, _, _ in segs]

    per = defaultdict(lambda: defaultdict(float))       # µs a step
    count = defaultdict(float)
    tops = defaultdict(lambda: defaultdict(float))
    for sid, (a, b) in at.items():
        kind = byid[sid].kind
        per[kind]["wall"] += (b - a) / k
        per[kind]["busy"] += _overlap(busy, starts, a, b) / k
        first = _first_busy(busy, starts, a, b)
        per[kind]["lead"] += ((b if first is None else first) - a) / k
    charged = 0.0
    for a, b, sid in segs:
        kind = byid[sid].kind
        got = _overlap(busy, starts, a, b)
        charged += got
        per[kind]["self_busy"] += got / k
        per[kind]["self_idle"] += (b - a - got) / k
    for s, e, name in trace.kernels():
        i = bisect.bisect_right(seg_starts, (s + e) / 2) - 1
        if i >= 0 and segs[i][0] <= (s + e) / 2 < segs[i][1]:
            kind = byid[segs[i][2]].kind
            count[kind] += 1 / k
            tops[kind][short(name)] += (e - s) / k
    roots = sorted(at[r[0].id] for r in rounds)
    total = sum(e - s for s, e, _ in trace.device)
    inside = sum(max(0.0, min(e, b) - max(s, a))
                 for s, e, _ in trace.device for a, b in roots)
    dev_starts = [s for s, _, _ in trace.device]
    err = max(_inside(trace.device, dev_starts, t)
              for ab in at.values() for t in ab)
    union = sum(e - s for s, e in busy)
    out = {kind: {**{key: v / 1e3 for key, v in d.items()},      # ms
                  "kernels": count[kind]} for kind, d in per.items()}
    for kind, names in tops.items():
        out[kind]["top"] = [[n, v / 1e3] for n, v in sorted(
            names.items(), key=lambda nv: -nv[1])[:3]]
    return {"kinds": out, "anchor_error_us": err,
            "outside_pct": 100.0 * (total - inside) / total if total else 0.0,
            "charged_pct": 100.0 * charged / union if union else 0.0}


def place(rounds, ctx):
    """What the readers take from the tracer's ``rounds`` in a run whose
    context is ``ctx``: the window's device wall a step by span kind (ms),
    the values coded a step (``elements``), and ``charge`` of the profiled
    rounds (None where they are not all resolved). None where the rounds
    are not this run's steps in the order the harness runs them, or where
    the run has no device trace (no card)."""
    c, k, n = ctx.mix["checked_steps"], ctx.mix["profiled_steps"], \
        ctx.window_steps
    by_id = {r[0].round: r for r in rounds if r}
    if not ctx.trace.device or not n or not by_id or \
            max(by_id) != c + n + k + 1:
        return None
    window = [by_id[i] for i in range(c + 1, c + 1 + n) if i in by_id]
    window = [r for r in window if r[0].dev1_ns is not None]
    if not window:
        return None
    wall, elements = defaultdict(float), 0
    for r in window:
        for sp in r:
            wall[sp.kind] += (sp.dev1_ns - sp.dev0_ns) / 1e6 / len(window)
            elements += sp.attrs.get("elements", 0) / len(window)
    res = {"window_rounds": len(window), "wall_ms": dict(wall),
           "elements": elements, "profiled": None}
    profiled = [by_id.get(i) for i in range(c + 1 + n, c + 1 + n + k)]
    if all(r and r[0].dev1_ns is not None for r in profiled):
        res["profiled"] = charge(profiled, ctx.trace)
    return res


def analysis(ctx):
    """``place`` of the installed tracer's rounds, once a run (kept on
    ``ctx``; the first call prints it on standard error)."""
    if "round_spans" not in vars(ctx):
        tr = installed()
        ctx.round_spans = None if tr is None else place(tr.rounds(), ctx)
        if ctx.round_spans is not None:
            print("round spans: " + json.dumps(report(ctx)), file=sys.stderr)
    return ctx.round_spans


def wall_ms(ctx, kind: str):
    """Device wall a window step inside the spans of ``kind``."""
    a = analysis(ctx)
    return None if a is None else a["wall_ms"].get(kind)


def idle_ms(ctx, kind: str):
    """The spans of ``kind`` in the profiled steps: their placed device
    wall a step less the busy union inside them, both on the profiler's
    clock. The harness does not synchronize in those steps (its ``Spans``
    is off), so this is the program's own idle, and the profiler's stretch
    of kernel time is on both sides."""
    a = analysis(ctx)
    if a is None or not a["profiled"] or \
            kind not in a["profiled"]["kinds"]:
        return None
    d = a["profiled"]["kinds"][kind]
    return d["wall"] - d["busy"]


def report(ctx) -> dict:
    """The per-span table of a traced run (ms a step): window wall (which,
    between the harness's synchronizes, holds the drained queue's wait),
    and from the profiled steps placed wall, busy, idle before the first
    kernel, self time, kernels and the top kernels; the anchor's checks;
    each kind's idle as ``idle_ms`` reads it; and the idle outside the
    round step (the window's step less its ``round`` wall)."""
    a = ctx.round_spans
    out = {"window_rounds": a["window_rounds"], "wall_ms": a["wall_ms"],
           "elements": a["elements"]}
    if "round" in a["wall_ms"]:
        out["idle_outside_round_ms"] = \
            1e3 * ctx.window_s / ctx.window_steps - a["wall_ms"]["round"]
    if a["profiled"]:
        p = a["profiled"]
        out.update({key: p[key] for key in
                    ("anchor_error_us", "outside_pct", "charged_pct")})
        out["profiled"] = p["kinds"]
        out["idle_ms"] = {kind: idle_ms(ctx, kind) for kind in p["kinds"]}
    return out


if torch.cuda.is_available():
    install()
