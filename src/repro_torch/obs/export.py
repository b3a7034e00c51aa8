"""Exporters: Chrome-trace-event JSON (Perfetto-loadable) + metrics snapshot.

``chrome_trace`` renders a ``Tracer``'s spans and instants into the Chrome
trace-event format (the JSON flavour ``chrome://tracing`` and
https://ui.perfetto.dev load directly):

  * track names ``process/thread`` map to one pid per process group (a silo,
    ``link``, ``orchestrator``) and one tid per thread within it (``phases``,
    ``a~b/fg``, ...), named via ``"M"`` metadata events;
  * spans become ``"X"`` complete events — simulated seconds scaled to
    trace micros (``ts``/``dur``), span attrs under ``args``;
  * instants become thread-scoped ``"i"`` events;
  * timed spans (the round step's, ``Tracer.timed``) become ``"X"`` events
    twice: their host interval on ``<track>/host`` and their device
    interval on ``<track>/device``, in microseconds from the first kept
    round's start, the device's clock set to meet the host's at the first
    root timed on both; round, id and parent under ``args``.

Events are emitted sorted by (pid, tid, ts, -dur) so same-start nested spans
render parent-first and per-track timestamps are monotone — properties the
well-formedness tests (and ``validate_chrome_trace``) check.

``write_chrome_trace`` additionally embeds the flat metrics snapshot under a
top-level ``"metrics"`` key (extra top-level keys are legal in the format
and ignored by viewers).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

_US = 1e6  # simulated seconds -> trace microseconds


def _split_track(track: str) -> Tuple[str, str]:
    """``process/thread`` track naming; a bare name is its own process."""
    if "/" in track:
        proc, thread = track.split("/", 1)
        return proc or "-", thread or "main"
    return track or "-", "main"


def _clean_args(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[str(k)] = v
        else:
            out[str(k)] = str(v)
    return out


def chrome_trace(tracer, metrics: Optional[Dict[str, Any]] = None) -> Dict:
    """Render a Tracer into a Chrome trace-event document (dict)."""
    procs: Dict[str, int] = {}
    tids: Dict[Tuple[int, str], int] = {}

    def ids(track: str) -> Tuple[int, int]:
        proc, thread = _split_track(track)
        pid = procs.setdefault(proc, len(procs) + 1)
        key = (pid, thread)
        if key not in tids:
            tids[key] = sum(1 for (p, _) in tids if p == pid) + 1
        return pid, tids[key]

    # spans and instants share tracks (e.g. a recovery span on a silo's
    # chain track next to its seal/import instants), so they must be merged
    # into ONE per-track ordering: by ts, spans before instants at the same
    # ts, longest span first (parent-first nesting).
    rows: List[Tuple[Tuple[int, int], float, int, float, Dict[str, Any]]] = []
    for s in tracer.spans:
        pid, tid = ids(s.track)
        rows.append(((pid, tid), s.t0, 0, -(s.t1 - s.t0),
                     {"name": s.kind, "cat": s.kind.split(".", 1)[0],
                      "ph": "X", "ts": round(s.t0 * _US, 3),
                      "dur": round(max(0.0, s.t1 - s.t0) * _US, 3),
                      "pid": pid, "tid": tid, "args": _clean_args(s.attrs)}))
    for t, kind, track, attrs in tracer.events:
        pid, tid = ids(track)
        rows.append(((pid, tid), t, 1, 0.0,
                     {"name": kind, "cat": kind.split(".", 1)[0],
                      "ph": "i", "s": "t", "ts": round(t * _US, 3),
                      "pid": pid, "tid": tid, "args": _clean_args(attrs)}))
    timed = _timed_rows(tracer, ids)
    rows += timed
    rows.sort(key=lambda r: (r[0], r[1], r[2], r[3], r[4]["name"]))
    events = [r[4] for r in rows]

    meta: List[Dict[str, Any]] = []
    for proc, pid in sorted(procs.items(), key=lambda kv: kv[1]):
        meta.append({"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                     "tid": 0, "args": {"name": proc}})
    for (pid, thread), tid in sorted(tids.items(),
                                     key=lambda kv: (kv[0][0], kv[1])):
        meta.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
                     "tid": tid, "args": {"name": thread}})

    doc: Dict[str, Any] = {"traceEvents": meta + events,
                           "displayTimeUnit": "ms",
                           "otherData": {"clock": "simulated-seconds*1e6"}}
    if timed:
        doc["otherData"]["timed_clock"] = \
            "host perf_counter and CUDA events, us from the first kept round"
    if metrics is not None:
        doc["metrics"] = metrics
    return doc


def _timed_rows(tracer, ids) -> List:
    """Rows of the tracer's timed spans (seconds from the first kept
    round's start on the host), host and device tracks."""
    spans = [sp for r in tracer.rounds() for sp in r]
    if not spans:
        return []
    host0 = spans[0].host0_ns
    first = next((sp for sp in spans
                  if sp.parent is None and sp.dev0_ns is not None), None)
    dev0 = None if first is None else \
        first.dev0_ns - (first.host0_ns - host0)
    rows = []
    for sp in spans:
        args = _clean_args({"round": sp.round, "id": sp.id,
                            "parent": sp.parent, **sp.attrs})
        ivs = [("host", sp.host0_ns - host0, sp.host1_ns - host0)]
        if dev0 is not None and sp.dev0_ns is not None:
            ivs.append(("device", sp.dev0_ns - dev0, sp.dev1_ns - dev0))
        for lane, a, b in ivs:
            pid, tid = ids(f"{sp.track}/{lane}")
            t0, t1 = a / 1e9, max(a, b) / 1e9
            rows.append(((pid, tid), t0, 0, -(t1 - t0),
                         {"name": sp.kind, "cat": sp.kind.split(".", 1)[0],
                          "ph": "X", "ts": round(t0 * _US, 3),
                          "dur": round((t1 - t0) * _US, 3), "pid": pid,
                          "tid": tid, "args": args}))
    return rows


def write_chrome_trace(path: str, tracer,
                       metrics: Optional[Dict[str, Any]] = None) -> Dict:
    doc = chrome_trace(tracer, metrics=metrics)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return doc


# --------------------------------------------------------------------------- #
# Validation — shared by the tests, the report CLI and `make trace`.
# --------------------------------------------------------------------------- #

_REQUIRED = ("name", "ph", "pid", "tid", "ts")


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural validation of a trace-event document. Returns a list of
    problems — empty means the trace is well-formed: known phase types,
    required fields present, non-negative ``X`` durations, metadata naming
    every (pid, tid), and monotone timestamps per track."""
    problems: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["document is not a dict with a traceEvents list"]
    named_pids, named_tids = set(), set()
    used_pids, used_tids = set(), set()
    last_ts: Dict[Tuple[int, int], float] = {}
    for i, e in enumerate(doc["traceEvents"]):
        if not isinstance(e, dict):
            problems.append(f"event[{i}]: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in e]
        if missing:
            problems.append(f"event[{i}]: missing fields {missing}")
            continue
        ph = e["ph"]
        if ph not in ("X", "i", "M"):
            problems.append(f"event[{i}]: unknown phase {ph!r}")
            continue
        if not isinstance(e["ts"], (int, float)):
            problems.append(f"event[{i}]: non-numeric ts")
            continue
        if ph == "M":
            if e["name"] == "process_name":
                named_pids.add(e["pid"])
            elif e["name"] == "thread_name":
                named_tids.add((e["pid"], e["tid"]))
            continue
        used_pids.add(e["pid"])
        used_tids.add((e["pid"], e["tid"]))
        key = (e["pid"], e["tid"])
        if e["ts"] < last_ts.get(key, float("-inf")):
            problems.append(f"event[{i}]: ts {e['ts']} not monotone on "
                            f"track pid={key[0]} tid={key[1]}")
        last_ts[key] = e["ts"]
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event[{i}]: X event with bad dur {dur!r}")
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            problems.append(f"event[{i}]: instant with bad scope "
                            f"{e.get('s')!r}")
    for pid in used_pids - named_pids:
        problems.append(f"pid {pid} has no process_name metadata")
    for key in used_tids - named_tids:
        problems.append(f"(pid,tid) {key} has no thread_name metadata")
    return problems
