"""Run-report CLI: ``python -m repro_torch.obs.report trace.json``.

Reads an exported Chrome-trace JSON (``repro_torch.obs.export``) and prints the
two tables the paper's §6 evaluation turns on:

  * a per-silo **round-phase breakdown** — simulated seconds spent in
    train / fetch-stall / score / chain-wait / recovery, per process that
    carries ``phase.*`` spans;
  * the **top-K WAN byte flows** — ``net.*`` transfer spans summed by
    (src, dst), with transfer counts and the traffic kinds on each flow.

``--validate`` runs the structural validator first and exits non-zero on a
malformed trace (used by ``make trace`` / CI).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Tuple

PHASES = ("train", "fetch-stall", "score", "chain-wait", "recovery")


def _tracks(doc: Dict) -> Tuple[Dict[int, str], Dict[Tuple[int, int], str]]:
    """pid -> process name, (pid, tid) -> thread name from metadata."""
    pids: Dict[int, str] = {}
    tids: Dict[Tuple[int, int], str] = {}
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            pids[e["pid"]] = e["args"]["name"]
        elif e.get("name") == "thread_name":
            tids[(e["pid"], e["tid"])] = e["args"]["name"]
    return pids, tids


def phase_breakdown(doc: Dict) -> Dict[str, Dict[str, float]]:
    """Per-process simulated seconds in each ``phase.*`` span kind."""
    pids, _ = _tracks(doc)
    out: Dict[str, Dict[str, float]] = {}
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X" or not str(e.get("name", "")).startswith(
                "phase."):
            continue
        proc = pids.get(e["pid"], str(e["pid"]))
        phase = e["name"][len("phase."):]
        row = out.setdefault(proc, {p: 0.0 for p in PHASES})
        row.setdefault(phase, 0.0)
        row[phase] += e.get("dur", 0.0) / 1e6
        rnd = e.get("args", {}).get("round")
        if isinstance(rnd, int):
            row["rounds"] = max(row.get("rounds", 0), rnd)
    return out


def top_flows(doc: Dict, k: int = 10) -> List[Dict[str, Any]]:
    """Top-K (src, dst) WAN flows by bytes from ``net.*`` transfer spans."""
    flows: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X" or not str(e.get("name", "")).startswith("net."):
            continue
        args = e.get("args", {})
        src, dst = args.get("src"), args.get("dst")
        if not src or not dst:
            continue
        f = flows.setdefault((src, dst), {"src": src, "dst": dst,
                                          "bytes": 0, "transfers": 0,
                                          "kinds": set()})
        f["bytes"] += int(args.get("nbytes", 0))
        f["transfers"] += 1
        f["kinds"].add(e["name"][len("net."):])
    rows = sorted(flows.values(), key=lambda f: (-f["bytes"], f["src"],
                                                 f["dst"]))[:max(0, k)]
    for f in rows:
        f["kinds"] = ",".join(sorted(f["kinds"]))
    return rows


def render(doc: Dict, k: int = 10) -> str:
    lines: List[str] = []
    breakdown = phase_breakdown(doc)
    silo_rows = {p: r for p, r in breakdown.items()
                 if any(r.get(ph, 0.0) > 0 for ph in PHASES)}
    lines.append("Per-silo round-phase breakdown (simulated seconds)")
    hdr = f"{'process':<14}" + "".join(f"{p:>12}" for p in PHASES) \
        + f"{'rounds':>8}"
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for proc in sorted(silo_rows):
        r = silo_rows[proc]
        lines.append(f"{proc:<14}"
                     + "".join(f"{r.get(p, 0.0):>12.3f}" for p in PHASES)
                     + f"{r.get('rounds', 0):>8}")
    if not silo_rows:
        lines.append("(no phase.* spans in trace)")
    lines.append("")
    lines.append(f"Top {k} WAN byte flows")
    hdr2 = (f"{'src':<14}{'dst':<14}{'bytes':>14}{'transfers':>11}  kinds")
    lines.append(hdr2)
    lines.append("-" * len(hdr2))
    flows = top_flows(doc, k)
    for f in flows:
        lines.append(f"{f['src']:<14}{f['dst']:<14}{f['bytes']:>14}"
                     f"{f['transfers']:>11}  {f['kinds']}")
    if not flows:
        lines.append("(no net.* transfer spans in trace)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a repro_torch.obs Chrome-trace JSON: per-silo "
                    "round-phase breakdown + top-K WAN byte flows.")
    ap.add_argument("trace", help="trace JSON written by --trace/make trace")
    ap.add_argument("--top", type=int, default=10, metavar="K",
                    help="flows to list (default 10)")
    ap.add_argument("--validate", action="store_true",
                    help="run the structural validator first; exit 1 on a "
                         "malformed trace")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    if args.validate:
        from repro_torch.obs.export import validate_chrome_trace
        problems = validate_chrome_trace(doc)
        if problems:
            for p in problems:
                print(f"INVALID: {p}", file=sys.stderr)
            return 1
        print(f"trace OK: {len(doc['traceEvents'])} events")
    print(render(doc, args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
