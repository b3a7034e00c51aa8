"""The benchmark of the port: one run of one cell.

  python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` beside ``bench/`` and
``src/``). Prints the card and its power limit, then, as its last lines
on standard error, each number the check compared beside its limit, and
as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``. Exits 2, and
prints no result, where no card or too few cards are visible, and 3
where JAX, Flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):          # run as a file: python3 bench/run.py
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness
    w, _, _ = harness.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < w["chips"]:
        print(f"bench.run: {args.workload} needs {w['chips']} CUDA device(s), "
              f"{have} visible; no result", file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr, flush=True)
    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench.run: loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        limit = "not compared" if c["limit"] is None else \
            f"limit {c['limit']}"
        print(f"check {name}: {c['value']} ({limit})", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
