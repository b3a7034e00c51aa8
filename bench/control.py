"""The readings that the limits of ``correct`` are set from, at a cell's
own size, on the card. Not run by the benchmark's own runs.

  python3 -m bench.control --workload <name> --seeds 1 2 ... \
      [--control-seeds 7 8 9] [--program-faults <name> ...] \
      [--out <file>.jsonl]

For each seed: the program's set-up (the checked steps through the round
step's own call, as a run makes them) and the plain reference in float32
that follows them; the numbers compared (``judge.readings``) are the
program's lower readings. For each control seed besides: the control,
the reference put in the program's place in fp8 (the precision below the
configuration's bf16), and the faults a training cell can have, planted
in the reference in the program's place ('half_batch', 'no_exchange',
'unchanged': a state left unchanged reads 1 on ``grad`` and ``change``
by their measure, and its run reads ``loss``); and the faults that
``--program-faults`` names, planted in the program (``bench/faults.py``),
each read through the program's own set-up. One JSON line a seed goes
to ``--out`` with every reading, leaf by leaf, and the numbers to
standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from bench import faults, harness, judge
from bench.reference.round import FAULTS


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-faults", nargs="*", default=[],
                    choices=faults.PROGRAM)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench.control: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr, flush=True)
    _, cfg, mix = harness.cell(args.workload)
    fam = harness.family(cfg["family"])
    sync = torch.cuda.synchronize
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds + [s for s in args.control_seeds
                              if s not in args.seeds]:
        line = {"workload": args.workload, "seed": seed, "t": {}, "gb": {}}
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        st = harness.setup(cfg, mix, seed, "cuda", sync)
        line["t"]["program"] = time.perf_counter() - t
        line["gb"]["program"] = _peak_gb()
        prog, batches = st.prog, st.batches
        del st
        gc.collect()
        torch.cuda.empty_cache()
        digests = {"prog": prog}
        for f in args.program_faults if seed in args.control_seeds else ():
            t = time.perf_counter()
            with faults.planted(f):
                st = harness.setup(cfg, mix, seed, "cuda", sync)
            digests[f] = st.prog
            line["t"][f] = time.perf_counter() - t
            del st
            gc.collect()
            torch.cuda.empty_cache()
        sides = [("ref", "float32", None)]
        if seed in args.control_seeds:
            sides += [("fp8", "fp8", None)] + [(f, "float32", f)
                                               for f in FAULTS]
        for name, prec, fault in sides:
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            digests[name] = harness.reference_digests(
                fam, cfg, mix, seed, batches, "cuda", prec, fault)
            line["t"][name] = time.perf_counter() - t
            line["gb"][name] = _peak_gb()
            gc.collect()
            torch.cuda.empty_cache()
        ref = digests["ref"]
        line["numbers"] = {k: judge.readings(v, ref)
                           for k, v in digests.items() if k != "ref"}
        print(json.dumps({k: line[k] for k in
                          ("workload", "seed", "t", "gb", "numbers")}),
              flush=True)
        if out:
            line["digests"] = digests
            out.write(json.dumps(line) + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
