"""One run of one cell: set-up, the measured window, the traced steps, and
the check of what the timed path produced against the plain reference.

Everything that belongs to one configuration, mix, metric or family sits
in a file of its own, found by name: ``BENCHMARK.json`` names the cell's
configuration file and mix; ``bench/traffic/<mix>.json``;
``bench/reference/<family>.py``; ``bench/metrics/<metric>.py`` (a
``read(ctx)`` returning the metric or None, and optionally ``CALLS``, the
program's module attributes whose calls it needs logged);
``bench/limits/<workload>.json``.

The run (``run``):

1. set-up (``setup``): the port's model and round step; the weights from
   the seed (every pod alike); the first ``checked_steps`` round steps
   through the round step's own call and feed, each read
   (``judge.step_digest``); they warm up every shape the window runs;
   then one step more through the window's own call, untimed, so that
   the device's memory pool holds what the window's steps take;
2. the window: round steps back to back for ``seconds``, each step ending
   in a synchronize, the stack handed from step to step;
3. with ``trace``: the window with spans around the train steps and the
   exchange, then ``profiled_steps`` steps under the profiler, which
   records the device's activity alone, and one step more with the
   host's operations recorded, which names the idle gaps; the per-layer
   metrics;
4. the device's peak read, the program's state freed, the reference
   follows the checked steps from the same weights and batches, and the
   two are compared (``judge``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from bench import judge, program, traffic, weights
from bench.peaks import of as peaks_of
from bench.reference.numerics import Numerics, no_tf32
from bench.reference.round import round_step as ref_round_step
from bench.trace import Trace, profiled

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(workload: str, bench: dict = None):
    """(the workload's entry, its configuration, its mix)."""
    bench = bench or spec()
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / c["file"]).read_text())
    return w, cfg, traffic.load(w["traffic"])


def family(name: str):
    """The plain reference of a model family, ``bench/reference/<name>.py``."""
    return _load(HERE / "reference" / f"{name}.py",
                 f"bench.reference.{name}")


def reader(metric: str):
    """A per-layer metric's reader, ``bench/metrics/<metric>.py``."""
    return _load(HERE / "metrics" / f"{metric}.py", f"bench.metrics.{metric}")


def per_layer(workload: str, bench: dict = None) -> list:
    """The per-layer metrics a traced run of ``workload`` reports."""
    bench = bench or spec()
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])]


def end_to_end(workload: str, bench: dict = None) -> list:
    bench = bench or spec()
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def flops_a_step(cfg: dict, mix: dict, fam) -> float:
    """Model FLOPs of one round step: 3 forwards a trained token, one a
    scored token; recomputation not counted."""
    f = fam.forward_flops(cfg, mix["seq_len"])
    return f * (3 * traffic.tokens_a_step(mix) + traffic.scored_a_step(mix))


def pods_of(tree, n: int) -> list:
    """A stacked tree -> one {path: tensor} a pod (views)."""
    flat = weights.flatten(tree)
    return [{p: x[i] for p, x in flat.items()} for i in range(n)]


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def setup(cfg: dict, mix: dict, seed: int, device: str, sync,
          spans=None) -> SimpleNamespace:
    """Set-up of a run: the port's model and round step (``spans``
    installed first, where given), the weights from the seed, every pod
    alike, and the first ``checked_steps`` round steps through the round
    step's own call and feed, each read (``judge.step_digest``); they warm
    up every shape the window runs. Returns the round step, the stack the
    window starts from, the feed, the readings (``prog``) and the checked
    steps' batches."""
    P = mix["pods"]
    program.path()
    from repro_torch.core.builder import resolve_device
    resolve_device(device)
    if spans:
        spans.install()
    step = program.round_step(cfg, mix)
    specs = family(cfg["family"]).param_specs(cfg)
    stack = weights.nest(weights.stack(weights.make(specs, seed, device), P))
    feed = traffic.Feed(mix, cfg["vocab_size"], seed, device)
    digests, batches = [], []
    for _ in range(mix["checked_steps"]):
        batch = feed.next()
        batches.append({k: v.clone() for k, v in batch.items()})
        info = {}
        out, losses = step(stack, batch, info)
        sync()
        gathered = info.get("gathered")
        digests.append(judge.step_digest(
            pods_of(stack, P), pods_of(info["trained"], P),
            None if gathered is None else pods_of(gathered, P),
            losses.tolist(), info.get("scores"), info.get("weights")))
        del info, gathered
        stack = out
    del out
    p0 = weights.make(specs, seed, device)
    prog = {"steps": digests,
            "change": judge.norms(pods_of(stack, P), [p0] * P)}
    del p0
    gc.collect()
    sync()
    return SimpleNamespace(step=step, stack=stack, feed=feed, prog=prog,
                           batches=batches)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: float = None, cfg: dict = None,
        mix: dict = None, lims: dict = None) -> dict:
    """One run; returns the result line's object. ``cfg``, ``mix`` and
    ``lims`` replace the cell's own (the CPU tests run small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec()
    _, cfg0, mix0 = cell(workload, bench)
    cfg, mix = cfg or cfg0, mix or mix0
    lims = judge.limits(workload) if lims is None else lims
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fam = family(cfg["family"])
    spans = program.Spans(sync) if trace else None
    readers = [(m, reader(m["name"])) for m in per_layer(workload, bench)] \
        if trace else []
    st = setup(cfg, mix, seed, device, sync, spans)
    calls = program.CallLog(sorted({c for _, r in readers
                                    for c in getattr(r, "CALLS", ())}))
    step, stack, feed = st.step, st.stack, st.feed
    del st.stack
    stack, _ = step(stack, feed.next())
    sync()

    # the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if spans:
        spans.reset()
    losses_w, n, ends = [], 0, [t0]
    while True:
        stack, losses = step(stack, feed.next())
        losses_w.append(losses)
        sync()
        n += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    t_end = ends[-1]
    elapsed = t_end - t0
    took = sorted(b - a for a, b in zip(ends, ends[1:]))
    print(f"window: {n} steps, first {1e3 * (ends[1] - t0):.1f} ms, "
          f"fastest {1e3 * took[0]:.1f}, median {1e3 * took[n // 2]:.1f}, "
          f"slowest {1e3 * took[-1]:.1f}", file=sys.stderr)
    failed = int((~torch.isfinite(torch.stack(losses_w))).any(dim=1).sum())
    flops = flops_a_step(cfg, mix, fam)
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    peaks = peaks_of(name) if cuda else None

    metrics, device_extra, breakdown = {}, {}, None
    if not trace:
        values = {"setup_s": setup_s,
                  "train_tokens_per_s":
                      n * traffic.tokens_a_step(mix) / elapsed}
        if cuda:
            values["mfu"] = 100.0 * n * flops / elapsed / peaks["bf16_flops"]
            values["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    else:
        spans.active = False
        calls.on = True
        with (profiled() if cuda else contextlib.nullcontext()) as prof:
            sync()
            tp = time.perf_counter()
            for _ in range(mix["profiled_steps"]):
                stack, _ = step(stack, feed.next())
            sync()
            wall = time.perf_counter() - tp
        calls.on = False
        t_read = time.perf_counter()
        tr = Trace.from_profile(prof, mix["profiled_steps"], wall) if cuda \
            else Trace(mix["profiled_steps"], wall)
        del prof
        gaps = []
        if cuda:
            with profiled(host=True) as prof:
                stack, _ = step(stack, feed.next())
            gaps = Trace.from_profile(prof, 1, 0.0).idle_gaps()
            del prof
        k = mix["profiled_steps"]
        print(f"profiled steps: {1e3 * wall / k:.1f} ms a step, "
              f"{1e3 * tr.busy_s() / k:.1f} ms of it busy (the window's: "
              f"{1e3 * elapsed / n:.1f} ms); traces read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        ctx = SimpleNamespace(cfg=cfg, mix=mix, spans=spans.times,
                              window_steps=n, window_s=elapsed, trace=tr,
                              calls=calls.calls, peaks=peaks,
                              flops_a_step=flops)
        values = {m["name"]: r.read(ctx) for m, r in readers}
        if cuda:
            device_extra = {"busy_s": tr.busy_s(), "window_s": wall}
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": gaps}
    for m in (per_layer if trace else end_to_end)(workload, bench):
        if values.get(m["name"]) is not None:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    calls.remove()
    if spans:
        spans.remove()
    del stack, step, losses_w, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference follows the checked steps
    t_ref = time.perf_counter()
    ref = reference_digests(fam, cfg, mix, seed, st.batches, device)
    checks = judge.compare(judge.readings(st.prog, ref), lims)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)

    result = {"correct": failed == 0 and all(c["ok"]
                                             for c in checks.values()),
              "attempted": n, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": name,
                         "count": 1, "memory_peak_bytes": peak_bytes,
                         **device_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                            else str(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def reference_digests(fam, cfg: dict, mix: dict, seed: int, batches: list,
                      device, precision: str = "float32",
                      fault: str = None) -> dict:
    """The reference's readings of the checked steps, from the weights of
    ``seed`` and the steps' batches; in another ``precision``, or with a
    ``fault`` planted, the control's."""
    if device == "cuda":
        no_tf32()
    num = Numerics(precision)
    p0 = weights.make(fam.param_specs(cfg), seed, device)
    pods = [p0] * mix["pods"]
    steps = []
    for batch in batches:
        new, rec = ref_round_step(pods, batch, fam, cfg, mix, cfg["lr"], num,
                                  fault)
        steps.append(judge.step_digest(pods, rec["trained"], rec["gathered"],
                                       rec["losses"], rec["scores"],
                                       rec["weights"]))
        del rec
        pods = new
    return {"steps": steps, "change": judge.norms(pods, [p0] * mix["pods"])}
