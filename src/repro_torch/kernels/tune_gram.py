"""Time variants of the ``gram_and_norms`` kernel on the card.

  python -m repro_torch.kernels.tune_gram          (from the repo root)

Each variant is ``csrc/multikrum.cu`` with one change patched into its text
(a ring depth, a unit width, blocks an SM, or a cut that stops the kernel
early, which gives wrong sums and only measures what the stopped part cost),
built by ``nvcc`` into a library of its own, all in parallel. Every variant
runs on the same inputs: M 3, N 62,006 (the paper CNN's MultiKRUM stack),
device time a call from ``torch.profiler``; M 8, N 2^28, CUDA-event time
beside the memory bound. Prints one JSON line a variant and run, after the
card's name and power limit. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet

# variant -> [(text in multikrum.cu, its replacement)]
TICKET = ("  // the ticket: after the barrier one acquire-release atomic "
          "releases")
VARIANTS = {
    "as_built": [],
    "ring_3": [("kStages = 4;", "kStages = 3;")],
    "ring_6": [("kStages = 4;", "kStages = 6;")],
    "unit_256": [("M <= 8 ? 9 :", "M <= 8 ? 8 :")],
    "one_block_an_sm": [("(M <= 16 ? 2 : 1)", "(M <= 16 ? 1 : 1)")],
    # cuts: each returns early (its sums are wrong): what it skips is the
    # difference to as_built; cut_before_ticket stores the partials first
    "cut_at_start": [("  const int tid = threadIdx.x;", "  if (ld >= 0) "
                      "return;\n  const int tid = threadIdx.x;")],
    "cut_before_ticket": [(TICKET, "  return;\n" + TICKET)],
    "cut_before_last_block": [("if (!last) return;", "return;")],
}


def build(name: str, edits, out_dir: Path) -> subprocess.Popen:
    text = (_build.CSRC / "multikrum.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"tune_gram: variant {name}: {old!r} not found "
                             "once in multikrum.cu")
        text = text.replace(old, new)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(_build.CSRC), "-o", str(out_dir / f"{name}.so"), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def caller(lib, x, part, ticket):
    fn = lib.repro_gram_and_norms
    fn.argtypes = _build.KERNELS["gram_and_norms"].argtypes
    M, N = x.shape
    out = torch.empty(M * M + M, device=x.device)

    def call():
        err = fn(x.data_ptr(), x.stride(0), M, N, part.data_ptr(),
                 part.numel(), ticket.data_ptr(), out.data_ptr(),
                 _build.stream_of(x))
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def device_us(call, calls: int = 200):
    """Device time a launch (the profiler now and then drops events; None
    when it saw none)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in kern)
    return (sum(e.self_device_time_total for e in kern) / launches
            if launches else None)


def event_ms(call, iters: int = 10) -> float:
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_gram: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import multikrum  # registers the argtypes
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "tune_gram"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {n: build(n, e, out_dir) for n, e in VARIANTS.items()}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"tune_gram: {n} failed to build:\n{log}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    small = torch.randn((3, 62_006), generator=gen, device="cuda")
    large = torch.randn((8, 1 << 28), generator=gen, device="cuda")
    bound_ms = 4 * large.numel() / HBM_BYTES_PER_S * 1e3
    part = torch.empty(multikrum.PART_BLOCKS * 36, device="cuda")
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    for run in range(2):
        for name in VARIANTS:
            lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
            us = device_us(caller(lib, small, part, ticket))
            ticket.zero_()    # a cut variant leaves it counted up
            ms = event_ms(caller(lib, large, part, ticket))
            ticket.zero_()
            print(json.dumps({"variant": name, "run": run,
                              "main_device_us": us, "large_ms": ms,
                              "large_bound_ms": bound_ms,
                              "large_share_of_bound": bound_ms / ms,
                              "device": torch.cuda.get_device_name(0)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
