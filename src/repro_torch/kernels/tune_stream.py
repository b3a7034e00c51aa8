"""Time the streaming int8 kernels against an earlier version's, on the card.

  python -m repro_torch.kernels.tune_stream [--parent DIR]   (repo root)

Builds ``csrc/quant.cu`` and ``csrc/q8agg.cu`` (``dequantize`` and
``add_q8_delta``, with ``csrc/stream.cuh``) into a library of their own,
and with ``--parent DIR`` also ``DIR/quant.cu`` and ``DIR/q8agg.cu`` (with
``DIR/gram.cuh``) of an earlier version, whose kernels write whole
1024-tiles: that one gets the operands its ``ops`` handed it (every column
of the payload, a base padded to the payload's length). Both build in
parallel, run in one process on the same inputs, and are checked bit for
bit against the plain version first:

- N = 2^28: ``dequantize`` K = 1 and K = 8, ``add_q8_delta``; CUDA-event
  time (after 50 ms of warm-up calls) beside the memory bound;
- the paper CNN's n = 62,006 from 131,072 payloads: device time a launch
  (``torch.profiler``) of ``dequantize`` K = 1, of ``dequantize`` K = 2
  and of the ``gram_and_norms`` that reads its output next (the scoring
  path), and of ``add_q8_delta``.

Prints one JSON line a version and run, after the card's name and power
limit. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build, multikrum, ref
from repro_torch.kernels import q8agg, quant  # noqa: F401 (argtypes)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
MAIN_N, NP, LARGE_N = 62_006, 131_072, 1 << 28


def build(name: str, out_dir: Path, src: Path) -> subprocess.Popen:
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
           str(out_dir / f"{name}.so"), str(src / "quant.cu"),
           str(src / "q8agg.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def bind(lib, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes

    def call(*args):
        err = fn(*args)
        if err:
            raise RuntimeError(f"{symbol}: CUDA error {err}")
    return call


def dequantizer(lib, q, s, n):
    """This version's dequantize of q [K, Np] into a fresh [K, n] view with
    16-byte rows (as ``quant.dequantize`` lays it out)."""
    fn = bind(lib, "repro_dequantize", _build.KERNELS["dequantize"].argtypes)
    K = q.shape[0]
    ldo = (n + 3) // 4 * 4
    out = torch.empty_strided((K, n), (ldo, 1), device=q.device)

    def call():
        fn(q.data_ptr(), q.stride(0), s.data_ptr(), s.stride(0),
           out.data_ptr(), ldo, K, n, 0, _build.stream_of(q))
        return out
    return call


def adder(lib, base, q, s, n):
    fn = bind(lib, "repro_add_q8_delta",
              _build.KERNELS["add_q8_delta"].argtypes)
    out = torch.empty(n, device=q.device)

    def call():
        fn(base.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), n,
           _build.stream_of(q))
        return out
    return call


def parent_dequantizer(lib, q, s, n):
    """The earlier kernel: every column of contiguous q [K, Np], then the
    [K, n] view its ``ops`` returned."""
    fn = bind(lib, "repro_dequantize", [ctypes.c_void_p] * 3 +
              [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty(q.shape, device=q.device)

    def call():
        fn(q.data_ptr(), s.data_ptr(), out.data_ptr(), q.numel(), 0,
           _build.stream_of(q))
        return out[:, :n]
    return call


def parent_adder(lib, base, q, s, n):
    """The earlier kernel on the base padded to the payload's length (the
    padding itself, host-side in its ``ops``, is not timed)."""
    fn = bind(lib, "repro_add_q8_delta",
              _build.KERNELS["add_q8_delta"].argtypes)
    padded = torch.zeros(q.shape, device=q.device)
    padded[:n] = base[:n]
    out = torch.empty(q.shape, device=q.device)

    def call():
        fn(padded.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
           q.shape[0], _build.stream_of(q))
        return out[:n]
    return call


def device_us(call, calls: int = 200) -> dict:
    """Device time a launch by kernel name (the profiler now and then drops
    events; an empty dict when it saw none)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("::")[-1].split("(")[0]:
            e.self_device_time_total / e.count
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count}


def event_ms(call, iters: int = 10) -> float:
    t0, k = time.perf_counter(), 0
    while k < 2 or time.perf_counter() - t0 < 0.05:   # as chip_smoke.py
        call()
        torch.cuda.synchronize()
        k += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels."
                                 "tune_stream")
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc directory of an earlier version to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_stream: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "tune_stream"
    out_dir.mkdir(parents=True, exist_ok=True)
    versions = {"current": _build.CSRC}
    if args.parent is not None:
        versions["parent"] = args.parent.resolve()
    procs = {n: build(n, out_dir, src) for n, src in versions.items()}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"tune_stream: {n} failed to build:\n{log}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rint = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                    device="cuda", dtype=torch.int8)
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")
    qm, sm = rint(2, NP), rand(2, NP // 1024) * 0.02
    bm = rand(MAIN_N) - 0.5
    ql, sl = rint(8, LARGE_N), rand(8, LARGE_N // 1024) * 0.02
    bl = rand(LARGE_N) - 0.5
    dq_bytes = lambda K, n: K * n * 5 + K * -(-n // 1024) * 4
    bounds = {"dequantize_k1_ms": dq_bytes(1, LARGE_N),
              "dequantize_k8_ms": dq_bytes(8, LARGE_N),
              "add_q8_delta_ms": 9 * LARGE_N + LARGE_N // 1024 * 4}
    bounds = {k: b / HBM_BYTES_PER_S * 1e3 for k, b in bounds.items()}
    want_dq = ref.dequantize_rows(qm, sm)[:, :MAIN_N]
    want_add = ref.add_q8_delta(bm, qm[0, :MAIN_N], sm[0])
    for run in range(2):
        for name in versions:
            lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
            dq, add = ((parent_dequantizer, parent_adder) if name == "parent"
                       else (dequantizer, adder))
            main_dq = dq(lib, qm, sm, MAIN_N)
            main_add = add(lib, bm, qm[0], sm[0], MAIN_N)
            if not (torch.equal(main_dq(), want_dq)
                    and torch.equal(main_add(), want_add)):
                raise SystemExit(f"tune_stream: {name} differs from the "
                                 "plain version")
            scoring = device_us(lambda: multikrum.gram_and_norms(main_dq()))
            line = {"version": name, "run": run,
                    "main_dequantize_k1_device_us": device_us(
                        dq(lib, qm[:1], sm[:1], MAIN_N)).get(
                            "dequantize_kernel"),
                    "main_dequantize_k2_device_us":
                        scoring.get("dequantize_kernel"),
                    "main_next_gram_and_norms_device_us":
                        scoring.get("gram_and_norms_kernel"),
                    "main_add_q8_delta_device_us":
                        device_us(main_add).get("add_q8_delta_kernel")}
            del main_dq, main_add
            line["dequantize_k1_ms"] = event_ms(dq(lib, ql[:1], sl[:1],
                                                   LARGE_N))
            torch.cuda.empty_cache()
            line["dequantize_k8_ms"] = event_ms(dq(lib, ql, sl, LARGE_N), 5)
            torch.cuda.empty_cache()
            line["add_q8_delta_ms"] = event_ms(add(lib, bl, ql[0], sl[0],
                                                   LARGE_N))
            torch.cuda.empty_cache()
            for k, b in bounds.items():
                line[k.replace("_ms", "_share_of_bound")] = b / line[k]
            line["bound_ms"] = bounds
            line["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
