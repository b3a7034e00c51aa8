"""Trace ``wkv6``, ``wkv6_backward``, ``gram_q8``, ``quantize`` and
``wsum_q8`` on the card: resources, occupancy, scaling.

  python -m repro_torch.kernels.trace_kernels        (from the repo root)

No ``ncu`` on the machine, so these reckonings stand in for it, one JSON
line each:

- ``resources``: each kernel's registers, static shared memory and spills,
  read from the built library by ``cuobjdump -res-usage``, and from them
  and the threads a block the blocks an SM can hold by registers and by
  threads; for the three ``wkv6_backward`` kernels also their dynamic
  shared memory and the blocks an SM the occupancy calculator gives with
  it (``wkv6``'s dynamic shared memory caps it at one block an SM, which
  ``wkv6-scaling`` shows as a step at 132 blocks);
- ``ptxas``: ``quantize_kernel`` and ``wsum_q8_kernel`` (every
  instantiation) as ``nvcc -Xptxas -v`` reports them (registers, shared
  memory, spill stores and loads, stack), with the blocks an SM at the
  256 threads a block that ``stream::grid_for`` gives at large n;
- ``wkv6-scaling``: device time a launch (``torch.profiler``) as the
  (batch, head) blocks grow at a fixed T, and as T grows at the serving
  batch: a kernel that is latency-bound in each block keeps its time while
  blocks fill idle SMs, and takes time in proportion to T;
- ``wkv6_backward-scaling``: time a call (CUDA events) and device time by
  kernel as B x H grows at T 128 (the training shape's T), and as T grows
  at B 8: the pass kernel walks the chunks in series (time in proportion
  to T, flat in B x H while its B x H x 2 blocks fit the card at once, or
  in proportion to the bytes it moves where the memory is the limit), the
  chunk kernel's B x H x T / 32 blocks are all independent (time in
  proportion to the blocks once they fill the card's 132 SMs); B 4, T
  1000 (the long prefill's shape) last. The chunk kernel starts before
  the pass ends (programmatic dependent launch), so with it on its device
  time includes waiting for the pass and the kernels' times overlap; each
  line also gives the call with it off, in turns with on (``_no_pdl``):
  there each kernel's device time is its own;
- ``gram_q8-scaling``: device time a launch at M = 1, 3, 8 and N = 2^28
  and at the main shape (M 3, N 131,072): time that grows with the
  M(M+1)/2 row pairs rather than with the M*N bytes is shared-memory or
  issue bound, not memory bound;
- ``quantize-scaling`` and ``wsum_q8-scaling``: time a call (CUDA events,
  the median of rounds in turns) beside the memory bound as n grows from
  the paper CNN's 62,006 to 2^28 (``wsum_q8`` at M = 1, 2, 3, 4, 8, 9,
  17; ``quantize`` also at ``qwen3-1.7b``'s width), and device time a
  launch: a kernel that holds a steady share of its bound from some n on
  is memory bound there, and below it the launch and the tail of the grid
  take the time. ``quantize`` times both of its bodies (one warp a tile,
  a block of 8 warps a tile) in turns with the ``ops`` call, which
  launches the one its tile count picks; the three give the same bits.

Every kernel is checked against its plain version first. Needs a CUDA card
and ``nvcc``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, ops, q8agg, quant, ref, rwkv6

SMS, SM_REGS, SM_WARPS, SM_BLOCKS = 132, 65_536, 64, 32
LARGE_N = 1 << 28
MAIN_N = 62_006                  # the paper CNN's flat vector
MODEL_N = 1_723_982_848          # qwen3-1.7b's flat vector
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
INT8_SOURCES = ("quant.cu", "q8agg.cu")
THREADS = {"wkv6_kernelILi64E": 256, "wkv6_kernelILi16E": 64,
           "wkv6_bwd_pass_kernelILi64E": 128,
           "wkv6_bwd_pass_kernelILi16E": 32,
           "wkv6_bwd_chunk_kernelILi64E": 256,
           "wkv6_bwd_chunk_kernelILi16E": 64,
           "gram_q8_kernel": 256}   # a block, as the wrappers launch them


def resources(lib: Path) -> dict:
    """kernel (mangled name) -> registers, static shared bytes, local
    (spill) bytes, from ``cuobjdump -res-usage``."""
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-res-usage", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    res, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+).*SHARED:(\d+).*LOCAL:(\d+)", line)
        if m and name:
            res[name] = {"regs": int(m.group(1)), "shared": int(m.group(2)),
                         "local": int(m.group(3))}
            name = None
    return res


def occupancy(regs: int, threads: int) -> dict:
    """Blocks an SM can hold by registers (256 a warp granule), by threads
    and by the block cap, and the warps that gives."""
    warps = -(-threads // 32)
    warp_regs = -(-max(regs, 1) * 32 // 256) * 256
    by = {"regs": SM_REGS // warp_regs // warps,
          "threads": SM_WARPS // warps, "cap": SM_BLOCKS}
    per_sm = min(by.values())
    return {"threads": threads, "blocks_per_sm_max": per_sm,
            "limited_by": min(by, key=by.get),
            "warps_per_sm_max": per_sm * warps}


def device_us(call, calls: int = 20) -> dict:
    """Device time a launch by kernel name (profiler; {} if it saw none)."""
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


def wkv6_inputs(B, T, H, hs, gen):
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")
    r, k, v = (n(B, T, H, hs).to(torch.bfloat16) for _ in range(3))
    base = torch.rand((H, hs), generator=gen, device="cuda") * -6.0 - 1.0
    w = torch.exp(-torch.exp(base + 0.5 * n(B, T, H, hs)))
    u = torch.rand((H, hs), generator=gen, device="cuda") * 0.5
    return r, k, v, w, u, n(B, H, hs, hs)


def backward_shared_memory() -> dict:
    """mangled-name key -> the dynamic shared memory of the backward's pass
    and chunk kernels and the blocks an SM the occupancy calculator gives
    (``repro_wkv6_backward_occupancy``)."""
    import ctypes
    fn = _build.library().repro_wkv6_backward_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for hs in rwkv6.HEAD_SIZES:
        for bf16, ty in ((0, "fEE"), (1, "13__nv_bfloat16EE")):
            got = (ctypes.c_int * 4)()
            if fn(hs, bf16, got) != 0:
                raise SystemExit(f"trace_kernels: occupancy query failed "
                                 f"at hs {hs}")
            for kind, (nbytes, blocks) in (("pass", got[0:2]),
                                           ("chunk", got[2:4])):
                out[f"wkv6_bwd_{kind}_kernelILi{hs}E{ty}"] = {
                    "dynamic_shared": nbytes,
                    "blocks_per_sm_with_shared": blocks}
    return out


def event_us(call, calls: int = 20) -> float:
    """Time a call by CUDA events over ``calls`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def backward_scaling(gen, dev) -> None:
    """``wkv6_backward-scaling`` lines: time a call (CUDA events, the
    median of 3 rounds, programmatic dependent launch on and off in turns)
    and device time by kernel (on and off) at H 32, hs 64, bf16, a final
    state's gradient given, as B grows at T 128 and as T grows at B 8;
    each checked against the plain reverse scan first (dw, which every
    term of the chunked form reaches, within 1e-4 of its max|.|)."""
    for B, T in [(1, 128), (2, 128), (4, 128), (8, 128), (16, 128),
                 (32, 128), (8, 32), (8, 256), (8, 512), (8, 1024),
                 (4, 1000)]:
        r, k, v, w, u, s0 = wkv6_inputs(B, T, 32, 64, gen)
        dy = torch.randn((B, T, 32, 64), generator=gen,
                         device="cuda").to(torch.bfloat16)
        ds = torch.randn((B, 32, 64, 64), generator=gen, device="cuda")
        args = (r, k, v, w, u, s0, dy, ds)
        got = rwkv6.backward(*args)[3]
        if B * T <= 2048:
            want = ref.wkv6_backward_naive(*args)[3]
            err = float((got - want).abs().max()) / float(want.abs().max())
            if not err <= 1e-4:
                raise SystemExit(f"trace_kernels: wkv6_backward B{B} T{T}: "
                                 f"dw off by {err} of max|dw|")
        call = lambda: rwkv6.backward(*args)
        for _ in range(5):
            call()
        ev = {True: [], False: []}
        for _ in range(3):
            for on in (True, False):
                rwkv6.set_backward_pdl(on)
                ev[on].append(event_us(call))
        us = {}
        for on in (True, False):
            rwkv6.set_backward_pdl(on)
            us[on] = device_us(call, 20)
        rwkv6.set_backward_pdl(True)
        nck = -(-T // 32)
        print(json.dumps({"phase": "wkv6_backward-scaling", "B": B, "T": T,
                          "H": 32, "hs": 64, "dtype": "bfloat16",
                          "pass_blocks": B * 32 * 2,
                          "chunk_blocks": B * 32 * nck,
                          "event_us_per_call": sorted(ev[True])[1],
                          "event_us_per_call_no_pdl": sorted(ev[False])[1],
                          "device_us": us[True],
                          "device_us_no_pdl": us[False],
                          "device": dev}), flush=True)
        del r, k, v, w, u, s0, dy, ds, args, got
    torch.cuda.empty_cache()


def ptxas(src: Path, out_dir: Path) -> subprocess.Popen:
    """``nvcc -Xptxas -v`` of the int8 sources in ``src`` into an object
    of their own (its report on the output)."""
    objs = [str(out_dir / f"{Path(n).stem}.o") for n in INT8_SOURCES]
    cmd = " && ".join(
        " ".join([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                  "-o", o, str(src / n)])
        for n, o in zip(INT8_SOURCES, objs))
    return subprocess.Popen(["bash", "-c", cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def parse_ptxas(log: str) -> dict:
    """kernel (mangled name) -> registers, shared bytes, spill stores and
    loads, stack bytes, from a ``-Xptxas -v`` report."""
    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            res[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            res[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            res[name].update(regs=int(m.group(1)),
                             shared=int(sm.group(1)) if sm else 0)
            name = None
    return {k: v for k, v in res.items()
            if "quantize_kernel" in k or "wsum_q8_kernel" in k}


def in_turns(calls: dict, iters: int, rounds: int = 3) -> dict:
    """Median CUDA-event µs a call of each of ``calls``, in turns, after
    five warm-up calls each."""
    for c in calls.values():
        for _ in range(5):
            c()
    us = {k: [] for k in calls}
    for _ in range(rounds):
        for k, c in calls.items():
            us[k].append(event_us(c, iters))
    return {k: sorted(v)[len(v) // 2] for k, v in us.items()}


def int8_scaling(gen, dev) -> None:
    """``quantize-scaling`` and ``wsum_q8-scaling`` lines (see the module
    docstring)."""
    for n in (MAIN_N, 1 << 17, 1 << 20, 1 << 22, 1 << 24, 1 << 26, LARGE_N,
              MODEL_N):
        Np = n + (-n) % ops.QUANT_BLOCK
        x = torch.randn(n, generator=gen, device="cuda")
        got = {w: quant.quantize(x, Np, w) for w in (0, 1, 8)}
        if n <= 1 << 26:
            want = ref.quantize_int8(torch.nn.functional.pad(x, (0, Np - n)))
        else:
            want = got[1]
        for w, out in got.items():
            if not all(torch.equal(a, b) for a, b in zip(out, want)):
                raise SystemExit(f"trace_kernels: quantize n {n}, warps {w} "
                                 "differs from the plain version (above "
                                 "2^26: from the one-warp body)")
        del got, want
        calls = {"warps1": lambda: quant.quantize(x, Np, 1),
                 "warps8": lambda: quant.quantize(x, Np, 8),
                 "ops": lambda: ops.quantize(x)}
        big = n >= 1 << 24
        us = in_turns(calls, 10 if big else 200, 5 if big else 3)
        bound = (4 * n + Np + Np // 1024 * 4) / HBM_BYTES_PER_S * 1e6
        line = {"phase": "quantize-scaling", "n": n, "Np": Np,
                "event_us_per_call": us, "bound_us": bound,
                "share_of_bound": {k: bound / v for k, v in us.items()},
                "device_us": {k: device_us(c, 5 if big else 50)
                              for k, c in calls.items()}}
        print(json.dumps({**line, "device": dev}), flush=True)
        del x, calls
        torch.cuda.empty_cache()
    for M in (1, 2, 3, 4, 8, 9, 17):
        for n in (MAIN_N, 1 << 20, 1 << 24, LARGE_N):
            Np = n + (-n) % ops.QUANT_BLOCK
            q = torch.randint(-127, 128, (M, Np), generator=gen,
                              device="cuda", dtype=torch.int8)
            s = torch.rand((M, Np // 1024), generator=gen,
                           device="cuda") * 1e-3
            w = torch.rand(M, generator=gen, device="cuda")
            got = q8agg.wsum_q8(q, s, w, n)
            if n <= 1 << 20 and not torch.equal(
                    got, ref.wsum_q8(q, s, w)[:n]):
                raise SystemExit(f"trace_kernels: wsum_q8 M {M} n {n} is "
                                 "not the FMA chain")
            call = lambda: ops.weighted_sum_q8(q, s, w, n)
            us = in_turns({"ops": call}, 200 if n < 1 << 24 else 10)["ops"]
            tiles = -(-n // 1024)
            bound = (M * tiles * 1024 + M * tiles * 4 + 4 * n) \
                / HBM_BYTES_PER_S * 1e6
            line = {"phase": "wsum_q8-scaling", "M": M, "n": n, "Np": Np,
                    "event_us_per_call": us, "bound_us": bound,
                    "share_of_bound": bound / us}
            if n == MAIN_N and M in (2, 3):
                line["device_us"] = device_us(call, 50)
            print(json.dumps({**line, "device": dev}), flush=True)
            del q, s, w, got
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    if argv:
        print(f"trace_kernels: takes no arguments, got {argv}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("trace_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.cuda.get_device_name(0)

    out_dir = _build.BUILD_DIR / "trace_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    proc = ptxas(_build.CSRC, out_dir)
    log = proc.communicate()[0]
    if proc.returncode:
        raise SystemExit(f"trace_kernels: nvcc failed:\n{log}")
    for mangled, r in sorted(parse_ptxas(log).items()):
        print(json.dumps({"phase": "ptxas", "kernel": mangled, **r,
                          **occupancy(r.get("regs", 0), 256),
                          "device": dev}), flush=True)
    int8_scaling(gen, dev)

    dyn = backward_shared_memory()
    for mangled, r in sorted(resources(_build.build()).items()):
        threads = next((t for k, t in THREADS.items() if k in mangled), None)
        if threads is not None:
            print(json.dumps({"phase": "resources", "kernel": mangled, **r,
                              **occupancy(r["regs"], threads),
                              **next((v for k, v in dyn.items()
                                      if k in mangled), {}),
                              "device": dev}), flush=True)

    # latency against parallelism: T fixed, (batch, head) blocks grow
    for B, T in [(1, 1024), (4, 1024), (8, 1024), (16, 1024), (32, 1024),
                 (4, 64), (4, 256), (4, 1000), (4, 4096), (8, 4096)]:
        a = wkv6_inputs(B, T, 32, 64, gen)
        y, s = rwkv6.wkv6(*a)
        if B * T <= 4 * 1024:
            y0, s0 = ref.wkv6_naive(*a)
            err = float((s - s0).abs().max()) / float(s0.abs().max())
            if not err <= 1e-5:
                raise SystemExit(f"trace_kernels: wkv6 B{B} T{T}: state off "
                                 f"by {err} of max|S|")
        us = device_us(lambda: rwkv6.wkv6(*a), 20 if B * T < 8192 else 5)
        print(json.dumps({"phase": "wkv6-scaling", "B": B, "T": T, "H": 32,
                          "hs": 64, "blocks": B * 32, "device_us": us,
                          "us_per_token": sum(us.values()) / T,
                          "device": dev}), flush=True)
        del a, y, s
    torch.cuda.empty_cache()
    backward_scaling(gen, dev)

    for M, N in [(3, 131_072), (1, LARGE_N), (3, LARGE_N), (8, LARGE_N)]:
        q = torch.randint(-127, 128, (M, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((M, N // 1024), generator=gen, device="cuda") * 1e-3
        g, sq = q8agg.gram_q8(q, s)
        if N < LARGE_N:
            g64 = (lambda x: x @ x.T)(ref.dequantize_rows(q, s.double()))
            tol = 2.0 ** -20 * float(g64.diagonal().max())
            if float((g.double() - g64).abs().max()) > tol:
                raise SystemExit(f"trace_kernels: gram_q8 M{M} N{N} off")
        us = device_us(lambda: q8agg.gram_q8(q, s), 20 if N < LARGE_N else 5)
        nbytes = M * N + 4 * M * N // 1024
        print(json.dumps({"phase": "gram_q8-scaling", "M": M, "N": N,
                          "pairs": M * (M + 1) // 2, "device_us": us,
                          "bound_us": nbytes / 3.35e12 * 1e6,
                          "device": dev}), flush=True)
        del q, s, g, sq
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
