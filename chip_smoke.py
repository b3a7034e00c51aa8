"""Drive the PyTorch/CUDA port on one GPU and hold every kernel against its
plain PyTorch version.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

  1. resolve the card and print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. check each kernel against its plain version on the card, at the main
     path's shapes (paper CNN: N = 62,006, M or K = 2, M = 3 for the
     MultiKRUM Gram; the int8 kernels off payloads padded to 131,072;
     ``wkv6``: the two serving prefills, B 4, T 64 and T 1000, H 32, hs 64,
     also against its sub-chunked arithmetic in PyTorch) and at a large
     shape (N = 2^28; M = 4 for f32 sums, 8 for int8 and the Gram, so M*N
     >= 2^31; ``wkv6``: B 8, T 4096), and time both (CUDA events: kernel,
     plain version and library call in turns, 5 rounds of back-to-back
     calls, each after 50 ms of warm-up calls; the medians) beside
     the least time the card could take (for ``wkv6`` also at the rates
     of the units its chunked form runs on, ``bound_tc_ms``) and, where
     one PyTorch call computes the same function, that call; ``weighted_sum`` and
     ``gram_and_norms`` also at the padded widths of earlier rows (65,536
     and 63,488) and the Gram on the strided [:, :62,006] view of a
     [3, 131,072] buffer; ``dequantize`` (K = 1 and 2) and ``add_q8_delta``
     through ``ops`` at the n = 62,006 columns the main path keeps (the
     kernels line's rows) and at the whole payload (the padded rows of
     earlier PRs), each failing on a second kernel launch a call;
     ``quantize`` and ``wsum_q8`` likewise through ``ops`` at n = 62,006
     (``ops.quantize`` pads with ``F.pad`` first); then, all
     timings done, each main-shape row's device time a launch from
     ``torch.profiler`` (which leaves a cost on every later launch: the
     ``launch-rate`` line times the int8 ops calls before the first
     profiler session and after the last); before it all, the host-path
     line (host microseconds a call, the kernel bindings compared), and
     after it an int8-delta ``reconstruct`` at the main shape;
  4. run the main paths on the card, each with the launch counts set to 0
     just before it: a 2-round Sync UnifyFL experiment of the paper CNN
     with int8 compression and accuracy scoring, a 1-round uncompressed
     one, and a 3-round one with int8-delta compression and MultiKRUM
     scoring; check the ledger, that every param lives on the card, that
     every kernel of each path launched, and that the int8 and the
     int8-delta runs agree with the same runs on the CPU (the plain
     versions); then profile one more int8 round and two more int8-delta
     MultiKRUM rounds (device busy share, top kernels by device time; each
     Gram call one launch of its kernel);
  5. the Async engine and the WAN fabric, each run with the launch counts
     set to 0 just before it: ``async-int8-delta-wan``, 3 Async rounds of
     int8-delta over ``wan-heterogeneous`` (gossip, prefetch) with a
     straggler and silo1 killed in round 2 and restarted from its WAL in
     round 3, every silo at time_scale 0 (its wall time, heights, round
     marks with WAN and chain bytes, recovery counters, convergence, the
     decoded models on the card; ``quantize``, ``dequantize``,
     ``add_q8_delta``, ``wsum_q8`` and ``weighted_sum`` launched), the same
     run on the CPU (rounds and recovery equal; picks, heights and bytes
     printed beside it: CIDs reach the chain's hash tie-breaks), the same
     Async run without the fabric on both (picks, height and submission
     times equal, accuracy within ACC_TOL), a profiled Async WAN run;
     ``sync-multikrum-wan`` (4 silos over ``lan``, a partition in round 2
     healed in round 3: the Gram kernels behind fabric fetches, one state
     after the heal); ``sync-vs-async-straggler`` (the reference's
     straggler test on the card, in simulated seconds);
  6. serve RWKV-6 1.6B (``configs/rwkv6_1_6b.py``: 24 layers, d_model
     2048, 32 heads of 64, vocab 65,536, bf16) at its full width on the
     card through ``repro_torch.launch.serve.serve``, twice (4 x 64 prompt
     + 32 tokens, the reference CLI's defaults; 4 x 1000 + 8), each with the
     launch counts set to 0 just before it: exactly 24 ``wkv6`` launches a
     prefill and none from decode steps, every logit finite, the prefill
     times beside the token-serial kernel's (``PREFILL_EARLIER_MS``);
     profile one
     more request; run the CLI entry point once (``main``, 4 x 64 + 4); hold
     the same width at depth 2 against the port on the CPU (prefill logits
     and state, 8 teacher-forced decode steps); then likewise ``qwen3-1.7b``
     (the dense decoder family) and the last three LM families,
     ``olmoe-1b-7b`` (MoE), ``recurrentgemma-9b`` (RG-LRU hybrid, also 2 x
     2200 + 8 across its 2,048-key window) and ``seamless-m4t-medium``
     (encoder-decoder, stub frames), one after the other with the params
     freed between: parameter counts held to FAMILY_PARAMS, every logit
     finite, none of the nine kernels launched, two MoE prefills
     bit-identical, the CLI once, and a float32 CPU check at reduced depth
     (FAMILY_CHECK_DEPTH; the MoE's routing compared exactly first);
  7. print the ``kernels`` JSON line (all nine TPU kernels' counterparts,
     with their launches on the main path and on the Async WAN and
     MultiKRUM WAN paths), then the result line.

The card's peak rates are the published H100 SXM figures; a card capped
below 700 W runs slower, which is why its power limit is printed beside the
numbers.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM TF32 tensor-core rate, dense
INT8_OPS = 1979e12             # H100 SXM int8 tensor-core rate, dense
GRAM_ULPS = 1.0                # Gram tolerance, sqrt(N) ulps (check_gram)
WKV_REL = 1e-5                 # wkv6 tolerance, of max|y| and max|S|
BF16_ULP = 2.0 ** -7           # one bf16 ulp, relative
SERVE_ARCH = "rwkv6-1.6b"
DECODER_REL = 1e-4             # float32 card vs CPU, of max|output| (below)
# the attention LM families served at full width after RWKV-6: the dense
# decoder (qwen3-1.7b, the CLI default), the MoE, the RG-LRU hybrid and the
# encoder-decoder. Their params and bytes (bf16, vocab padded to a multiple
# of 2,048), as jax.eval_shape of the reference's init counts them; the
# requests each serves (batch, prompt, gen: the last of recurrentgemma-9b
# crosses its 2,048-key window); the depth of its float32 card-vs-CPU
# check (recurrentgemma-9b: one group and a tail of two)
FAMILY_PARAMS = {"qwen3-1.7b": (1_723_982_848, 3_447_965_696),
                 "olmoe-1b-7b": (6_922_770_432, 13_849_735_168),
                 "recurrentgemma-9b": (9_396_301_824, 18_792_816_640),
                 "seamless-m4t-medium": (616_626_176, 1_233_252_352)}
FAMILY_REQUESTS = {"qwen3-1.7b": [(4, 64, 32), (4, 1100, 8)],
                   "olmoe-1b-7b": [(4, 64, 32), (4, 1100, 8)],
                   "recurrentgemma-9b": [(4, 64, 32), (4, 1100, 8),
                                         (2, 2200, 8)],
                   "seamless-m4t-medium": [(4, 64, 32), (4, 1100, 8)]}
FAMILY_CHECK_DEPTH = {"qwen3-1.7b": dict(n_layers=2),
                      "olmoe-1b-7b": dict(n_layers=2),
                      "recurrentgemma-9b": dict(n_layers=5),
                      "seamless-m4t-medium": dict(n_layers=2,
                                                  n_enc_layers=2)}
MAIN_N = 62_006                # paper-cnn params (configs/paper_cnn.py)
LARGE_N = 1 << 28
WSUM_PAD, GRAM_PAD = 4096, 2048   # the padded widths of the earlier rows
EDGE_M = 100                   # fedavg_up of 200 edge clients at 0.5
ACC_TOL = 0.05                 # global accuracy, card vs CPU (see phase 4)
WARM_S = 0.05                  # warm-up before each CUDA-event block
# prefill of the two serving requests with the token-serial wkv6 kernel
PREFILL_EARLIER_MS = {"4x64": 56.0, "4x1000": 83.4}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fns: dict, iters: int, reps: int = 5) -> dict:
    """Time on the card of each function of ``fns``: ``reps`` rounds in
    which each function in turn runs WARM_S seconds of warm-up calls (at
    least 3), then ``iters`` back-to-back calls between two CUDA events;
    the median of each function's rounds. In turns, the drift of a
    host-bound call's time over a run (up to a third) reaches every
    function alike; the warm-up before each block absorbs what a switch
    costs (a streaming kernel at N = 2^28 runs up to 15 % slow for its
    first ~10 ms of calls after other work or on fresh allocations)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            t0, k = time.perf_counter(), 0
            while k < 3 or time.perf_counter() - t0 < WARM_S:
                fn()
                torch.cuda.synchronize()
                k += 1
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return {name: sorted(ts)[len(ts) // 2] for name, ts in times.items()}


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    return timed({"fn": fn}, iters, reps)["fn"]


def device_time(fn, calls: int = 50) -> dict:
    """Device time a launch and the kernels ``fn`` launches, from
    ``torch.profiler`` over ``calls`` warm calls (CUDA events at these sizes
    time the host's launch rate instead). Per launch, not per call: the
    profiler now and then drops a share of the events, or all of them (then
    it tries again, twice)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = sum(e.count for e in kern)
        if launches:
            break
    else:
        fail("the profiler saw no kernel in three tries")
    short = lambda e: e.key.split("<")[0].split("::")[-1].split("(")[0]
    by_kernel = {}
    for e in kern:
        k = by_kernel.setdefault(short(e), [0, 0.0])
        k[0] += e.count
        k[1] += e.self_device_time_total
    return {"device_us_per_launch": sum(e.self_device_time_total
                                        for e in kern) / launches,
            "launches_seen_per_call": launches / calls,
            "device_kernels": sorted(short(e) for e in kern),
            "by_kernel": {k: {"launches_per_call": c / calls,
                              "us_per_launch": us / c}
                          for k, (c, us) in sorted(by_kernel.items())}}


def bound(nbytes: float, flops: float = 0.0, peak_flops: float = F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# Phase 3: each kernel against its plain version
# --------------------------------------------------------------------------- #

def quant_input(n: int, gen) -> torch.Tensor:
    """Normal values plus an all-zero tile and a tile of exact .5 ties."""
    x = torch.randn((n,), generator=gen, device="cuda")
    x[:1024] = 0.0
    ties = torch.arange(1024, device="cuda", dtype=torch.float32) % 200 - 100.5
    ties[0] = 127.0                        # amax 127 -> scale exactly 1.0
    x[1024:2048] = ties
    return x


def launched_once(name: str, call):
    """``call()``, failing unless it launched kernel ``name`` exactly once
    and no other wrapper's kernel."""
    from repro_torch.kernels import _build
    before = _build.launch_counts()
    out = call()
    after = _build.launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if delta != {name.split("_k1")[0]: 1}:
        fail(f"{name}: one call launched {delta}")
    return out


def one_kernel_a_call(name: str, call, kernel: str) -> dict:
    """Device time a launch of ``call``; fails if the profile shows more
    than one launch a call or a kernel other than ``kernel``."""
    extra = device_time(call)
    if extra["launches_seen_per_call"] > 1 or any(
            not k.startswith(kernel) for k in extra["device_kernels"]):
        fail(f"{name}: {extra}, want one {kernel} a call")
    return extra


def ops_call_profile(name: str, call, kernel: str) -> dict:
    """Device time of an ``ops`` call that may launch PyTorch's own kernels
    beside ours (``ops.quantize`` pads with ``F.pad``): the device time a
    call in all, and ``kernel``'s own a launch; fails unless ``kernel``
    runs exactly once a call."""
    extra = device_time(call)
    own = {k: v for k, v in extra["by_kernel"].items() if k.startswith(kernel)}
    if [v["launches_per_call"] for v in own.values()] != [1.0]:
        fail(f"{name}: {extra}, want one {kernel} a call")
    return {**extra,
            "device_us_per_call": extra["device_us_per_launch"]
            * extra["launches_seen_per_call"],
            "device_us_per_launch": next(iter(own.values()))["us_per_launch"]}


def fedavg_up_row(gen, iters: int, row) -> None:
    """``weighted_sum`` as an edge fleet's ``fedavg_up`` hands it over:
    ``fed.aggregator.fedavg_params`` of EDGE_M client models of the paper
    CNN (a 200-client fleet at participation 0.5) with their sample counts
    as weights. Above ``wsum.MAX_HOST_M`` the host weights are copied to
    the card and the kernel reads them there. Held against the plain
    version and bit for bit against the ordered FMA chain; ``fedavg_params``
    gives the same bits as the wrapper on the stacked rows."""
    from repro_torch.fed.aggregator import _normalized, fedavg_params
    from repro_torch.kernels import ref, wsum
    M, N = EDGE_M, MAIN_N
    x = torch.randn((M, N), generator=gen, device="cuda")
    counts = torch.randint(1, 40, (M,), generator=gen, device="cuda")
    counts = [float(c) for c in counts.cpu()]
    w_host = torch.from_numpy(_normalized(counts))
    w = w_host.cuda()
    params = [{"w": x[i]} for i in range(M)]
    got = wsum.weighted_sum(x, w_host)
    want = ref.weighted_sum(x, w)
    via = fedavg_params(params, counts)["w"]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float((w.abs()[:, None] * x.abs()).sum(0).max())
    if not err <= M * 2.0 ** -23 * scale:
        fail(f"weighted_sum M={M}: max_abs_err {err} (scale {scale})")
    if not (torch.equal(got, ref.weighted_sum_ordered(x, w))
            and torch.equal(via, got)):
        fail(f"weighted_sum M={M}: not the ordered FMA chain, or "
             "fedavg_params gives other bits")
    ts = timed({"kernel": lambda: wsum.weighted_sum(x, w_host),
                "plain": lambda: ref.weighted_sum(x, w),
                "library": lambda: torch.matmul(w, x),
                "fedavg_params": lambda: fedavg_params(params, counts)},
               iters)
    row("weighted_sum", err, ts["kernel"], ts["plain"], (M + 1) * N * 4,
        2.0 * M * N, library_ms=ts["library"],
        check=f"abs err <= M*2^-23*max sum|w x| = "
              f"{M * 2.0 ** -23 * scale:.3e}; bit-exact with the ordered FMA "
              "chain; fedavg_params same bits",
        path=False, M=M, N=N, layout="contiguous",
        weights="host, copied to the card (M > 64)",
        fedavg_params_ms=ts["fedavg_params"],
        later=lambda: ops_call_profile(
            f"weighted_sum M={M}", lambda: wsum.weighted_sum(x, w_host),
            "weighted_sum_kernel"))


def check_kernels(shape: str, gen, iters: int):
    from repro_torch.kernels import multikrum, ops, q8agg, quant, ref, wsum
    large = shape == "large"
    rows = []

    def row(name, max_err, ms, plain_ms, nbytes, flops=0.0, library_ms=None,
            check="bit-exact", peak_flops=F32_FLOPS, path=True, later=None,
            library_n=None, **dims):
        """``path``: the operand the main path hands this kernel (the row
        of the kernels line). ``later``: a function giving the row's
        profiler fields, run by ``finish_rows`` once every CUDA-event
        timing of the run is done. ``library_n``: the columns the library
        call computes a row (default: the kernel's own, ``n`` or ``N``)."""
        b_ms, b_by = bound(nbytes, flops, peak_flops)
        if library_ms is not None and library_n is None:
            library_n = dims.get("n", dims.get("N"))
        rows.append({"name": name, "shape": shape, "path": path, **dims,
                     "max_abs_err": max_err, "check": check, "kernel_ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_n": library_n,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "device": torch.cuda.get_device_name(0)})
        if later is not None:
            rows[-1]["_later"] = later

    # weighted_sum: intra-silo FedAvg of M clients (f32): the unpadded
    # contiguous stack the main path hands it (8-byte-aligned rows), and at
    # the main shape also the 4096-padded width of earlier rows
    M = 4 if large else 2
    w = torch.rand((M,), generator=gen, device="cuda")
    w = w / w.sum()
    for N, path in ([(LARGE_N, True)] if large else
                    [(MAIN_N + (-MAIN_N) % WSUM_PAD, False), (MAIN_N, True)]):
        x = torch.randn((M, N), generator=gen, device="cuda")
        got, want = wsum.weighted_sum(x, w), ref.weighted_sum(x, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        # an M-term f32 sum in another order: within M ulps of sum |w x|
        scale = float((w.abs()[:, None] * x.abs()).sum(0).max())
        if not err <= M * 2.0 ** -23 * scale:
            fail(f"weighted_sum {shape} N={N}: max_abs_err {err} "
                 f"(scale {scale})")
        # the kernel's own order, bit for bit: fmaf over m = 0..M-1 from 0
        if not torch.equal(got, ref.weighted_sum_ordered(x, w)):
            fail(f"weighted_sum {shape} N={N}: not the ordered FMA chain")
        w_host = w.cpu()
        if not torch.equal(wsum.weighted_sum(x, w_host), got):
            fail(f"weighted_sum {shape} N={N}: host weights give other bits")
        fns = {"kernel": lambda: wsum.weighted_sum(x, w),
               "plain": lambda: ref.weighted_sum(x, w),
               "library": lambda: torch.matmul(w, x)}
        if not large:
            fns["host_w"] = lambda: wsum.weighted_sum(x, w_host)
        ts = timed(fns, iters)
        extra = {} if large else {
            "kernel_ms_host_w": ts["host_w"],
            "later": lambda x=x, w=w, w_host=w_host: {
                "device_us_per_launch_host_w": device_time(
                    lambda: wsum.weighted_sum(x, w_host))[
                        "device_us_per_launch"],
                **device_time(lambda: wsum.weighted_sum(x, w))}}
        row("weighted_sum", err, ts["kernel"], ts["plain"],
            (M + 1) * N * 4, 2.0 * M * N, library_ms=ts["library"],
            check=f"abs err <= M*2^-23*max sum|w x| = "
                  f"{M * 2.0 ** -23 * scale:.3e}; bit-exact with the ordered "
                  "FMA chain; host w same bits",
            path=path, M=M, N=N, layout="contiguous", **extra)
        del x, got, want

    if not large:
        fedavg_up_row(gen, iters, row)

    # quantize: the int8 wire encode, N padded to 131072
    N = LARGE_N if large else MAIN_N + (-MAIN_N) % ops.QUANT_BLOCK
    xq = quant_input(N, gen)
    (q, s), (q0, s0) = quant.quantize(xq), ref.quantize_int8(xq)
    torch.cuda.synchronize()
    if not (torch.equal(q, q0) and torch.equal(s, s0)):
        fail(f"quantize {shape}: codes or scales differ from the plain "
             f"version ({int((q != q0).sum())} codes)")
    ts = timed({"kernel": lambda: quant.quantize(xq),
                "plain": lambda: ref.quantize_int8(xq)}, iters)
    extra = {} if large else {"later": lambda xq=xq: one_kernel_a_call(
        "quantize", lambda: quant.quantize(xq), "quantize_kernel")}
    row("quantize", 0.0, ts["kernel"], ts["plain"],
        N * 4 + N + N // 1024 * 4, path=large, N=N, **extra)
    if not large:
        # the main path's call (wire.encode_vec): ops.quantize pads the
        # n = 62,006 floats of a flattened model to the 131,072 of the wire
        # payload (F.pad), then launches the kernel
        xm = xq[:MAIN_N].clone()
        call = lambda xm=xm: ops.quantize(xm)
        plain = lambda xm=xm: ref.quantize_int8(F.pad(xm, (0, N - MAIN_N)))
        (q, s, n), (q0, s0) = launched_once("quantize", call), plain()
        torch.cuda.synchronize()
        if not (n == MAIN_N and torch.equal(q, q0) and torch.equal(s, s0)):
            fail("quantize through ops at n=62,006: codes or scales differ "
                 "from the plain version")
        ts = timed({"kernel": call, "plain": plain}, iters)
        row("quantize", 0.0, ts["kernel"], ts["plain"],
            MAIN_N * 4 + N + N // 1024 * 4, N=N, n=MAIN_N,
            check="bit-exact codes and scales; through ops (F.pad, then "
                  "one quantize_kernel a call)",
            later=lambda call=call: ops_call_profile(
                "quantize through ops", call, "quantize_kernel"))

    # dequantize: K payloads in one launch (scoring ingest, K=2; K=8 large)
    K = 8 if large else 2
    qk = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                       dtype=torch.int8)
    sk = torch.rand((K, N // 1024), generator=gen, device="cuda") * 0.02
    del xq, q, q0
    q1, s1 = qk[0], sk[0]
    # the whole payload (n = N: the 2^28 rows, and at the main shape the
    # padded rows of earlier PRs), then at the main shape the n = 62,006
    # columns the main path keeps, through ops as wire.reconstruct (K = 1)
    # and scorebatch.stack_decoded_vecs (K = 2) call it
    for n, path in ([(N, True)] if large else [(N, False), (MAIN_N, True)]):
        # values bound now: a row's profile runs after this function
        ops_k = lambda qk=qk, sk=sk, n=n: ops.dequantize_batch(qk, sk, n)
        ops_1 = lambda q1=q1, s1=s1, n=n: ops.dequantize(q1, s1, n)
        for name, k, call, plain, lib in [
                ("dequantize", K, ops_k,
                 lambda: ref.dequantize_rows(qk, sk)[:, :n],
                 lambda: torch.mul(qk.view(K, -1, 1024), sk.unsqueeze(-1))),
                ("dequantize_k1", 1, ops_1,
                 lambda: ref.dequantize_int8(q1, s1)[:n],
                 lambda: torch.mul(q1.view(-1, 1024), s1.unsqueeze(-1)))]:
            got, want = launched_once(name, call), plain()
            torch.cuda.synchronize()
            if not (got.shape == want.shape and torch.equal(got, want)):
                fail(f"{name} {shape} n={n}: differs from the plain version")
            # bf16 output: the float32 product rounded once
            bf16 = (ops.dequantize_batch(qk, sk, n, torch.bfloat16) if k > 1
                    else ops.dequantize(q1, s1, n, torch.bfloat16))
            if not torch.equal(bf16, want.to(torch.bfloat16)):
                fail(f"{name} {shape} n={n} bf16: differs from the plain "
                     "version")
            del got, want, bf16
            extra = {} if large else {"later": lambda name=name, call=call:
                                      one_kernel_a_call(name, call,
                                                        "dequantize_kernel")}
            ts = timed({"kernel": call, "plain": plain, "library": lib},
                       iters)
            row(name, 0.0, ts["kernel"], ts["plain"],
                k * n + k * -(-n // 1024) * 4 + k * n * 4,
                library_ms=ts["library"], library_n=N, path=path, K=k, N=N,
                n=n, **extra)

    # wsum_q8: the fused cross-silo merge of M int8 peers
    M = K
    wq = torch.rand((M,), generator=gen, device="cuda")
    got, want = q8agg.wsum_q8(qk, sk, wq), ref.wsum_q8(qk, sk, wq)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # |q| <= 127: the sum is bounded by 127 * max over tiles of sum_m w s
    scale = 127.0 * float((wq[:, None] * sk).sum(0).max())
    if not err <= M * 2.0 ** -22 * scale:
        fail(f"wsum_q8 {shape}: max_abs_err {err} (scale {scale})")
    del got, want
    ts = timed({"kernel": lambda: q8agg.wsum_q8(qk, sk, wq),
                "plain": lambda: ref.wsum_q8(qk, sk, wq)}, iters)
    tol = f"abs err <= M*2^-22*127*max sum w s = {M * 2.0 ** -22 * scale:.3e}"
    extra = {} if large else {"later": lambda qk=qk, sk=sk, wq=wq:
                              one_kernel_a_call(
                                  "wsum_q8", lambda: q8agg.wsum_q8(qk, sk, wq),
                                  "wsum_q8_kernel")}
    row("wsum_q8", err, ts["kernel"], ts["plain"],
        M * N + M * N // 1024 * 4 + N * 4, 2.0 * M * N, check=tol,
        path=large, M=M, N=N, **extra)
    if not large:
        # the main path's call (SiloAggregator.apply_cross_silo_vec): the
        # merge of M int8 peers through ops, the n = 62,006 columns kept
        call = lambda qk=qk, sk=sk, wq=wq: ops.weighted_sum_q8(qk, sk, wq,
                                                               MAIN_N)
        plain = lambda qk=qk, sk=sk, wq=wq: ref.wsum_q8(qk, sk, wq)[:MAIN_N]
        got, want = launched_once("wsum_q8", call), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != (MAIN_N,) or not err <= M * 2.0 ** -22 * scale:
            fail(f"wsum_q8 through ops at n=62,006: shape "
                 f"{tuple(got.shape)}, max_abs_err {err}")
        del got, want
        ts = timed({"kernel": call, "plain": plain}, iters)
        row("wsum_q8", err, ts["kernel"], ts["plain"],
            M * N + M * N // 1024 * 4 + MAIN_N * 4, 2.0 * M * N,
            check=tol + "; through ops", M=M, N=N, n=MAIN_N,
            later=lambda call=call: ops_call_profile(
                "wsum_q8 through ops", call, "wsum_q8_kernel"))
    del qk, sk
    torch.cuda.empty_cache()

    # add_q8_delta: the int8-delta rebuild, bit-exact: the whole payload
    # (n = N), and at the main shape the unpadded base of n = 62,006 floats
    # that wire.reconstruct hands ops (the payload stays 131,072 codes)
    N = LARGE_N if large else MAIN_N + (-MAIN_N) % ops.QUANT_BLOCK
    base = torch.randn((N,), generator=gen, device="cuda") * 0.05
    qd = torch.randint(-127, 128, (N,), generator=gen, device="cuda",
                       dtype=torch.int8)
    sd = torch.rand((N // 1024,), generator=gen, device="cuda") * 1e-3 + 1e-5
    for n, path in ([(N, True)] if large else [(N, False), (MAIN_N, True)]):
        bn = base[:n].clone()       # the caller's own [n] tensor
        call = lambda bn=bn, qd=qd, sd=sd, n=n: ops.add_q8_delta(bn, qd, sd,
                                                                 n)
        got = launched_once("add_q8_delta", call)
        want = ref.add_q8_delta(bn, qd[:n], sd)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"add_q8_delta {shape} n={n}: {int((got != want).sum())} "
                 "elements differ from the plain version")
        del got, want
        extra = {} if large else {
            "later": lambda call=call: one_kernel_a_call(
                "add_q8_delta", call, "add_q8_delta_kernel")}
        ts = timed({"kernel": call,
                    "plain": lambda: ref.add_q8_delta(bn, qd[:n], sd),
                    "library": lambda: torch.addcmul(
                        base.view(-1, 1024), qd.view(-1, 1024),
                        sd.unsqueeze(-1))}, iters)
        row("add_q8_delta", 0.0, ts["kernel"], ts["plain"],
            9 * n + -(-n // 1024) * 4, 2.0 * n, library_ms=ts["library"],
            library_n=N, path=path, N=N, n=n, **extra)
        del bn
    del base, qd, sd
    torch.cuda.empty_cache()

    # gram_q8: MultiKRUM off M int8 payloads (a round's whole-int8 models)
    M = 8 if large else 3
    qg = torch.randint(-127, 128, (M, N), generator=gen, device="cuda",
                       dtype=torch.int8)
    sg = torch.rand((M, N // 1024), generator=gen, device="cuda") * 1e-3 + 1e-4
    # float64 scales: the dequantized models exactly, as the kernel's int8
    # products and scale products stand for them
    got = launched_once("gram_q8", lambda: q8agg.gram_q8(qg, sg))
    err = check_gram("gram_q8", shape, got, ref.gram_q8(qg, sg),
                     ref.dequantize_rows(qg, sg.double()))
    again = q8agg.gram_q8(qg, sg)
    if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
        fail(f"gram_q8 {shape}: a rerun gives other bits")
    del got, again
    extra = {} if large else {"later": lambda qg=qg, sg=sg: one_kernel_a_call(
        "gram_q8", lambda: q8agg.gram_q8(qg, sg), "gram_q8_kernel")}
    ts = timed({"kernel": lambda: q8agg.gram_q8(qg, sg),
                "plain": lambda: ref.gram_q8(qg, sg)}, iters)
    row("gram_q8", err, ts["kernel"], ts["plain"],
        M * N + M * N // 1024 * 4, 2.0 * M * M * N, peak_flops=INT8_OPS,
        check="|G - G_plain| <= sqrt(N) 2^-24 |x_i| |x_j|, sq likewise; "
        "a quarter of that from float64; G symmetric, sq its diagonal, "
        "reruns the same bits; one launch a call",
        M=M, N=N, **extra)
    del qg, sg
    torch.cuda.empty_cache()

    # gram_and_norms: MultiKRUM off M f32 models: the unpadded contiguous
    # stack the main path hands it, and at the main shape also the strided
    # [:, :N] view of a 131,072-padded dequantize and the 2048-padded width
    # of earlier rows
    layouts = ([(LARGE_N, "contiguous", True)] if large else
               [(MAIN_N + (-MAIN_N) % GRAM_PAD, "contiguous", False),
                (MAIN_N, "contiguous", True), (MAIN_N, "strided", False)])
    for N, layout, path in layouts:
        width = ops.QUANT_BLOCK if layout == "strided" else N
        xg = torch.randn((M, width), generator=gen, device="cuda")[:, :N]
        got = multikrum.gram_and_norms(xg)
        err = check_gram("gram_and_norms", f"{shape} N={N} {layout}", got,
                         ref.gram_and_norms(xg), xg)
        again = multikrum.gram_and_norms(xg)
        if not (torch.equal(again[0], got[0])
                and torch.equal(again[1], got[1])):
            fail(f"gram_and_norms {shape} N={N} {layout}: a rerun gives "
                 "other bits")
        extra = {} if large else {"later": lambda xg=xg: one_kernel_a_call(
            "gram_and_norms", lambda: multikrum.gram_and_norms(xg),
            "gram_and_norms_kernel")}
        ts = timed({"kernel": lambda: multikrum.gram_and_norms(xg),
                    "plain": lambda: ref.gram_and_norms(xg),
                    "library": lambda: torch.matmul(xg, xg.T)}, iters)
        row("gram_and_norms", err, ts["kernel"], ts["plain"],
            4 * M * N, 2.0 * M * M * N, library_ms=ts["library"],
            check="|G - G_plain| <= sqrt(N) 2^-24 |x_i| |x_j|, sq likewise; "
            "a quarter of that from float64; G symmetric, sq its diagonal, "
            "reruns the same bits",
            path=path, M=M, N=N, layout=layout, **extra)
        del got, again
        torch.cuda.empty_cache()
    return rows


def finish_rows(rows) -> None:
    """Run each row's deferred profile (``torch.profiler`` leaves a cost on
    every later launch, see ``launch_rate``, so it runs after the CUDA-event
    timings) and print the rows."""
    for r in rows:
        later = r.pop("_later", None)
        if later is not None:
            r.update(later())
        print(json.dumps(r), flush=True)


def int8_calls(seed: int) -> dict:
    """The main path's int8 ops calls at n = 62,006 off 131,072 payloads,
    each as (the ops call, its library call, its kernel, the kernel's C
    arguments for one call on fixed operands, the output allocation)."""
    from repro_torch.kernels import _build, ops
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(-127, 128, (2, ops.QUANT_BLOCK), generator=g,
                      device="cuda", dtype=torch.int8)
    s = torch.rand((2, ops.QUANT_BLOCK // 1024), generator=g, device="cuda")
    q0, s0 = q[0], s[0]
    padded = torch.randn(ops.QUANT_BLOCK, generator=g, device="cuda")
    base = padded[:MAIN_N].clone()
    out = torch.empty_strided((2, MAIN_N), (MAIN_N + 2, 1), device="cuda")
    stream = _build.stream_of(q)
    return {
        "dequantize": (
            lambda: ops.dequantize(q0, s0, MAIN_N),
            lambda: torch.mul(q0.view(-1, 1024), s0.unsqueeze(-1)),
            "dequantize", (q.data_ptr(), MAIN_N, s.data_ptr(), 0,
                           out.data_ptr(), MAIN_N, 1, MAIN_N, 0, stream),
            lambda: torch.empty(MAIN_N, dtype=torch.float32,
                                device=q.device)),
        "dequantize_batch": (
            lambda: ops.dequantize_batch(q, s, MAIN_N),
            lambda: torch.mul(q.view(2, -1, 1024), s.unsqueeze(-1)),
            "dequantize", (q.data_ptr(), q.stride(0), s.data_ptr(),
                           s.stride(0), out.data_ptr(), MAIN_N + 2, 2,
                           MAIN_N, 0, stream),
            lambda: torch.empty_strided((2, MAIN_N), (MAIN_N + 2, 1),
                                        dtype=torch.float32,
                                        device=q.device)),
        "add_q8_delta": (
            lambda: ops.add_q8_delta(base, q0, s0, MAIN_N),
            lambda: torch.addcmul(padded.view(-1, 1024), q0.view(-1, 1024),
                                  s0.unsqueeze(-1)),
            "add_q8_delta", (base.data_ptr(), q.data_ptr(), s.data_ptr(),
                             out.data_ptr(), MAIN_N, stream),
            lambda: torch.empty(MAIN_N, dtype=torch.float32,
                                device=q.device))}


def launch_rate(iters: int = 200) -> dict:
    """CUDA-event time a call of the main path's int8 ops calls and of
    their library calls, in turns (``timed``): host-bound at this size, so
    the launch rate. Called before the run's first profiler session and
    again after the last."""
    return {name: timed({"ops_ms": call, "library_ms": lib}, iters)
            for name, (call, lib, *_) in int8_calls(6).items()}


def wkv6_inputs(B: int, T: int, H: int, hs: int, gen):
    """The model's dtypes and ranges: bf16 r, k, v (unit normal, as after
    the projections), f32 w = exp(-exp(decay_base + dw)) with decay_base
    uniform in [-7, -1] per channel (``init_params``), f32 u in [0, 0.5]
    and a random f32 state."""
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")
    r, k, v = (n(B, T, H, hs).to(torch.bfloat16) for _ in range(3))
    base = torch.rand((H, hs), generator=gen, device="cuda") * -6.0 - 1.0
    w = torch.exp(-torch.exp(base + 0.5 * n(B, T, H, hs)))
    u = torch.rand((H, hs), generator=gen, device="cuda") * 0.5
    return r, k, v, w, u, n(B, H, hs, hs)


WKV6_SHAPES = {"main": (4, 64, 32, 64),        # the 4 x 64 serving prefill
               "long": (4, 1000, 32, 64),      # the 4 x 1000 prefill
               "large": (8, 4096, 32, 64)}


def check_wkv6(shape: str, gen, iters: int) -> dict:
    """wkv6 against its plain token scan and against its own sub-chunked
    arithmetic written out in PyTorch (``ref.wkv6_subchunks``): |dy| <=
    WKV_REL * max|y| plus one bf16 ulp of |y| (y is bf16: the two may round
    a float32 value to either side of a bf16 boundary), |dS| <= WKV_REL *
    max|S| (float32 sums in another order; the scan itself sits within
    about 1e-6 of float64 at T <= 4096). The row's profile (device time a
    launch, one launch a call) is deferred to ``finish_rows``."""
    from repro_torch.kernels import ref, rwkv6
    B, T, H, hs = WKV6_SHAPES[shape]
    args = wkv6_inputs(B, T, H, hs, gen)
    y, s = launched_once("wkv6", lambda: rwkv6.wkv6(*args))
    errs = {}
    for name, plain in [("scan", ref.wkv6_naive), ("subchunks",
                                                     ref.wkv6_subchunks)]:
        y0, s0 = plain(*args)
        torch.cuda.synchronize()
        dy = (y.float() - y0.float()).abs()
        ds = (s - s0).abs()
        ymax, smax = float(y0.float().abs().max()), float(s0.abs().max())
        ok = bool((dy <= WKV_REL * ymax + BF16_ULP * y0.float().abs()).all())
        if not ok or float(ds.max()) > WKV_REL * smax:
            fail(f"wkv6 {shape} vs {name}: max |dy| {float(dy.max())} "
                 f"(max|y| {ymax}), max |dS| {float(ds.max())} "
                 f"(max|S| {smax})")
        errs[name] = (float(dy.max()), float(ds.max()), ymax, smax)
        del y0, s0, dy, ds
    if not torch.equal(rwkv6.wkv6(*args)[0], y):
        fail(f"wkv6 {shape}: a rerun gives other bits")
    # the least work a token and head: y = S^T r (2 hs^2) plus the bonus
    # v_j * sum_i r_i u_i k_i (5 hs: the sum does not depend on j), and
    # S <- diag(w) S + k v^T (3 hs^2)
    n = B * T * H * hs
    nbytes = 12 * n + 2 * B * H * hs * hs * 4
    b_ms, b_by = bound(nbytes, (5.0 * hs + 5) * n)
    # the same work on the units the chunked kernel gives it, a token and
    # head (chunks of C = 32): on the tensor cores, as three TF32 products
    # each (a third of their rate), y = rq S and the state's kq^T v (2 hs^2
    # each) and A v over A's causal half ((C + 1) hs); on the CUDA cores
    # A's dot products ((C - 1) hs), the bonus and the decay products (3 hs
    # each) and diag(W) S once a chunk (hs^2 / C)
    C = 32
    tc_ms = (4.0 * hs * hs + (C + 1) * hs) * B * T * H / (TF32_FLOPS / 3)
    alu_ms = ((C + 5.0) * hs + hs * hs / C) * B * T * H / F32_FLOPS
    bytes_ms = nbytes / HBM_BYTES_PER_S
    b_tc_ms, b_tc_by = ((bytes_ms, "bytes") if bytes_ms >= tc_ms + alu_ms
                        else (tc_ms + alu_ms, "operations"))
    dy, ds, ymax, smax = errs["scan"]
    row = {"name": "wkv6", "shape": shape, "path": True, "B": B, "T": T,
           "H": H, "hs": hs, "max_abs_err": max(dy, ds),
           "max_abs_err_y": dy, "max_abs_err_state": ds, "max_abs_y": ymax,
           "max_abs_state": smax,
           "max_abs_err_vs_subchunks": max(errs["subchunks"][:2]),
           "check": f"|dy| <= {WKV_REL} max|y| + 2^-7 |y|, "
                    f"|dS| <= {WKV_REL} max|S|, against the token scan and "
                    "the sub-chunked arithmetic; reruns the same bits",
           "kernel_ms": cuda_ms(lambda: rwkv6.wkv6(*args), iters),
           "plain_ms": cuda_ms(lambda: ref.wkv6_naive(*args),
                               max(2, iters // 20), reps=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bound_tc_ms": b_tc_ms * 1e3, "bound_tc_by": b_tc_by,
           "device": torch.cuda.get_device_name(0)}
    row["of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["of_bound_tc"] = row["bound_tc_ms"] / row["kernel_ms"]
    if shape != "large":
        row["_later"] = lambda: one_kernel_a_call(
            f"wkv6 {shape}", lambda: rwkv6.wkv6(*args), "wkv6_kernel")
    return row


def host_path(calls: int = 20000) -> dict:
    """Host microseconds a call (mean over a run of calls after a tenth as
    many warm-up calls, the queue drained at its end): the current stream's
    raw handle (a ``torch.cuda.Stream`` object built each call against the
    private raw getter that ``_build.stream_of`` reads); the main path's
    int8 ops calls at n = 62,006, each twice, beside its C call alone on
    fixed arguments through its ``_build.Kernel``, the output allocation
    and the library call. ``dequantize`` passes its ten arguments packed
    into one int64 array; its C call with typed arguments (``ctypes``
    converting each) is timed beside it, the bindings in turns."""
    import ctypes
    from repro_torch.kernels import _build
    x = torch.zeros(1, device="cuda")

    def per_call(fn, n=calls):
        for _ in range(n // 10):      # warm-up
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    line = {"phase": "host-path",
            "stream_object_us": per_call(
                lambda: torch.cuda.current_stream(x.device).cuda_stream),
            "raw_stream_us": per_call(lambda: _build.stream_of(x))}
    if _build.stream_of(x) != torch.cuda.current_stream(x.device).cuda_stream:
        fail("stream_of differs from the current stream")
    for name, (call, lib, kname, args, alloc) in int8_calls(3).items():
        k = _build.KERNELS[kname]
        timings = {"ops call": call, "C call alone": lambda: k(*args)}
        if k.packed:
            typed = _build.library()[k.symbol]    # a binding of its own
            typed.argtypes, typed.restype = k.argtypes, ctypes.c_int
            if typed(*args) != 0:
                fail(f"{name}: the typed binding's call failed")
            timings["C call alone, typed arguments"] = lambda: typed(*args)
        us = {}
        for _ in range(2):
            for tag, fn in timings.items():
                us.setdefault(tag, []).append(per_call(fn, calls // 8))
        line[f"{name}_us"] = {
            **us, "binding": "packed" if k.packed else "typed",
            "output allocation": per_call(alloc, calls // 4),
            "library": per_call(lib, calls // 4)}
    print(json.dumps(line), flush=True)
    return line


def reconstruct_line(calls: int = 2000) -> dict:
    """An int8-delta envelope rebuilt at the main shape (``reconstruct``:
    the kept tiles scattered into the dense 131,072 grid, then
    ``ops.add_q8_delta`` on the unpadded base): host microseconds a call,
    the kernel launches a call and the device's launches a call."""
    import numpy as np
    from repro_torch.core import wire
    from repro_torch.kernels import _build
    g = torch.Generator(device="cuda").manual_seed(4)
    base = torch.randn(MAIN_N, generator=g, device="cuda") * 0.05
    vec = base.clone()
    vec[:20 * 1024] += torch.randn(20 * 1024, generator=g,
                                   device="cuda") * 1e-3
    e = wire.encode_vec(vec, "int8-delta", base_vec=base)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to("cuda")
    env = wire.ModelEnvelope("int8-delta", e.n, base_cid="base", q=dev(e.q),
                             scales=dev(e.scales), tiles=dev(e.tiles))
    out = env.reconstruct(base)
    err = float((out - vec).abs().max())
    # within half a quantization step of the largest kept scale
    if out.shape != (MAIN_N,) or not err <= 0.5 * float(env.scales.max()):
        fail(f"reconstruct: shape {tuple(out.shape)}, max |out - vec| {err}")
    before = _build.launch_counts()["add_q8_delta"]
    env.reconstruct(base)
    t0 = time.perf_counter()
    for _ in range(calls):
        env.reconstruct(base)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    launches = _build.launch_counts()["add_q8_delta"] - before
    per_call = launches / (calls + 1)
    if per_call != 1:
        fail(f"reconstruct: {per_call} add_q8_delta launches a call")
    prof = device_time(lambda: env.reconstruct(base))
    line = {"phase": "reconstruct-int8-delta", "n": MAIN_N,
            "tiles_kept": int(env.tiles.shape[0]),
            "host_us_per_call": host_us,
            "add_q8_delta_launches_per_call": per_call,
            "device_launches_per_call": prof["launches_seen_per_call"],
            "device_us_per_launch": prof["device_us_per_launch"],
            "device_kernels": sorted(set(prof["device_kernels"])),
            "max_abs_err_vs_vec": err}
    print(json.dumps(line), flush=True)
    return line


def check_gram(name: str, shape: str, got, want, x) -> float:
    """G and sq against the plain version and against the same sums in
    float64, within GRAM_ULPS * sqrt(N) float32 ulps of |x_i| * |x_j|: a
    float32 sum of N terms taken in another order moves by about sqrt(N)
    roundings (the plain version's cuBLAS product sums long runs of N in
    one order). The kernel must sit 4x closer than that to float64. G must
    be exactly symmetric and sq exactly its diagonal (the kernel's
    fixed-order reduction). Returns the largest error against the plain
    version."""
    torch.cuda.synchronize()
    x64 = x.double()
    g64 = x64 @ x64.T
    del x64
    norms = g64.diagonal().sqrt()
    tol = GRAM_ULPS * x.shape[1] ** 0.5 * 2.0 ** -24
    bound = tol * norms[:, None] * norms[None, :]

    def err(a, b):
        return ((a[0].double() - b[0]).abs() / bound).max().item(), \
            ((a[1][:, 0].double() - b[1]).abs() / bound.diagonal()).max().item()

    vs_plain = err(got, (want[0].double(), want[1][:, 0].double()))
    vs_f64 = err(got, (g64, g64.diagonal()))
    print(json.dumps({"check": name, "shape": shape, "tol": tol,
                      "err_vs_plain_of_bound": vs_plain,
                      "err_vs_f64_of_bound": vs_f64}), flush=True)
    if max(vs_plain) > 1.0 or max(vs_f64) > 0.25:
        fail(f"{name} {shape}: G, sq off by {vs_plain} of the bound against "
             f"the plain version, {vs_f64} against float64")
    if not (torch.equal(got[0], got[0].T)
            and torch.equal(got[1][:, 0], got[0].diagonal())):
        fail(f"{name} {shape}: G not symmetric or sq not its diagonal")
    return max(float((got[0] - want[0]).abs().max()),
               float((got[1] - want[1]).abs().max()))


# --------------------------------------------------------------------------- #
# Phase 4: the main path
# --------------------------------------------------------------------------- #

def run_experiment(compression: str, rounds: int, device: str,
                   scorer: str = "accuracy"):
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment, global_eval
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=rounds, mode="sync",
                    scorer=scorer, agg_policy="top_k", policy_k=2,
                    compression=compression)
    orch = build_image_experiment(get_config("paper-cnn"), fed,
                                  partition="niid", alpha=0.2, n_train=1500,
                                  n_test=450, seed=0, device=device)
    t0 = time.perf_counter()
    orch.run(rounds)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return orch, global_eval(orch), wall


def profile_rounds(compression: str, scorer: str, rounds: int) -> dict:
    """Sync rounds on the card under ``torch.profiler``: the device's busy
    share of the rounds' wall time and the kernels that fill it. Its
    launches are not counted toward the main path."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    from repro_torch.kernels import _build
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=rounds, mode="sync",
                    scorer=scorer, agg_policy="top_k", policy_k=2,
                    compression=compression)
    orch = build_image_experiment(get_config("paper-cnn"), fed,
                                  partition="niid", alpha=0.2, n_train=1500,
                                  n_test=450, seed=0, device="cuda")
    torch.cuda.synchronize()
    before = _build.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        orch.run(rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    # device time of the ported kernels alone (their launch gaps excluded)
    ported = {}
    for name in ("weighted_sum_kernel", "quantize_kernel",
                 "dequantize_kernel", "wsum_q8_kernel", "add_q8_delta_kernel",
                 "gram_q8_kernel", "gram_and_norms_kernel"):
        hits = [e for e in kern if f"::{name}" in e.key]  # not de-quantize
        ported[name] = {"count": sum(e.count for e in hits),
                        "ms": sum(e.self_device_time_total for e in hits)
                        / 1e3}
    # each Gram call is one launch of its own kernel, nothing more
    calls = {k: launches[k] - before[k] for k in ("gram_q8", "gram_and_norms")}
    for k, n in calls.items():
        if ported[f"{k}_kernel"]["count"] != n:
            fail(f"profile {compression}-{scorer}: {ported[k + '_kernel']} "
                 f"{k}_kernel launches for {n} {k} calls")
    return {"phase": f"profile-{compression}-{scorer}", "rounds": rounds,
            "gram_calls": calls,
            "wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_kernels": len(kern),
            "ported_kernels": ported,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def check_against_cpu(name: str, orch, ge, cpu_run) -> None:
    """The same run on the CPU (the init is drawn on the CPU either way)
    through the plain versions: same picks and ledger, and global accuracy
    within ACC_TOL (450 test images; float32 sums in another order and
    cuDNN's convolution algorithms move a few predictions, not the
    outcome)."""
    ref_orch, ref_ge, _ = cpu_run
    if [s.pick_log for s in orch.silos] != [s.pick_log for s in ref_orch.silos]:
        fail(f"{name} run: picks differ from the CPU run")
    if orch.ledger.height != ref_orch.ledger.height:
        fail(f"{name} run: ledger height differs from the CPU run")
    for sid, v in ge.items():
        a, b = v["accuracy"], ref_ge[sid]["accuracy"]
        if not (0.0 <= a <= 1.0) or abs(a - b) > ACC_TOL:
            fail(f"{name} run, {sid}: global accuracy {a} on the card vs {b} "
                 "on the CPU")


# --------------------------------------------------------------------------- #
# Phase 5: the Async engine and the WAN fabric
# --------------------------------------------------------------------------- #

# each silo's training window in simulated seconds (time_scale 0 charges no
# host compute, so runs on the card and the CPU see one clock), the last
# silo a straggler by 2.0 s; silo1 is killed in round 2 and restarted in 3
ASYNC_DELAYS = (2.0, 2.0, 4.0)
KILL_NODE = "silo1"


def async_run(device: str, *, net: bool = True, faults: bool = True,
              rounds: int = 3, profiler=None):
    """Async UnifyFL with int8-delta: 3 silos x 2 clients, top-2, paper CNN
    at its published width, every silo at time_scale 0. ``net``: over
    ``wan-heterogeneous`` with gossip (factor 1) and prefetch, a WAL
    directory under ``build/``, and with ``faults`` the kill and restart of
    KILL_NODE; without ``net``, the single-replica ledger. Runs the
    simulated clock dry after ``run`` (gossip and prefetch in flight; their
    decodes launch kernels too). Returns (orch, global accuracy, run wall
    seconds, drain wall seconds)."""
    import shutil
    from repro_torch.config import FaultScenario, FedConfig, NetConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import (SiloSpec, build_image_experiment,
                                          global_eval)
    netcfg = None
    if net:
        wal = os.path.join(HERE, "build", "chip_smoke_wal", device)
        shutil.rmtree(wal, ignore_errors=True)
        scenarios = (FaultScenario(action="kill", node=KILL_NODE, round=2,
                                   when="train"),
                     FaultScenario(action="restart", node=KILL_NODE, round=3,
                                   when="train")) if faults else ()
        netcfg = NetConfig(preset="wan-heterogeneous", replication_factor=1,
                           prefetch=True, scenarios=scenarios, wal_dir=wal)
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=rounds,
                    mode="async", scorer="accuracy", agg_policy="top_k",
                    policy_k=2, compression="int8-delta", net=netcfg)
    orch = build_image_experiment(
        get_config("paper-cnn"), fed, partition="niid", alpha=0.2,
        n_train=1500, n_test=450, seed=0, device=device,
        silo_specs=[SiloSpec(extra_train_delay=d) for d in ASYNC_DELAYS])
    for s in orch.silos:
        s.time_scale = 0.0
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    orch.run(rounds)
    sync()
    wall = time.perf_counter() - t0
    orch.env.run()
    sync()
    return orch, global_eval(orch), wall, time.perf_counter() - t0 - wall


def async_summary(orch, ge) -> dict:
    """What an Async run did: rounds, picks, simulated submission times,
    heights, round marks with WAN and chain bytes, the chain's recovery
    counters and convergence, prefetch and fetch-stall figures."""
    s0 = orch.silos
    out = {"rounds_done": [s.rounds_done for s in s0],
           "picks": [[p["owners"] for p in s.pick_log] for s in s0],
           "submit_t": [[m["t"] for m in s.metrics] for s in s0],
           "ledger_height": orch.ledger.height,
           "sim_end_s": orch.env.now,
           "global_accuracy": {k: v["accuracy"] for k, v in ge.items()}}
    if orch.chain is None:
        return out
    chain = orch.chain
    marks = orch.round_log
    store = [m["wan_bytes"] - m["chain_bytes"] for m in marks]
    out.update({
        "chain_heights": {n: r.height for n, r in chain.replicas.items()},
        "round_log": [{k: m[k] for k in ("round", "silo", "t", "wan_bytes",
                                         "chain_bytes")} for m in marks],
        "store_wan_bytes_per_mark": [b - a for a, b in zip([0] + store,
                                                           store)],
        "wan_bytes": orch.fabric.stats["bytes"],
        "chain_bytes": orch.fabric.stats["chain_bytes"],
        "fetch_stall_s": sum(s.store.stats["fetch_time"] for s in s0),
        "prefetch": orch.prefetcher.hit_stats() if orch.prefetcher else None,
        "forks_observed": chain.totals("forks_observed"),
        "reorgs": chain.totals("reorgs"),
        **{k: chain.stats[k] for k in ("kills", "restarts", "wal_replayed",
                                       "restart_fabric_bytes")},
        "converged": chain.converged(),
        "state_digests": len(set(chain.state_digests().values())),
        "replicas_verify": all(r.verify() for r in chain.replicas.values())})
    return out


def check_chain(name: str, summ: dict, *, faults: bool) -> None:
    """The invariants the reference's recovery and chain tests assert."""
    if not (summ["converged"] and summ["state_digests"] == 1
            and summ["replicas_verify"]):
        fail(f"{name}: replicas did not converge to one verified state "
             f"({summ['converged']}, {summ['state_digests']} digests)")
    if faults and not (summ["kills"] == summ["restarts"] == 1
                       and summ["wal_replayed"] > 0
                       and summ["restart_fabric_bytes"] == 0):
        fail(f"{name}: kill/restart counters {summ['kills']}, "
             f"{summ['restarts']}, wal_replayed {summ['wal_replayed']}, "
             f"restart_fabric_bytes {summ['restart_fabric_bytes']}")


def decoded_on_card(orch) -> int:
    """Decoded models held by the silos' stores, failing on any that is not
    a tensor on the card (prefetch and gossip decodes included)."""
    held = 0
    for s in orch.silos:
        for dm in s.store._decoded.values():
            for t in (dm.q, dm.scales, dm._vec):
                if t is not None and t.device.type != "cuda":
                    fail(f"{s.silo_id}: a decoded model lives on {t.device}")
            held += 1
    return held


def async_wan_phase(tree) -> dict:
    """``async-int8-delta-wan``: the Async path over the WAN fabric on the
    card with the launch counts set to 0 just before it; the same run on the
    CPU; the same run without the fabric on both (strict parity)."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    orch, ge, wall, drain = async_run("cuda")
    launches = _build.launch_counts()
    summ = async_summary(orch, ge)
    line = {"phase": "async-int8-delta-wan", "rounds": 3,
            "delays_s": ASYNC_DELAYS, "kill_restart": KILL_NODE,
            "wall_s": wall, "drain_wall_s": drain, "launches": launches,
            "decoded_models_on_card": decoded_on_card(orch), **summ}
    print(json.dumps(line), flush=True)
    if not orch.ledger.verify() or summ["rounds_done"] != [3, 3, 3]:
        fail(f"async wan run: ledger or rounds {summ['rounds_done']}")
    check_chain("async wan run", summ, faults=True)
    for s in orch.silos:
        if any(t.device.type != "cuda" for t in tree.leaves(s.cluster.params)):
            fail(f"async wan run, {s.silo_id}: params left the card")
    missing = [k for k in ("weighted_sum", "quantize", "dequantize",
                           "add_q8_delta", "wsum_q8") if launches[k] == 0]
    if missing:
        fail(f"async wan run never launched {missing}")

    # the same run on the CPU. CIDs differ from the card's by float rounding
    # and fall into the chain's smallest-head-hash tie-breaks, which decide
    # when a score reaches a replica; so the picks, heights and bytes are
    # printed side by side, and the run is held to what no tie can move
    cpu, cpu_ge, cpu_wall, _ = async_run("cpu")
    ref = async_summary(cpu, cpu_ge)
    check_chain("async wan run on the CPU", ref, faults=True)
    same = {k: summ[k] == ref[k] for k in
            ("picks", "submit_t", "ledger_height", "chain_heights",
             "store_wan_bytes_per_mark", "wan_bytes", "chain_bytes")}
    acc = {sid: [v, ref["global_accuracy"][sid]]
           for sid, v in summ["global_accuracy"].items()}
    cross = {"phase": "async-int8-delta-wan-cross-check-cpu",
             "cpu_wall_s": cpu_wall, "equal": same,
             "cpu": {k: ref[k] for k in same}, "global_accuracy": acc}
    print(json.dumps(cross), flush=True)
    if ref["rounds_done"] != summ["rounds_done"] or any(
            ref[k] != summ[k] for k in ("kills", "restarts",
                                        "restart_fabric_bytes")):
        fail("async wan run: rounds or kill/restart differ from the CPU run")
    for sid, (a, b) in acc.items():
        if not 0.0 <= a <= 1.0 or (same["picks"] and abs(a - b) > ACC_TOL):
            fail(f"async wan run, {sid}: global accuracy {a} on the card vs "
                 f"{b} on the CPU (picks equal: {same['picks']})")

    # without the fabric no CID reaches a tie-break: strict parity
    runs = {dev: async_run(dev, net=False) for dev in ("cuda", "cpu")}
    (o_c, ge_c, wall_c, _), (o_h, ge_h, _, _) = runs["cuda"], runs["cpu"]
    a, b = async_summary(o_c, ge_c), async_summary(o_h, ge_h)
    print(json.dumps({"phase": "async-int8-delta-ledger", "wall_s": wall_c,
                      **a, "cpu_global_accuracy": b["global_accuracy"]}),
          flush=True)
    for k in ("rounds_done", "picks", "submit_t", "ledger_height"):
        if a[k] != b[k]:
            fail(f"async ledger run: {k} {a[k]} on the card, {b[k]} on the "
                 "CPU")
    if not any(p for ps in a["picks"] for p in ps):
        fail("async ledger run: no silo merged a peer")
    for sid, v in a["global_accuracy"].items():
        if abs(v - b["global_accuracy"][sid]) > ACC_TOL:
            fail(f"async ledger run, {sid}: global accuracy {v} on the card "
                 f"vs {b['global_accuracy'][sid]} on the CPU")
    return {"launches": launches, "wall_s": wall}


def profile_async_wan() -> dict:
    """The Async WAN run once more, under ``torch.profiler``: the device's
    busy share of its wall time and the kernels that fill it. Its launches
    are not counted toward the path."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        orch, _, wall, drain = async_run("cuda")
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    ported = {}
    for name in ("weighted_sum_kernel", "quantize_kernel",
                 "dequantize_kernel", "wsum_q8_kernel",
                 "add_q8_delta_kernel"):
        hits = [e for e in kern if f"::{name}" in e.key]
        ported[name] = {"count": sum(e.count for e in hits),
                        "ms": sum(e.self_device_time_total for e in hits)
                        / 1e3}
    total = wall + drain
    return {"phase": "profile-async-int8-delta-wan", "rounds": 3,
            "wall_s": total, "wall_s_per_round": total / 3,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / total,
            "sim_end_s": orch.env.now, "device_kernels": len(kern),
            "ported_kernels": ported,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def sync_multikrum_wan() -> dict:
    """``sync-multikrum-wan``: Sync with int8-delta and MultiKRUM over the
    ``lan`` fabric, 4 silos (1.0-1.15 s windows, time_scale 0), silo2 and
    silo3 partitioned away in round 2 and healed in round 3, launch counts
    set to 0 just before it: the Gram kernels run behind fabric fetches
    (``gram_q8`` on round 1's whole int8 models, ``gram_and_norms`` on the
    rebuilt deltas), and every replica converges after the heal."""
    from repro_torch.config import FaultScenario, FedConfig, NetConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import SiloSpec, build_image_experiment
    from repro_torch.kernels import _build
    scenarios = (FaultScenario(action="partition", node="silo2,silo3",
                               round=2, when="train"),
                 FaultScenario(action="heal", round=3, when="train"))
    fed = FedConfig(n_silos=4, clients_per_silo=2, rounds=3, mode="sync",
                    scorer="multikrum", agg_policy="top_k", policy_k=2,
                    compression="int8-delta", round_deadline_s=3.0,
                    scorer_deadline_s=2.0,
                    net=NetConfig(preset="lan", replication_factor=1,
                                  prefetch=True, scenarios=scenarios))
    orch = build_image_experiment(
        get_config("paper-cnn"), fed, partition="niid", alpha=0.2,
        n_train=1500, n_test=450, seed=0, device="cuda",
        silo_specs=[SiloSpec(extra_train_delay=1.0 + 0.05 * i)
                    for i in range(4)])
    for s in orch.silos:
        s.time_scale = 0.0
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    orch.run(3)
    orch.env.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    summ = async_summary(orch, {})
    line = {"phase": "sync-multikrum-wan", "rounds": 3, "wall_s": wall,
            "launches": launches,
            "demand_fetches": sum(s.store.stats["peer_fetches"]
                                  for s in orch.silos),
            "prefetch": orch.prefetcher.hit_stats(),
            **{k: summ[k] for k in ("rounds_done", "ledger_height",
                                    "chain_heights", "forks_observed",
                                    "reorgs", "converged", "state_digests",
                                    "replicas_verify", "wan_bytes",
                                    "chain_bytes", "fetch_stall_s")}}
    print(json.dumps(line), flush=True)
    check_chain("sync multikrum wan run", summ, faults=False)
    if summ["rounds_done"] != [3] * 4 or summ["forks_observed"] < 1:
        fail(f"sync multikrum wan run: rounds {summ['rounds_done']}, forks "
             f"{summ['forks_observed']}")
    if not (launches["gram_q8"] and launches["gram_and_norms"]):
        fail(f"sync multikrum wan run: Gram launches {launches}")
    return {"launches": launches}


def sync_vs_async_straggler() -> dict:
    """``sync-vs-async-straggler`` (paper §4.2.4), the specs of the
    reference's ``tests/test_system.py::test_async_runs_and_is_faster_than_
    sync_with_straggler``: 3 silos x 2 clients, 2 rounds, silo2 2.0 s late
    a round, host compute on the card charged to the simulated clock
    (time_scale 1). The simulated time at which the fast silos finish in
    Async against Sync's end, in simulated seconds."""
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import SiloSpec, build_image_experiment
    out = {}
    for mode in ("sync", "async"):
        fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=2,
                        local_epochs=1, mode=mode, scorer="accuracy",
                        agg_policy="all", score_policy="median")
        orch = build_image_experiment(
            get_config("paper-cnn"), fed, n_train=600, n_test=200, seed=0,
            device="cuda", silo_specs=[SiloSpec(), SiloSpec(),
                                       SiloSpec(extra_train_delay=2.0)])
        orch.run(2)
        fast = [s for s in orch.silos if s.extra_train_delay == 0.0]
        out[mode] = {"sim_end_s": orch.env.now,
                     "fast_done_sim_s": max(m["t"] for s in fast
                                            for m in s.metrics)}
    line = {"phase": "sync-vs-async-straggler",
            "clock": "simulated seconds; host compute on the card charged "
                     "at time_scale 1.0",
            "async_fast_silos_done_sim_s": out["async"]["fast_done_sim_s"],
            "sync_end_sim_s": out["sync"]["sim_end_s"],
            "async_end_sim_s": out["async"]["sim_end_s"]}
    print(json.dumps(line), flush=True)
    if not line["async_fast_silos_done_sim_s"] < line["sync_end_sim_s"]:
        fail("sync vs async: the fast silos did not finish before Sync")
    return line


# --------------------------------------------------------------------------- #
# Phase 5b: the edge tier
# --------------------------------------------------------------------------- #

# paper Table 6 configuration C4 (``benchmarks/table6_edge.py``: ``fed``,
# ``_edge_specs`` and ``_run_hierarchical``): 3 silos, each an EdgeFleet of
# 20 clients at participation 0.5, NIID alpha 0.5, 4 Sync rounds, seed 2
C4_ROUNDS = 4
C4_TRAIN_DELAYS = (1.2, 0.3, 0.0)
EDGE_KEYS = ("edge_participants", "edge_trained", "edge_skipped",
             "edge_bytes", "edge_sim_s")


def c4_experiment(device: str, rounds: int = C4_ROUNDS):
    """C4 built on ``device``, every silo at time_scale 0 (host compute
    stays off the simulated clock, so the card and the CPU see one)."""
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import SiloSpec, build_image_experiment
    from repro_torch.core.orchestrator import SiloPolicy
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=rounds,
                    local_epochs=1, mode="sync", scorer="accuracy",
                    agg_policy="top_k", score_policy="median",
                    edge_per_silo=20, edge_participation=0.5, edge_epochs=1)
    specs = [SiloSpec(policy=SiloPolicy("top_k", "mean", 2),
                      extra_train_delay=d, extra_score_delay=d / 2 + 0.2)
             for d in C4_TRAIN_DELAYS]
    orch = build_image_experiment(
        get_config("paper-cnn"), fed, partition="niid", alpha=0.5,
        n_train=1200, n_test=400, batch_size=8, silo_specs=specs, seed=2,
        device=device)
    for s in orch.silos:
        s.time_scale = 0.0
    return orch


def edge_summary(orch, ge) -> dict:
    return {"picks": [[p["owners"] for p in s.pick_log] for s in orch.silos],
            "ledger_height": orch.ledger.height,
            "edge": [[[m[k] for k in EDGE_KEYS] for m in s.metrics]
                     for s in orch.silos],
            "global_accuracy": {k: v["accuracy"] for k, v in ge.items()}}


def sync_edge_phase(tree) -> dict:
    """``sync-edge``: C4 on the card with the launch counts set to 0 just
    before it, then the same run on the CPU: equal picks, ledger height and
    every round's edge participants, trained and skipped clients, bytes and
    simulated seconds; global accuracy within ACC_TOL; ``weighted_sum``
    launched once a silo and round (``fedavg_up``) and no other kernel."""
    from repro_torch.core.builder import global_eval
    from repro_torch.kernels import _build
    orch = c4_experiment("cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    orch.run(C4_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    summ = edge_summary(orch, global_eval(orch))
    line = {"phase": "sync-edge", "config": "paper Table 6 C4",
            "rounds": C4_ROUNDS, "wall_s": wall,
            "wall_s_per_round": wall / C4_ROUNDS, "launches": launches,
            "edge_keys": EDGE_KEYS, **summ,
            "skipped_empty": [s.cluster.edge_fleet.stats["skipped_empty"]
                              for s in orch.silos],
            "sim_end_s": orch.env.now}
    print(json.dumps(line), flush=True)
    if not orch.ledger.verify() or any(s.rounds_done != C4_ROUNDS
                                       for s in orch.silos):
        fail("sync-edge: ledger or rounds")
    for s in orch.silos:
        if any(t.device.type != "cuda" for t in tree.leaves(s.cluster.params)):
            fail(f"sync-edge, {s.silo_id}: params left the card")
    fedavg_ups = sum(1 for s in orch.silos for m in s.metrics
                     if m["edge_trained"] > 0)
    others = {k: v for k, v in launches.items() if k != "weighted_sum" and v}
    if fedavg_ups != 3 * C4_ROUNDS or launches["weighted_sum"] != fedavg_ups \
            or others:
        fail(f"sync-edge: weighted_sum launched {launches['weighted_sum']} "
             f"times for {fedavg_ups} fedavg_up calls (want one a silo and "
             f"round, {3 * C4_ROUNDS}); other kernels {others}")
    cpu = c4_experiment("cpu")
    t0 = time.perf_counter()
    cpu.run(C4_ROUNDS)
    ref = edge_summary(cpu, global_eval(cpu))
    print(json.dumps({"phase": "sync-edge-cross-check-cpu",
                      "cpu_wall_s": time.perf_counter() - t0,
                      "equal": {k: summ[k] == ref[k] for k in
                                ("picks", "ledger_height", "edge")},
                      "cpu_global_accuracy": ref["global_accuracy"]}),
          flush=True)
    for k in ("picks", "ledger_height", "edge"):
        if summ[k] != ref[k]:
            fail(f"sync-edge: {k} {summ[k]} on the card, {ref[k]} on the CPU")
    if not any(p for ps in summ["picks"] for p in ps):
        fail("sync-edge: no silo merged a peer")
    for sid, v in summ["global_accuracy"].items():
        if abs(v - ref["global_accuracy"][sid]) > ACC_TOL:
            fail(f"sync-edge, {sid}: global accuracy {v} on the card vs "
                 f"{ref['global_accuracy'][sid]} on the CPU")
    return {"launches": launches, "wall_s": wall}


def profile_edge_round() -> dict:
    """One C4 round on the card under ``torch.profiler``: the device's busy
    share of its wall time and the kernels that fill it. Its launches are
    not counted toward the path."""
    from torch.profiler import ProfilerActivity, profile
    orch = c4_experiment("cuda", rounds=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        orch.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    ws = [e for e in kern if "::weighted_sum_kernel" in e.key]
    return {"phase": "profile-sync-edge", "config": "paper Table 6 C4",
            "rounds": 1, "wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_kernels": len(kern),
            "device_launches": sum(e.count for e in kern),
            "weighted_sum_kernel": {
                "count": sum(e.count for e in ws),
                "ms": sum(e.self_device_time_total for e in ws) / 1e3},
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def sync_edge_light() -> dict:
    """``sync-edge-light``: the reference test's three-tier topology
    (``tests/test_edge.py::test_three_tier_sync_run_with_light_clients``)
    on the card with the launch counts set to 0 just before it: 3 silos, 2
    Sync rounds, 12 edge clients a silo at participation 0.25, light
    clients over ``wan-heterogeneous``, time_scale 0; held to that test's
    invariants."""
    from repro_torch.config import FedConfig, NetConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    from repro_torch.kernels import _build
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=2, local_epochs=1,
                    mode="sync", scorer="accuracy", agg_policy="all",
                    score_policy="median", edge_per_silo=12,
                    edge_participation=0.25, edge_light_clients=True,
                    net=NetConfig(preset="wan-heterogeneous"))
    orch = build_image_experiment(get_config("paper-cnn"), fed, n_train=400,
                                  n_test=100, batch_size=4, seed=0,
                                  device="cuda")
    for s in orch.silos:
        s.time_scale = 0.0
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    orch.run(2)
    orch.env.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hub = orch.light_sync
    vs = hub.light_vs_full()
    line = {"phase": "sync-edge-light", "rounds": 2, "wall_s": wall,
            "launches": _build.launch_counts(),
            "light_clients": len(hub.clients), "light": dict(hub.stats),
            "light_vs_full": vs,
            "edge_bytes": orch.fabric.stats["edge_bytes"],
            "light_bytes": orch.fabric.stats["light_bytes"],
            "rounds_done": [s.rounds_done for s in orch.silos],
            "converged": orch.chain.converged()}
    print(json.dumps(line), flush=True)
    ok = (len(hub.clients) == 36 and hub.stats["proofs_verified"] > 0
          and hub.stats["proofs_failed"] == 0
          and hub.stats["headers_rejected"] == 0
          and 0 < vs["light_bytes"] < vs["full_replay_bytes"]
          and vs["ratio"] <= 0.10 and line["edge_bytes"] > 0
          and line["light_bytes"] > 0 and line["rounds_done"] == [2, 2, 2]
          and all("edge_participants" in m for s in orch.silos
                  for m in s.metrics)
          and line["launches"]["weighted_sum"] > 0)
    if not ok:
        fail(f"sync-edge-light: the reference test's invariants: {line}")
    return line


def hbfl_phase() -> dict:
    """``hbfl``: ``run_hbfl`` and ``run_no_collab`` over C4's clusters for
    2 rounds, each with the launch counts set to 0 just before it, on the
    card and on the CPU: the same history shapes, every evaluation's
    accuracy within ACC_TOL of the CPU's, and ``weighted_sum`` once a silo
    and round (the edge FedAvg up) plus once a round for the trusted
    aggregator in ``run_hbfl``."""
    from repro_torch.fed.hbfl import run_hbfl, run_no_collab
    from repro_torch.kernels import _build
    out = {}
    for name, fn, want in (("hbfl", run_hbfl, 2 * (3 + 1)),
                           ("no-collab", run_no_collab, 2 * 3)):
        runs = {}
        for device in ("cuda", "cpu"):
            clusters = [s.cluster for s in c4_experiment(device).silos]
            if device == "cuda":
                torch.cuda.synchronize()
                _build.reset_launches()
            t0 = time.perf_counter()
            res = fn(clusters, 2)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = _build.launch_counts()
            runs[device] = (res, time.perf_counter() - t0)
        (res, wall), (ref, cpu_wall) = runs["cuda"], runs["cpu"]
        acc = [{k: {sid: ev["accuracy"] for sid, ev in h[k].items()}
                for k in h if k != "round"} for h in res["history"]]
        acc_cpu = [{k: {sid: ev["accuracy"] for sid, ev in h[k].items()}
                    for k in h if k != "round"} for h in ref["history"]]
        line = {"phase": name, "rounds": 2, "wall_s": wall,
                "cpu_wall_s": cpu_wall, "launches": launches,
                "keys": sorted(res), "accuracy": acc, "cpu_accuracy": acc_cpu}
        print(json.dumps(line), flush=True)
        if sorted(res) != sorted(ref) or [sorted(h) for h in res["history"]] \
                != [sorted(h) for h in ref["history"]]:
            fail(f"{name}: history shape differs from the CPU run")
        for a, b in zip(acc, acc_cpu):
            for k in a:
                for sid in a[k]:
                    if abs(a[k][sid] - b[k][sid]) > ACC_TOL:
                        fail(f"{name} {k} {sid}: accuracy {a[k][sid]} on the "
                             f"card vs {b[k][sid]} on the CPU")
        others = {k: v for k, v in launches.items()
                  if k != "weighted_sum" and v}
        if launches["weighted_sum"] != want or others:
            fail(f"{name}: launches {launches}, want weighted_sum {want}")
        out[name] = line
    return out


# --------------------------------------------------------------------------- #
# Phase 6: serving RWKV-6 1.6B
# --------------------------------------------------------------------------- #

def request_inputs(cfg, batch: int, prompt_len: int, g, device="cuda"):
    """Prompts [batch, prompt_len] and, for an encoder-decoder, the stub
    frames [batch, prompt_len // 4, d_model] its encoder reads (None
    otherwise), drawn from ``g``."""
    from repro_torch.models.encdec import src_len
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=device)
    if cfg.family != "encdec":
        return prompts, None
    return prompts, torch.randn((batch, src_len(prompt_len), cfg.d_model),
                                generator=g, device=device)


def serve_request(model, params, batch: int, prompt_len: int, gen: int,
                  seed: int) -> dict:
    """One batched request through ``serve`` with the launch counts set to
    0 just before it; its timings, peak memory and kernel launches: RWKV-6
    launches ``wkv6`` once a layer a prefill and nothing else, every other
    family none of the nine kernels."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    g = torch.Generator(device="cuda").manual_seed(seed)
    prompts, frames = request_inputs(model.cfg, batch, prompt_len, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    res = serve(model, params, prompts, gen, "cuda", frames)
    launches = _build.launch_counts()
    arch = model.cfg.arch_id
    want = {k: 0 for k in launches}
    if model.cfg.family == "ssm":
        want["wkv6"] = model.cfg.n_layers
    line = {"phase": f"serve-{arch}", "batch": batch,
            "prompt_len": prompt_len, "gen": gen,
            "prefill_ms": res["prefill_s"] * 1e3,
            "prefill_tok_s": batch * prompt_len / res["prefill_s"],
            "decode_ms_per_token": res["decode_s"] / max(1, gen - 1) * 1e3,
            "decode_tok_s": batch * (gen - 1) / max(res["decode_s"], 1e-9),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches,
            "launches_as_expected": launches == want,
            "wkv6_launches": launches["wkv6"],
            "other_launches": sum(v for k, v in launches.items()
                                  if k != "wkv6"),
            "finite": res["finite"], "ids_head": res["ids"][0, :8].tolist(),
            "device": torch.cuda.get_device_name(0)}
    if model.cfg.family != "ssm":
        line["note"] = (f"no TPU kernel stands behind the "
                        f"{model.cfg.family} family: none of the nine "
                        "ported kernels runs on this path")
    print(json.dumps(line), flush=True)
    if not res["finite"]:
        fail(f"serve {arch} {batch}x{prompt_len}: non-finite logits")
    if launches != want:
        fail(f"serve {arch} {batch}x{prompt_len}: launches {launches}, want "
             f"{want} (RWKV-6: wkv6 once a layer, one prefill, none from "
             "decode steps)")
    return line


def serve_cli(arch: str) -> dict:
    """The user's entry point, ``python -m repro_torch.launch.serve --arch
    ARCH --preset full`` (its own seeded init on the card), 4 x 64 + 4,
    with the launch counts set to 0 just before it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import main as serve_main
    cfg = get_config(arch)
    want_wkv6 = cfg.n_layers if cfg.family == "ssm" else 0
    _build.reset_launches()
    ids = serve_main(["--arch", arch, "--preset", "full", "--batch",
                      "4", "--prompt-len", "64", "--gen", "4"])
    line = {"phase": f"serve-cli-{arch}", "ids_shape": list(ids.shape),
            "launches": _build.launch_counts()}
    print(json.dumps(line), flush=True)
    torch.cuda.empty_cache()
    if ids.shape != (4, 4) or line["launches"]["wkv6"] != want_wkv6 or sum(
            v for k, v in line["launches"].items() if k != "wkv6"):
        fail(f"serve CLI {arch}: ids {ids.shape}, launches "
             f"{line['launches']}")
    return line


def cross_check_serving_on_cpu(steps: int = 8) -> dict:
    """The full width at depth 2, bf16, params drawn on the card and copied
    to the CPU, 4 x 64 prompts: prefill logits and state, then ``steps``
    decode steps fed the card's greedy tokens, on the card and on the CPU
    (the plain versions). Tolerance per output: twice the CPU's own bf16
    rounding error, i.e. of how far its bf16 result lies from a float32
    evaluation of the same weights on the CPU (and at least one bf16 ulp
    of the largest magnitude): a card as close to float32 as the CPU lies
    within that of it."""
    from repro_torch.config import replace
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg = replace(get_config(SERVE_ARCH), n_layers=2)
    cfg32 = replace(cfg, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = model.init(g, "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                            device="cuda")

    def run(m, p, dev, feed=None):
        """Prefill, then ``steps`` decode steps fed ``feed`` (None: the
        run's own greedy picks). Returns the outputs and the fed tokens."""
        outs, fed = [], []
        with torch.inference_mode():
            logits, st = m.prefill(p, {"tokens": prompts.to(dev)})
            outs += [logits[:, -1], st["wkv"], st["tm_x"], st["cm_x"]]
            tok = torch.argmax(logits[:, -1], dim=-1)
            for i in range(steps):
                tok = tok if feed is None else feed[i].to(dev)
                fed.append(tok)
                logits, st = m.decode_step(p, {"token": tok, "pos": 64 + i},
                                           st)
                outs += [logits, st["wkv"]]
                tok = torch.argmax(logits, dim=-1)
        return [o.float().cpu() for o in outs], fed

    card, feed = run(model, params, "cuda")
    host = tree_map(lambda t: t.cpu(), params)
    cpu, _ = run(model, host, "cpu", feed)
    cpu32, _ = run(build_model(cfg32), tree_map(lambda t: t.float(), host),
                   "cpu", feed)
    worst = 0.0
    for i, (a, b, c) in enumerate(zip(card, cpu, cpu32)):
        top = float(b.abs().max())
        tol = max(2.0 * float((b - c).abs().max()), BF16_ULP * top)
        err = float((a - b).abs().max())
        worst = max(worst, err / tol)
        if not err <= tol:
            fail(f"serving cross-check output {i}: card vs CPU {err}, "
                 f"tol {tol} (CPU bf16 vs f32 {float((b - c).abs().max())})")
    line = {"phase": "serve-cross-check-cpu", "arch": SERVE_ARCH,
            "n_layers": 2, "batch": 4, "prompt_len": 64, "decode_steps":
            steps, "outputs": len(card),
            "prefill_logits_err": float((card[0] - cpu[0]).abs().max()),
            "prefill_logits_max": float(cpu[0].abs().max()),
            "prefill_logits_tol": max(
                2.0 * float((cpu[0] - cpu32[0]).abs().max()),
                BF16_ULP * float(cpu[0].abs().max())),
            "worst_err_of_tol": worst,
            "tol": "2 x max|cpu_bf16 - cpu_f32| (>= 2^-7 max|cpu_bf16|), "
                   "per output"}
    print(json.dumps(line), flush=True)
    return line


def init_full_width(arch: str, want=None):
    """Build ``arch`` at its published widths and draw its params on the
    card from a seeded generator; print the count and bytes and fail
    unless they are ``want``'s (params, bytes)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config(arch))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    print(json.dumps({"phase": f"init-{arch}", "family": model.cfg.family,
                      "params": n_params, "bytes": n_bytes,
                      "init_s": time.perf_counter() - t0}), flush=True)
    if want is not None and (n_params, n_bytes) != want:
        fail(f"{arch}: {n_params} params, {n_bytes} bytes, want {want}")
    return model, params


def combine_determinism(model, params) -> dict:
    """Two prefills of the same 4 x 64 prompts give the same logits bit for
    bit: the MoE combine sums each token's experts in a fixed order, with
    no atomics."""
    g = torch.Generator(device="cuda").manual_seed(3)
    prompts, _ = request_inputs(model.cfg, 4, 64, g)
    with torch.inference_mode():
        a, _ = model.prefill(params, {"tokens": prompts})
        b, _ = model.prefill(params, {"tokens": prompts})
    line = {"phase": f"serve-determinism-{model.cfg.arch_id}",
            "batch": 4, "prompt_len": 64, "bit_identical": bool(
                torch.equal(a, b)),
            "max_abs_diff": float((a.float() - b.float()).abs().max())}
    print(json.dumps(line), flush=True)
    if not line["bit_identical"]:
        fail(f"{model.cfg.arch_id}: two prefills of the same prompts "
             f"differ by {line['max_abs_diff']}")
    return line


def cross_check_family_on_cpu(arch: str, steps: int = 8) -> dict:
    """``arch``'s full width at the depth of FAMILY_CHECK_DEPTH, float32
    with TF32 off, params drawn on the card and copied to the CPU, 4 x 64
    prompts (and stub frames for an encoder-decoder): prefill logits and
    the whole cache, then the cache padded to 64 + ``steps`` as ``serve``
    pads it and ``steps`` decode steps fed the card's greedy tokens (logits
    each step, the whole cache after the last), on the card and on the CPU
    (both plain PyTorch). A MoE's routing (each call's top-k expert ids)
    is compared first and exactly: where it differs, the smallest gap
    between the k-th and the (k+1)-th probability is printed. Tolerance:
    DECODER_REL of each output's largest magnitude: float32 sums of
    thousands of terms in another order (cuBLAS against the CPU's BLAS)
    through a few layers; the CPU tests hold the port to 1e-5 of it
    against the reference."""
    from repro_torch.config import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import build_model
    from repro_torch.models import moe
    from repro_torch.tree import leaves, tree_map
    if torch.backends.cuda.matmul.allow_tf32:
        fail(f"{arch} cross-check: TF32 is on")
    cfg = replace(get_config(arch), **FAMILY_CHECK_DEPTH[arch],
                  param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = model.init(g, "cuda")
    prompts, frames = request_inputs(cfg, 4, 64, g)

    def run(p, dev, feed=None):
        """Outputs, fed tokens and routing: (top-k ids, the least gap
        between the k-th and the (k+1)-th probability) a MoE call."""
        outs, fed, routes = [], [], []
        route = moe._route

        def rec(router_w, x2d, c):
            out = route(router_w, x2d, c)
            probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            k = c.moe.top_k
            routes.append((out[1].cpu(),
                           float((top[:, k - 1] - top[:, k]).min())))
            return out

        batch = {"tokens": prompts.to(dev)}
        if frames is not None:
            batch["frames"] = frames.to(dev)
        moe._route = rec
        try:
            with torch.inference_mode():
                logits, cache = model.prefill(p, batch)
                outs += [logits, *[t.clone() for t in leaves(cache)]]
                cache = pad_cache(model.init_cache(4, 64 + steps, dev),
                                  cache)
                tok = torch.argmax(logits[:, -1], dim=-1)
                for i in range(steps):
                    tok = tok if feed is None else feed[i].to(dev)
                    fed.append(tok)
                    logits, cache = model.decode_step(
                        p, {"token": tok, "pos": 64 + i}, cache)
                    outs.append(logits)
                    tok = torch.argmax(logits, dim=-1)
                outs += leaves(cache)
        finally:
            moe._route = route
        return [o.float().cpu() for o in outs], fed, routes

    card, feed, card_routes = run(params, "cuda")
    cpu, _, cpu_routes = run(tree_map(lambda t: t.cpu(), params), "cpu",
                             feed)
    if len(card_routes) != len(cpu_routes) or any(
            not torch.equal(a[0], b[0])
            for a, b in zip(card_routes, cpu_routes)):
        fail(f"{arch} cross-check: the card routes otherwise than the CPU; "
             "least gap between the k-th and (k+1)-th probability: "
             f"{min((r[1] for r in cpu_routes), default=None)}")
    worst, errs = 0.0, []
    for i, (a, b) in enumerate(zip(card, cpu)):
        top = float(b.abs().max())
        err = float((a - b).abs().max())
        errs.append(err / top if top else err)
        worst = max(worst, errs[-1] / DECODER_REL)
        if not (torch.isfinite(a).all() and err <= DECODER_REL * top):
            fail(f"{arch} cross-check output {i}: card vs CPU {err}, "
                 f"tol {DECODER_REL * top}")
    line = {"phase": f"serve-cross-check-cpu-{arch}",
            "family": cfg.family, **FAMILY_CHECK_DEPTH[arch],
            "dtype": "float32", "tf32": False, "batch": 4, "prompt_len": 64,
            "decode_steps": steps, "outputs": len(card),
            "outputs_are": "prefill logits and cache leaves (sorted keys); "
                           "logits a step; cache leaves after the last",
            "moe_route_calls": len(card_routes),
            "routing_equal": True,
            "least_topk_gap": min((r[1] for r in cpu_routes), default=None),
            "err_of_max": errs, "worst_err_of_tol": worst,
            "tol": f"{DECODER_REL} x max|cpu|, per output"}
    print(json.dumps(line), flush=True)
    return line


def serve_family(arch: str) -> None:
    """Phase 6 for one attention LM family: init at full width, its
    requests, (MoE) the combine's determinism, a profiled request, the
    params freed, the CLI, then the float32 check at reduced depth."""
    from repro_torch.launch.serve import serve
    model, params = init_full_width(arch, FAMILY_PARAMS[arch])
    prompts, frames = request_inputs(model.cfg, 4, 64, torch.Generator(
        device="cuda").manual_seed(4))
    serve(model, params, prompts, 2, "cuda", frames)           # warm-up
    for i, (b, s, gen) in enumerate(FAMILY_REQUESTS[arch]):
        serve_request(model, params, b, s, gen, seed=30 + i)
    if model.cfg.family == "moe":
        combine_determinism(model, params)
    print(json.dumps(profile_serving(model, params)), flush=True)
    del params
    torch.cuda.empty_cache()
    serve_cli(arch)
    cross_check_family_on_cpu(arch)
    torch.cuda.empty_cache()


def profile_serving(model, params) -> dict:
    """One 4 x 64 + 8 request on the card under ``torch.profiler``: the
    device's busy share of the request's wall time and the kernels that
    fill it. Its launches are not counted toward the main path."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts, frames = request_inputs(model.cfg, 4, 64, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = serve(model, params, prompts, 8, "cuda", frames)
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    wkv = [e for e in kern if "wkv6_kernel" in e.key]
    return {"phase": f"profile-serve-{model.cfg.arch_id}", "batch": 4,
            "prompt_len": 64, "gen": 8, "wall_s": wall,
            "prefill_ms": res["prefill_s"] * 1e3,
            "decode_ms_per_token": res["decode_s"] / 7 * 1e3,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_kernels": len(kern),
            "device_launches": sum(e.count for e in kern),
            "wkv6_kernel": {"count": sum(e.count for e in wkv),
                            "ms": sum(e.self_device_time_total
                                      for e in wkv) / 1e3},
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import tree
    from repro_torch.kernels import _build

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} x{torch.cuda.device_count()}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 3: kernels against their plain versions, two shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    host_path()
    before = launch_rate()
    main_rows = check_kernels("main", gen, iters=200)
    finish_rows(check_kernels("large", gen, iters=5))
    wkv6_rows = [check_wkv6("main", gen, iters=200),
                 check_wkv6("long", gen, iters=50)]
    finish_rows([check_wkv6("large", gen, iters=20)])
    # every CUDA-event timing is done: now the profiles
    finish_rows(main_rows + wkv6_rows)
    main_rows.append(wkv6_rows[0])
    reconstruct_line()
    print(json.dumps({"phase": "launch-rate", "before_profiler": before,
                      "after_profiler": launch_rate()}), flush=True)

    # phase 4: the main path, int8 (every kernel) then uncompressed
    _build.reset_launches()
    orch, ge, wall = run_experiment("int8", 2, "cuda")
    launches = _build.launch_counts()
    print(json.dumps({"phase": "sync-int8", "rounds": 2, "wall_s": wall,
                      "ledger_height": orch.ledger.height,
                      "launches": launches,
                      "global_accuracy": {k: v["accuracy"]
                                          for k, v in ge.items()}}),
          flush=True)
    if not orch.ledger.verify():
        fail("int8 run: ledger does not verify")
    for s in orch.silos:
        if any(t.device.type != "cuda" for t in tree.leaves(s.cluster.params)):
            fail(f"{s.silo_id}: params left the card")
    missing = [k for k in ("weighted_sum", "quantize", "dequantize", "wsum_q8")
               if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    check_against_cpu("int8", orch, ge, run_experiment("int8", 2, "cpu"))

    _build.reset_launches()
    orch_n, ge_n, wall_n = run_experiment("none", 1, "cuda")
    launches_n = _build.launch_counts()
    print(json.dumps({"phase": "sync-none", "rounds": 1, "wall_s": wall_n,
                      "ledger_height": orch_n.ledger.height,
                      "launches": launches_n,
                      "global_accuracy": {k: v["accuracy"]
                                          for k, v in ge_n.items()}}),
          flush=True)
    if not orch_n.ledger.verify() or launches_n["weighted_sum"] == 0:
        fail("uncompressed run: ledger or FedAvg kernel")

    # int8-delta with MultiKRUM: round 1 ships whole int8 (gram_q8), later
    # rounds int8 deltas (add_q8_delta rebuilds them, gram_and_norms scores)
    _build.reset_launches()
    orch_d, ge_d, wall_d = run_experiment("int8-delta", 3, "cuda", "multikrum")
    launches_d = _build.launch_counts()
    print(json.dumps({"phase": "sync-int8-delta-multikrum", "rounds": 3,
                      "wall_s": wall_d, "ledger_height": orch_d.ledger.height,
                      "launches": launches_d,
                      "global_accuracy": {k: v["accuracy"]
                                          for k, v in ge_d.items()}}),
          flush=True)
    if not orch_d.ledger.verify():
        fail("int8-delta multikrum run: ledger does not verify")
    missing = [k for k in ("add_q8_delta", "gram_q8", "gram_and_norms")
               if launches_d[k] == 0]
    if missing:
        fail(f"int8-delta multikrum run never launched {missing}")
    check_against_cpu("int8-delta multikrum", orch_d, ge_d,
                      run_experiment("int8-delta", 3, "cpu", "multikrum"))

    print(json.dumps(profile_rounds("int8", "accuracy", 1)), flush=True)
    print(json.dumps(profile_rounds("int8-delta", "multikrum", 2)), flush=True)

    # phase 5: the Async engine and the WAN fabric
    async_wan = async_wan_phase(tree)
    print(json.dumps(profile_async_wan()), flush=True)
    krum_wan = sync_multikrum_wan()
    sync_vs_async_straggler()

    # phase 5b: the edge tier (paper Table 6 C4, light clients, HBFL)
    edge = sync_edge_phase(tree)
    print(json.dumps(profile_edge_round()), flush=True)
    sync_edge_light()
    hbfl_phase()

    # phase 6: serve RWKV-6 1.6B at full width, then the depth-2 CPU check
    from repro_torch.core.builder import resolve_device
    from repro_torch.launch.serve import serve
    resolve_device("cuda")
    model, params = init_full_width(SERVE_ARCH)
    serve(model, params, torch.zeros((4, 64), dtype=torch.long,
                                     device="cuda"), 2, "cuda")   # warm-up
    serving = [serve_request(model, params, 4, 64, 32, seed=10),
               serve_request(model, params, 4, 1000, 8, seed=11)]
    print(json.dumps({"phase": "serve-prefill-vs-earlier", "prefill_ms": {
        "4x64": serving[0]["prefill_ms"], "4x1000": serving[1]["prefill_ms"]},
        "earlier_ms": PREFILL_EARLIER_MS,
        "earlier": "the token-serial wkv6 kernel, NVIDIA H100 80GB HBM3, "
                   "700.00 W, chip_smoke.py"}), flush=True)
    print(json.dumps(profile_serving(model, params)), flush=True)
    serve_cli(SERVE_ARCH)
    del params
    torch.cuda.empty_cache()
    cross_check_serving_on_cpu()

    # phase 6, continued: the dense decoder, the MoE, the RG-LRU hybrid and
    # the encoder-decoder at full width, one after the other
    for arch in FAMILY_PARAMS:
        serve_family(arch)

    # phase 7: the kernels line and the result line
    # row name -> (the kernels line's name, source, the TPU kernel, the
    # wrapper whose launches count it)
    meta = {
        "weighted_sum": ("weighted_sum", "src/repro_torch/kernels/csrc/wsum.cu",
                         "src/repro/kernels/wsum.py:27", "weighted_sum"),
        "quantize": ("quantize", "src/repro_torch/kernels/csrc/quant.cu",
                     "src/repro/kernels/quant.py:34", "quantize"),
        "dequantize_k1": ("dequantize",
                          "src/repro_torch/kernels/csrc/quant.cu",
                          "src/repro/kernels/quant.py:79", "dequantize"),
        "dequantize": ("dequantize_batch",
                       "src/repro_torch/kernels/csrc/quant.cu",
                       "src/repro/kernels/quant.py:55", "dequantize"),
        "wsum_q8": ("wsum_q8", "src/repro_torch/kernels/csrc/q8agg.cu",
                    "src/repro/kernels/q8agg.py:51", "wsum_q8"),
        "add_q8_delta": ("add_q8_delta",
                         "src/repro_torch/kernels/csrc/q8agg.cu",
                         "src/repro/kernels/q8agg.py:77", "add_q8_delta"),
        "gram_q8": ("gram_q8", "src/repro_torch/kernels/csrc/q8agg.cu",
                    "src/repro/kernels/q8agg.py:122", "gram_q8"),
        "gram_and_norms": ("gram_and_norms",
                           "src/repro_torch/kernels/csrc/multikrum.cu",
                           "src/repro/kernels/multikrum.py:40",
                           "gram_and_norms"),
        "wkv6": ("wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
                 "src/repro/kernels/rwkv6.py:68", "wkv6"),
    }
    # each kernel's launches on the main path that runs it; dequantize and
    # dequantize_batch are one kernel behind one wrapper, one count
    path_launches = {k: launches[k] for k in
                     ("weighted_sum", "quantize", "dequantize", "wsum_q8")}
    path_launches.update({k: launches_d[k] for k in
                          ("add_q8_delta", "gram_q8", "gram_and_norms")})
    path_launches["wkv6"] = sum(r["wkv6_launches"] for r in serving)
    kernels = []
    for r in main_rows:
        # other rows: not the operand the main path hands the kernel
        if r["name"] not in meta or not r["path"]:
            continue
        name, src, replaces, counter = meta[r["name"]]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": path_launches[counter],
                        "launches_counter": counter,
                        "launches_async_wan":
                            async_wan["launches"][counter],
                        "launches_multikrum_wan":
                            krum_wan["launches"][counter],
                        "launches_edge": edge["launches"][counter],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        **({"bound_tc_ms": r["bound_tc_ms"]}
                           if "bound_tc_ms" in r else {}),
                        "library_ms": r["library_ms"],
                        "n": r.get("n", r.get("N")),
                        "library_n": r.get("library_n"),
                        "check": r["check"]})
    if len(kernels) != 9:
        fail(f"the kernels line lists {len(kernels)} kernels, want 9")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
