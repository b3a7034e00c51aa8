"""Drive the PyTorch/CUDA port on one GPU and hold every kernel against its
plain PyTorch version.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

  1. resolve the card and print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. check each kernel against its plain version on the card, at the main
     path's shapes (paper CNN: N = 62,006 padded, M or K = 2) and at a large
     shape (N = 2^28; M = 4 for f32, 8 for int8, so M*N >= 2^31), and time
     both (CUDA events, warm, averaged) beside the memory bound;
  4. run a 2-round Sync UnifyFL experiment of the paper CNN with int8
     compression on the card (the main path), then a 1-round uncompressed
     one, each with the launch counts set to 0 just before it; check the
     ledger, that every param lives on the card, that every kernel of the
     path launched, and that the int8 run agrees with the same run on the
     CPU (the plain versions); then profile one more round (device busy
     share, top kernels by device time);
  5. print the ``kernels`` JSON line, then the result line.

The card's peak memory rate is the published H100 SXM figure; a card capped
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
MAIN_N = 62_006                # paper-cnn params (configs/paper_cnn.py)
LARGE_N = 1 << 28
ACC_TOL = 0.05                 # global accuracy, card vs CPU (see phase 4)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` on the card over ``iters`` warm calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_kernels(shape: str, gen, iters: int):
    from repro_torch.kernels import q8agg, quant, ref, wsum
    from repro_torch.kernels import ops
    large = shape == "large"
    rows = []

    def row(name, max_err, ms, plain_ms, nbytes, flops=0.0, library_ms=None,
            check="bit-exact", **dims):
        b_ms, b_by = bound(nbytes, flops)
        rows.append({"name": name, "shape": shape, **dims,
                     "max_abs_err": max_err, "check": check, "kernel_ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "device": torch.cuda.get_device_name(0)})
        print(json.dumps(rows[-1]), flush=True)

    # weighted_sum: intra-silo FedAvg of M clients (f32), N padded to 4096
    M = 4 if large else 2
    N = LARGE_N if large else MAIN_N + (-MAIN_N) % wsum.TILE_N
    x = torch.randn((M, N), generator=gen, device="cuda")
    w = torch.rand((M,), generator=gen, device="cuda")
    w = w / w.sum()
    got, want = wsum.weighted_sum(x, w), ref.weighted_sum(x, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # an M-term f32 sum in another order: within M ulps of sum |w x|
    scale = float((w.abs()[:, None] * x.abs()).sum(0).max())
    if not err <= M * 2.0 ** -23 * scale:
        fail(f"weighted_sum {shape}: max_abs_err {err} (scale {scale})")
    row("weighted_sum", err, cuda_ms(lambda: wsum.weighted_sum(x, w), iters),
        cuda_ms(lambda: ref.weighted_sum(x, w), iters),
        (M + 1) * N * 4, 2.0 * M * N,
        library_ms=cuda_ms(lambda: torch.matmul(w, x), iters),
        check=f"abs err <= M*2^-23*max sum|w x| = {M * 2.0 ** -23 * scale:.3e}",
        M=M, N=N)
    del x

    # quantize: the int8 wire encode, N padded to 131072
    N = LARGE_N if large else MAIN_N + (-MAIN_N) % ops.QUANT_BLOCK
    xq = quant_input(N, gen)
    (q, s), (q0, s0) = quant.quantize(xq), ref.quantize_int8(xq)
    torch.cuda.synchronize()
    if not (torch.equal(q, q0) and torch.equal(s, s0)):
        fail(f"quantize {shape}: codes or scales differ from the plain "
             f"version ({int((q != q0).sum())} codes)")
    row("quantize", 0.0, cuda_ms(lambda: quant.quantize(xq), iters),
        cuda_ms(lambda: ref.quantize_int8(xq), iters),
        N * 4 + N + N // 1024 * 4, N=N)

    # dequantize: K payloads in one launch (scoring ingest, K=2; K=8 large)
    K = 8 if large else 2
    qk = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                       dtype=torch.int8)
    sk = torch.rand((K, N // 1024), generator=gen, device="cuda") * 0.02
    del xq, q, q0
    got, want = quant.dequantize(qk, sk), ref.dequantize_rows(qk, sk)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"dequantize {shape}: differs from the plain version")
    del got, want
    row("dequantize", 0.0, cuda_ms(lambda: quant.dequantize(qk, sk), iters),
        cuda_ms(lambda: ref.dequantize_rows(qk, sk), iters),
        K * N + K * N // 1024 * 4 + K * N * 4, K=K, N=N)
    # the K=1 entry point (wire.reconstruct, quant.py:79) runs the same kernel
    q1, s1 = qk[0], sk[0]
    if not torch.equal(quant.dequantize(q1, s1), ref.dequantize_int8(q1, s1)):
        fail(f"dequantize K=1 {shape}: differs from the plain version")
    row("dequantize_k1", 0.0, cuda_ms(lambda: quant.dequantize(q1, s1), iters),
        cuda_ms(lambda: ref.dequantize_int8(q1, s1), iters),
        N + N // 1024 * 4 + N * 4, K=1, N=N)

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
    row("wsum_q8", err, cuda_ms(lambda: q8agg.wsum_q8(qk, sk, wq), iters),
        cuda_ms(lambda: ref.wsum_q8(qk, sk, wq), iters),
        M * N + M * N // 1024 * 4 + N * 4, 2.0 * M * N,
        check=f"abs err <= M*2^-22*127*max sum w s = {M * 2.0 ** -22 * scale:.3e}",
        M=M, N=N)
    del qk, sk
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------- #
# Phase 4: the main path
# --------------------------------------------------------------------------- #

def run_experiment(compression: str, rounds: int, device: str):
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment, global_eval
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=rounds, mode="sync",
                    scorer="accuracy", agg_policy="top_k", policy_k=2,
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


def profile_round() -> dict:
    """One int8 Sync round on the card under ``torch.profiler``: the
    device's busy share of the round's wall time and the kernels that fill
    it. Its launches are not counted toward the main path."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=1, mode="sync",
                    scorer="accuracy", agg_policy="top_k", policy_k=2,
                    compression="int8")
    orch = build_image_experiment(get_config("paper-cnn"), fed,
                                  partition="niid", alpha=0.2, n_train=1500,
                                  n_test=450, seed=0, device="cuda")
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
    # device time of the ported kernels alone (their launch gaps excluded)
    ported = {}
    for name in ("weighted_sum_kernel", "quantize_kernel",
                 "dequantize_kernel", "wsum_q8_kernel"):
        hits = [e for e in kern if f"::{name}" in e.key]  # not de-quantize
        ported[name] = {"count": sum(e.count for e in hits),
                        "ms": sum(e.self_device_time_total for e in hits)
                        / 1e3}
    return {"phase": "profile-int8-round", "wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_kernels": len(kern),
            "ported_kernels": ported,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
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
    main_rows = check_kernels("main", gen, iters=200)
    check_kernels("large", gen, iters=5)

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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    # the same run on the CPU (the init is drawn on the CPU either way)
    # through the plain versions: same picks and ledger, and global accuracy
    # within ACC_TOL (450 test images; float32 sums in another order and
    # cuDNN's convolution algorithms move a few predictions, not the outcome)
    ref_orch, ref_ge, _ = run_experiment("int8", 2, "cpu")
    if [s.pick_log for s in orch.silos] != [s.pick_log for s in ref_orch.silos]:
        fail("int8 run: picks differ from the CPU run")
    if orch.ledger.height != ref_orch.ledger.height:
        fail("int8 run: ledger height differs from the CPU run")
    for sid, v in ge.items():
        a, b = v["accuracy"], ref_ge[sid]["accuracy"]
        if not (0.0 <= a <= 1.0) or abs(a - b) > ACC_TOL:
            fail(f"{sid}: global accuracy {a} on the card vs {b} on the CPU")

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

    print(json.dumps(profile_round()), flush=True)

    # phase 5: the kernels line and the result line
    meta = {
        "weighted_sum": ("src/repro_torch/kernels/csrc/wsum.cu",
                         "src/repro/kernels/wsum.py:27"),
        "quantize": ("src/repro_torch/kernels/csrc/quant.cu",
                     "src/repro/kernels/quant.py:34"),
        "dequantize": ("src/repro_torch/kernels/csrc/quant.cu",
                       "src/repro/kernels/quant.py:55"),
        "wsum_q8": ("src/repro_torch/kernels/csrc/q8agg.cu",
                    "src/repro/kernels/q8agg.py:51"),
    }
    kernels = []
    for r in main_rows:
        if r["name"] not in meta:      # dequantize_k1: same kernel, K = 1
            continue
        src, replaces = meta[r["name"]]
        kernels.append({"name": r["name"], "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "check": r["check"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
