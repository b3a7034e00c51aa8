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
     (neither pads or slices: the kernels take the caller's tensors and
     write the wire padding, or only the n columns kept, themselves); then, all
     timings done, each main-shape row's device time a launch from
     ``torch.profiler`` (which leaves a cost on every later launch: the
     ``launch-rate`` line times the int8 ops calls before the first
     profiler session and after the last); before it all, the host-path
     line (host microseconds a call, the kernel bindings compared), and
     after it an int8-delta ``reconstruct`` at the main shape; the
     ``wkv6_backward`` kernel against its plain reverse scan
     (``ref.wkv6_backward_naive``), all six gradients, at the training
     shape (B 8, T 128, H 32, hs 64, bf16 r/k/v, with and without a final
     state's gradient), a ragged long one (B 4, T 1000), the smoke head
     size (B 2, T 70, H 4, hs 16) and decays of exactly 0, 1 and 1e-30,
     timed beside its bound;
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
     ``add_q8_delta`` and ``weighted_sum`` launched, ``wsum_q8`` once for
     each int8 peer group the run's merges received: a peer rebuilt from a
     delta merges as float32), the same run twice more on the card, as it
     ran and with cuDNN's deterministic algorithms (whether picks and CIDs
     repeat), the same run on the CPU (rounds and recovery equal; picks,
     heights and bytes printed beside it: CIDs reach the chain's hash
     tie-breaks), the same Async run without the fabric on both (picks,
     height and submission times equal, accuracy within ACC_TOL,
     ``wsum_q8`` launched once an int8 peer group), a profiled Async WAN
     run;
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
  7. federated LM training, ``lm-train-qwen3-1.7b``: 2 Sync rounds of 3
     silos x 2 clients of ``qwen3-1.7b`` at full width and half its depth
     (LM_DEPTH: 14 of 28 layers; a bf16 init from
     a seeded generator on the card, float32 after the first SGD step as
     in the reference; every silo at time_scale 0; int8 wire, loss
     scoring, top-2; seq
     128, batch 8, 8 steps an epoch, streams of 60,000 tokens at a data
     vocabulary of 4,096), with the launch counts set to 0 just before:
     round walls, round 2 profiled (idle share, top device operations),
     eval losses finite and falling, ledger, peak memory within
     LM_MEM_MARGIN of its reckoning, with the allocator's recorded trace
     replayed to the peak (``memory_at_peak``: the live bytes by part and
     by site); the same run at the smoke preset in float32 on the card
     and on the CPU (picks, height, losses within LM_LOSS_TOL, each silo's
     parameters within LM_PARAM_RTOL; run in phase 9, while the dry runs
     take the host); the CLI
     once. Before it all, in phase 3, the five kernels of this path at
     the width of ``qwen3-1.7b`` (N = 1,723,982,848: ``check_model_width``).
     Then ``lm-train-rwkv6-1.6b``, the same run of ``rwkv6-1.6b`` at full
     width and 12 of its 24 layers through the ``wkv6`` and ``wkv6_backward`` kernels, with its
     own rate (RWKV6_LR) and gates: after round 1 every time-mix leaf of
     every silo moved, and ``wkv6`` / ``wkv6_backward`` launched once a
     layer a forward / backward pass; eval losses finite (their change
     printed). Before it, one full-width client step held against the
     plain scan (``rwkv6_step_check``): at 24 layers in bf16 every
     ``wkv6`` and ``wkv6_backward`` call of the step against its plain
     version on the very operands the step hands it, and the whole
     step's gradients, kernel path against plain path, at the depths of
     RWKV6_STEP_TOL. After it, one client step's gradients at its smoke
     preset in float32, card against CPU, within GRAD_REL; the
     smoke-preset run on both (picks, height, losses after round 1 within
     its LM_LOSS_TOL; in phase 9 too); its CLI once;
  8. the multi-pod UnifyFL round step (``repro_torch.core.exchange``):
     two pods of ``qwen3-1.7b`` at full width stacked on the card, each its
     own seeded init and a batch of 4 x 512 tokens, one round step at lr
     0.1 in each configuration of the reference's test (``all``, ``top_k``
     k = 1, the same with int8, ``above_average`` with MultiKRUM), the
     launch counts set to 0 just before each: ``all`` equal to the mean of
     the pods trained apart to one bf16 ulp, no kernel launched; a scored
     round's merge ``weighted_sum`` once a leaf and pod, every merged leaf
     bit for bit its ordered FMA chain, W rows summing to 1; int8 within
     0.05 of the uncompressed round; MultiKRUM finite; peak memory beside
     its reckoning; ``weighted_sum`` timed at the merge's operand (the
     bf16 embedding leaf, M = 2); a profiled ``top_k`` round; the pod
     serve step (each pod's logits those of its own serving, bit for
     bit); the four rounds at the float32 smoke preset, card against CPU;
     once its timed and profiled rows are done, the dry run's four cells
     start on the host (below);
  9. the mesh layer, part 2: ``mesh-one-rank-qwen3-1.7b``, the full-width
     ``make_train_step`` (each layer rematerialised, 4 x 512 tokens) with
     DTensor params on a (1, 1) mesh over a one-rank NCCL group, bit for
     bit the plain step, its local-op FLOPs equal to the dry run's count
     of the same cell at (1, 1) and its peak within MESH_PEAK_MARGIN of
     the dry run's; phase 7's two smoke-preset runs, card against CPU,
     while the cells run; then the ``dryrun-*`` lines of DRYRUN_CELLS, each
     cell one host process on a fake process group of the production
     mesh (256 or 512 ranks, fake cuda tensors: nothing allocated):
     per-device FLOPs, traffic, collectives by kind and axis, peak, the
     roofline terms at H100 data-sheet rates and the dominant one; the
     groups are destroyed as each cell ends. (Phase 6 also runs the
     MoE's 16 EP shard bodies at full width, ``moe-ep-olmoe-1b-7b``.)
     Each layer of every training step is rematerialised (``cfg.remat``
     'full'): RWKV-6's ``wkv6`` launches twice a layer a step;
 10. print the ``kernels`` JSON line (all nine TPU kernels' counterparts
     and ``wkv6_backward``, with their launches on the main path and on
     the Async WAN, MultiKRUM WAN, edge, both LM-training and the pod-round
     paths), then the result line.

The card's peak rates are the published H100 SXM figures; a card capped
below 700 W runs slower, which is why its power limit is printed beside the
numbers.
"""
from __future__ import annotations

import gc
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
PROFILE_TRIES = 3              # profiles of a row before its gate reads one
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
# federated LM training (phase 7): qwen3-1.7b at full width, its token
# streams drawn at a data vocabulary of 4,096 (make_lm_dataset builds dense
# vocab x vocab float64 matrices: 184.7 GB each at 151,936); the
# reference builder's settings. At 2 steps an epoch one silo's eval loss
# rose on an H100 80GB, twice, while the steps are a small part of a
# round's time (host copies and hashing are the rest), so it keeps 8
LM_ARCH = "qwen3-1.7b"
# then rwkv6-1.6b at its full width (24 layers, d_model 2048, d_ff 7168, 32
# heads of 64, vocab 65,536), through the wkv6 and wkv6_backward kernels;
# its params as jax.eval_shape of the reference's init counts them
LM_ARCHS = (LM_ARCH, "rwkv6-1.6b")
# phase 7's two federated runs: full width, the depth cut to half (28 ->
# 14 and 24 -> 12 layers) to keep the script inside its time limit once
# every layer is rematerialised and phase 9 runs (a round's host work, the
# store's copies and hashes, scales with the model); their param counts
LM_DEPTH = {LM_ARCH: 14, "rwkv6-1.6b": 12}
LM_PARAMS = {LM_ARCH: 1_019_278_848, "rwkv6-1.6b": 934_053_888}
LM_DATA_VOCAB = 4096
LM_STREAM = 60_000
LM_EXP = dict(seq_len=128, batch_size=8, steps_per_epoch=8, lr=0.05)
LM_ROUNDS = 2
# eval loss, card vs CPU (float32 smoke). RWKV-6's training is
# ill-conditioned in the reference itself (a 2e-7 relative move of the
# params moves a gradient by 7.1e-3 of 6.6: tests/test_torch_rwkv6_train.py);
# its runs take tests/test_torch_lm_train_recurrent.py's settings and are
# held after round 1 only, at about ten times the CPU's own move there
# under a CHAOS_EPS move of its init (1.0e-5; card against CPU 2.86e-5, on
# an H100 80GB); after round 2 that move is 0.040, so round 2 is printed
LM_LOSS_TOL = {LM_ARCH: 1e-5, "rwkv6-1.6b": 3e-4}
LM_PARAM_RTOL = 1e-5           # |card - cpu| / |cpu| of each silo's params
GRAD_REL = 1e-4                # one step's gradients, card vs CPU, of max|g|
# RWKV-6's smoke cross-check runs at tests/test_torch_lm_fed.py's settings,
# those of the 1e-2 bound; CHAOS_EPS: the relative move of a CPU run's init
# that shows how far the run itself would drift
RECURRENT_EXP = dict(seq_len=32, batch_size=4, steps_per_epoch=2, lr=0.05)
RECURRENT_STREAM = 6000
CHAOS_EPS = 1e-7
TIME_MIX = ("wr", "wk", "wv", "wg", "decay_base", "decay_w1", "decay_w2",
            "bonus_u", "mix_mu", "mix_w1", "mix_w2")
LM_MEM_EVENTS = 6_000_000      # allocator events kept for the peak's replay
# a training step's saved activations and bf16 weight casts at seq 128,
# batch 8. qwen3-1.7b: 11.84 GB live at the peak's replay (the attention's
# scores padded to a 1,024-key chunk the most), on an H100 80GB.
# rwkv6-1.6b: 8.27 GB saved, counted from shapes on the CPU (the storages
# autograd saves in one forward of the loss, through WKV6, float32 params,
# parameters excluded: 0.558 GB outside the layers and 0.321 GB a layer,
# from the difference between 1 and 2 layers, times 24), and the
# wkv6_backward scratch of a layer, 0.034 GB (each 32-token chunk's
# incoming state and outgoing gradient, [8, 32, 4, 64, 64] f32 twice, and
# du's partials). Its peak is the FedAvg moment, 38 P, all the same
# Each layer rematerialised (cfg.remat 'full'): qwen3-1.7b's saved
# activations fall by 1.67 GB at this shape (launch/opstats.mem_tracker
# over one float32 make_train_step under fake tensors at 28 layers: 23.77
# GB peak without remat, 22.10 with): 10.33 GB at 28 layers. At LM_DEPTH
# (half the layers) the same reckoning's activations halve (1.41 -> 0.70
# GB for qwen3-1.7b, 0.40 -> 0.20 for rwkv6-1.6b): qwen3-1.7b 10.33 / 2;
# rwkv6-1.6b 0.558 + 12 x 0.321 + 0.034 (the split above)
LM_STEP_GB = {LM_ARCH: 5.17, "rwkv6-1.6b": 4.44}
LM_MEM_MARGIN = 0.05           # the peak may pass its reckoning by 5 %
MOE_EP_ARCH = "olmoe-1b-7b"    # phase 6's EP check (moe_ep_check)
MOE_EP_RANKS = 16              # the production model axis
MOE_EP_ULPS = 4                # its sum vs the one-device branch
# phase 9: the dry run's cells on the card's host (fake process groups of
# 256 and 512 ranks, fake cuda tensors), one process each, started once
# phase 8's timed and profiled rows are done and read at phase 9
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", False),
                ("qwen3-1.7b", "train_4k", True),
                ("olmoe-1b-7b", "train_4k", False),
                ("rwkv6-1.6b", "train_4k", False))
DRYRUN_OUT = os.path.join("build", "dryrun_torch_smoke")
MESH_PEAK_MARGIN = 0.05        # one-rank peak vs the dry run's reckoning
# rwkv6-1.6b's learning rate. Its full-width gradients at the reference's
# init are ill-conditioned: at 24 layers in bf16 their size turns on the
# rounding of the forward (rwkv6_step_check prints the kernel path, the
# plain scan and the plain scan with its sums in the kernel's order side
# by side: 194,560, 252,928 and 8,512 for one batch on an H100 80GB).
# At LM_EXP's 0.05 one step moved a parameter by 9,728 to 34,201, and the
# federated run read NaN; 1e-5 is the largest rate of 0.05, 1e-3, 1e-4
# and 1e-5 at which 16 local steps keep every parameter within twice the
# init's largest (PERF.md, the probe's readings)
RWKV6_LR = 1e-5
# the full-width gradient check of RWKV-6 (rwkv6_step_check): one client
# step on a batch of the phase's shape (B 8, T 128) at each (dtype,
# layers), every wkv6 and wkv6_backward call held to its plain version on
# its own operands, and the whole step's gradients, kernel path against
# plain path (autograd of ref.wkv6_naive on the card), every leaf within
# the tolerance of its largest entry where the two agree: three times or
# more the largest gap seen between the plain scan and the same scan with
# its forward's sums in the kernel's order (printed beside it: 6.7e-2,
# 9.5e-5 and 7.7e-3 at the three gated depths on an H100 80GB; in bf16
# the backward rounds the gradients to bf16). None: at the full depth the
# gradients turn on the forward's rounding, printed
RWKV6_STEP_TOL = {("bfloat16", 24): None, ("bfloat16", 2): 2e-1,
                  ("float32", 2): 1e-3, ("float32", 4): 5e-2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fns: dict, iters, reps: int = 5) -> dict:
    """Time on the card of each function of ``fns``: ``reps`` rounds in
    which each function in turn runs WARM_S seconds of warm-up calls (at
    least 3), then ``iters`` back-to-back calls between two CUDA events;
    the median of each function's rounds. In turns, the drift of a
    host-bound call's time over a run (up to a third) reaches every
    function alike; the warm-up before each block absorbs what a switch
    costs (a streaming kernel at N = 2^28 runs up to 15 % slow for its
    first ~10 ms of calls after other work or on fresh allocations).
    ``iters``: one count for all, or a dict of counts by name."""
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
            n = iters[name] if isinstance(iters, dict) else iters
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / n)
    return {name: sorted(ts)[len(ts) // 2] for name, ts in times.items()}


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    return timed({"fn": fn}, iters, reps)["fn"]


def device_time(fn, expect: dict, calls: int = 50) -> dict:
    """Device time a launch and the kernels ``fn`` launches, from
    ``torch.profiler`` over ``calls`` warm calls (CUDA events at these sizes
    time the host's launch rate instead). Per launch, not per call. The
    session has a quiet margin on each side (``profile_window.profiled``):
    without it the profiler now and then missed the events nearest an edge
    of its window, a share of them or all. ``expect`` maps kernel-name
    prefixes to their launches a call: a profile that saw fewer launches
    of one of them and more of none, or no kernel at all, is taken again,
    up to PROFILE_TRIES in all (``profile_tries``); the caller's gate reads
    the last."""
    from repro_torch.kernels.profile_window import profiled
    short = lambda e: e.key.split("<")[0].split("::")[-1].split("(")[0]
    fn()
    for tries in range(1, PROFILE_TRIES + 1):
        with profiled() as prof:
            for _ in range(calls):
                fn()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = sum(e.count for e in kern)
        want = {k: n * calls for k, n in expect.items()}
        seen = {k: sum(e.count for e in kern if short(e).startswith(k))
                for k in want}
        missed = any(seen[k] < n for k, n in want.items()) and \
            not any(seen[k] > n for k, n in want.items())
        if launches and not missed:
            break
    if not launches:
        fail(f"the profiler saw no kernel in {PROFILE_TRIES} tries")
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
                          for k, (c, us) in sorted(by_kernel.items())},
            "profile_tries": tries}


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
    extra = device_time(call, expect={kernel: 1})
    if extra["launches_seen_per_call"] > 1 or any(
            not k.startswith(kernel) for k in extra["device_kernels"]):
        fail(f"{name}: {extra}, want one {kernel} a call")
    return extra


def ops_call_profile(name: str, call, kernel: str) -> dict:
    """Device time of a call that may launch PyTorch's own kernels beside
    ours (``weighted_sum`` above ``wsum.MAX_HOST_M`` copies its host
    weights to the card): the device time a call in all, and ``kernel``'s
    own a launch; fails unless ``kernel`` runs exactly once a call."""
    extra = device_time(call, expect={kernel: 1})
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
                    lambda: wsum.weighted_sum(x, w_host),
                    expect={"weighted_sum": 1})["device_us_per_launch"],
                **device_time(lambda: wsum.weighted_sum(x, w),
                              expect={"weighted_sum": 1})}}
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
        # the main path's call (wire.encode_vec): ops.quantize hands the
        # kernel the n = 62,006 floats of a flattened model, and the kernel
        # writes the 131,072 codes of the wire payload, the zero padding's
        # own included; also from a 4-byte offset (the x[1:] view)
        xm = xq[:MAIN_N].clone()
        call = lambda xm=xm: ops.quantize(xm)
        plain = lambda xm=xm: ref.quantize_int8(F.pad(xm, (0, N - MAIN_N)))
        for xv in (xm, xq[1:MAIN_N + 1]):
            (q, s, n) = launched_once("quantize", lambda: ops.quantize(xv))
            q0, s0 = ref.quantize_int8(F.pad(xv, (0, N - MAIN_N)))
            torch.cuda.synchronize()
            if not (n == MAIN_N and torch.equal(q, q0)
                    and torch.equal(s, s0)):
                fail("quantize through ops at n=62,006: codes or scales "
                     "differ from the plain version on the zero-padded "
                     f"input (base {xv.data_ptr() % 16} bytes off 16)")
        ts = timed({"kernel": call, "plain": plain}, iters)
        row("quantize", 0.0, ts["kernel"], ts["plain"],
            MAIN_N * 4 + N + N // 1024 * 4, N=N, n=MAIN_N,
            check="bit-exact codes and scales of the zero-padded input, "
                  "also from a 4-byte offset; through ops: no F.pad, one "
                  "quantize_kernel a call and no other kernel",
            later=lambda call=call: one_kernel_a_call(
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

    # wsum_q8: the fused cross-silo merge of M int8 peers; the plain
    # version is the kernel's FMA chain emulated (in 2^27-column windows)
    M = K
    wq = torch.rand((M,), generator=gen, device="cuda")
    plain = lambda qk=qk, sk=sk, wq=wq, n=N: wsum_q8_windows(qk, sk, wq, n)
    got, want = q8agg.wsum_q8(qk, sk, wq), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"wsum_q8 {shape}: not the FMA chain (max_abs_err {err})")
    del got, want
    # the plain version emulates the chain in float64: one call a round
    ts = timed({"kernel": lambda: q8agg.wsum_q8(qk, sk, wq),
                "plain": plain}, {"kernel": iters, "plain": 1})
    tol = "bit-exact with the FMA chain (ref.weighted_sum_ordered)"
    extra = {} if large else {"later": lambda qk=qk, sk=sk, wq=wq:
                              one_kernel_a_call(
                                  "wsum_q8", lambda: q8agg.wsum_q8(qk, sk, wq),
                                  "wsum_q8_kernel")}
    row("wsum_q8", err, ts["kernel"], ts["plain"],
        M * N + M * N // 1024 * 4 + N * 4, 2.0 * M * N, check=tol,
        path=large, M=M, N=N, **extra)
    if not large:
        # the main path's call (SiloAggregator.apply_cross_silo_vec): the
        # merge of M int8 peers through ops, only the n = 62,006 columns
        # kept written, only the 61 tiles they lie in read
        call = lambda qk=qk, sk=sk, wq=wq: ops.weighted_sum_q8(qk, sk, wq,
                                                               MAIN_N)
        plain = lambda qk=qk, sk=sk, wq=wq: ref.wsum_q8(qk, sk, wq)[:MAIN_N]
        got, want = launched_once("wsum_q8", call), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != (MAIN_N,) or not torch.equal(got, want):
            fail(f"wsum_q8 through ops at n=62,006: shape "
                 f"{tuple(got.shape)}, max_abs_err {err}")
        del got, want
        ts = timed({"kernel": call, "plain": plain}, iters)
        tiles = -(-MAIN_N // 1024)
        row("wsum_q8", err, ts["kernel"], ts["plain"],
            M * MAIN_N + M * tiles * 4 + MAIN_N * 4, 2.0 * M * MAIN_N,
            check=tol + "; through ops: no padding or slice, one "
                  "wsum_q8_kernel a call and no other kernel",
            M=M, N=N, n=MAIN_N,
            later=lambda call=call: one_kernel_a_call(
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


def chunks(n: int, size: int = 1 << 27):
    """[start, stop) windows covering n elements, for comparisons at model
    width whose temporaries would not fit at once."""
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def model_width_row(name: str, max_err: float, ts: dict, nbytes: float,
                    flops: float = 0.0, check: str = "", ops_bytes=None,
                    **dims) -> dict:
    """Print one row of ``check_model_width``: times (CUDA events), the
    bound and the share of it the kernel reaches; with ``ops_bytes`` also
    the bound of the ``ops`` call and the share of it that call reaches."""
    b_ms, b_by = bound(nbytes, flops)
    if ops_bytes is not None:
        ops_b = bound(ops_bytes, flops)[0]
        dims.update(ops_bound_ms=ops_b, ops_share_of_bound=ops_b / ts["ops"])
    line = {"phase": "kernels-at-model-width", "name": name, **dims,
            "max_abs_err": max_err, "check": check, "ms": ts["kernel"],
            "plain_ms": ts["plain"], "library_ms": ts.get("library"),
            **({"ops_ms": ts["ops"]} if "ops" in ts else {}),
            "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ts["kernel"],
            "device": torch.cuda.get_device_name(0)}
    print(json.dumps(line), flush=True)
    return line


def wsum_q8_windows(q, s, w, n: int):
    """``ref.wsum_q8`` of [M, Np] payloads, the first n columns, 2^27 at a
    time: its float64 emulation of the FMA chain over a whole payload would
    not fit beside the operands."""
    from repro_torch.kernels import ref
    return torch.cat([ref.wsum_q8(q[:, a:-(-b // 1024) * 1024],
                                  s[:, a // 1024:-(-b // 1024)], w)[:b - a]
                      for a, b in chunks(n)])


def check_model_width(gen, iters: int = 3) -> list:
    """The five kernels of the LM-training path at the operand it hands
    them at full width: N = 1,723,982,848, the flat f32 vector of
    ``qwen3-1.7b`` (params drawn on the card from seeds 0, 1 and 2, as
    three silos' models), padded to Np = 1,723,990,016 for the int8 wire.
    ``weighted_sum`` (a silo's FedAvg of two clients) on the whole model and
    on its largest leaf, the 153,600 x 2,048 embedding (the vocabulary
    padded to a multiple of 2,048): to its tolerance and
    bit for bit against the kernel's FMA order; ``quantize`` (each model's
    encode, through ``ops``: the kernel on the N floats, writing the
    padding itself) bit for bit against the zero-padded input;
    ``dequantize_batch`` at K = 2 (the scoring ingest: a [2, N] output of
    3.45e9 elements, past 2^31) bit for bit, row by row; ``wsum_q8`` of the
    three payloads (the cross-silo merge) bit for bit against its FMA order,
    in windows of 2^27, beside the ``torch.stack`` of the payloads that
    precedes it on the main path. Every element is compared."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, quant, ref
    from repro_torch.models import build_model
    model = build_model(get_config(LM_ARCH))
    N = FAMILY_PARAMS[LM_ARCH][0]
    Np = N + (-N) % ops.QUANT_BLOCK
    rows = []

    def init(seed):
        return model.init(torch.Generator(device="cuda").manual_seed(seed),
                          "cuda")

    # weighted_sum: the FedAvg of two clients' models
    p0, p1 = init(0), init(1)
    emb = torch.stack([p["embed"]["embedding"] for p in (p0, p1)]).reshape(
        2, -1).float()
    x, _ = ops.flatten_batch([p0, p1])
    del p0, p1
    if x.shape != (2, N):
        fail(f"model width: flat vectors {tuple(x.shape)}, want (2, {N})")
    w = torch.rand((2,), generator=gen, device="cuda")
    w = w / w.sum()
    w_host = w.cpu()
    for what, xs in (("embedding", emb), ("model", x)):
        n = xs.shape[1]
        got = ops.weighted_sum(xs, w_host)
        err, scale = 0.0, 0.0
        for a, b in chunks(n):
            xc = xs[:, a:b]
            err = max(err, float((got[a:b] - ref.weighted_sum(xc, w)).abs()
                                 .max()))
            scale = max(scale, float((w[0] * xc[0].abs() + w[1] * xc[1].abs())
                                     .max()))
            if not torch.equal(got[a:b], ref.weighted_sum_ordered(xc, w)):
                fail(f"weighted_sum at model width ({what}): not the "
                     f"ordered FMA chain in [{a}, {b})")
        tol = 2 * 2.0 ** -23 * scale
        if not err <= tol:
            fail(f"weighted_sum at model width ({what}): max_abs_err {err} "
                 f"> {tol}")
        del got
        ts = timed({"kernel": lambda: ops.weighted_sum(xs, w_host),
                    "plain": lambda: ref.weighted_sum(xs, w),
                    "library": lambda: torch.matmul(w, xs)}, iters, 3)
        rows.append(model_width_row(
            "weighted_sum", err, ts, 3 * n * 4, 4.0 * n,
            check=f"abs err <= M*2^-23*max sum|w x| = {tol:.3e}; bit-exact "
                  "with the ordered FMA chain", M=2, N=n, operand=what))
        torch.cuda.empty_cache()
    del emb

    # quantize: each model's int8 encode, through ops (the kernel reads the
    # N floats and writes the Np codes, its zero padding's own included)
    qs = []
    for i in range(3):
        xi = x[i] if i < 2 else ops.flatten_pytree(init(2))[0]
        q, s, n = ops.quantize(xi)
        qs.append((q, s))
        if i == 0:
            xp = F.pad(xi, (0, Np - N))
            q0, s0 = ref.quantize_int8(xp)
            if not (n == N and torch.equal(q, q0) and torch.equal(s, s0)):
                fail("quantize at model width: codes or scales differ from "
                     f"the plain version ({int((q != q0).sum())} codes)")
            del q0, s0
            torch.cuda.empty_cache()
            ts = timed({"kernel": lambda: quant.quantize(xp),
                        "plain": lambda: ref.quantize_int8(xp),
                        "ops": lambda: ops.quantize(xi)}, iters, 3)
            rows.append(model_width_row(
                "quantize", 0.0, ts, Np * 4 + Np + Np // 1024 * 4,
                ops_bytes=N * 4 + Np + Np // 1024 * 4,
                check="bit-exact codes and scales of the zero-padded "
                      "input; ms is the kernel on that padded operand, "
                      "ops_ms the main path's call on the N floats (no "
                      "F.pad: the kernel writes the padding)",
                N=Np, n=N))
            del xp
        del xi
    del x
    torch.cuda.empty_cache()

    # dequantize_batch: the scoring ingest of two payloads, [2, N] out
    qk = torch.stack([qs[0][0], qs[1][0]])
    sk = torch.stack([qs[0][1], qs[1][1]])
    got = ops.dequantize_batch(qk, sk, N)
    for k in range(2):
        if not torch.equal(got[k], ref.dequantize_int8(qk[k], sk[k])[:N]):
            fail(f"dequantize_batch at model width: row {k} differs from "
                 "the plain version")
    del got
    torch.cuda.empty_cache()
    ts = timed({"kernel": lambda: ops.dequantize_batch(qk, sk, N),
                "plain": lambda: ref.dequantize_rows(qk, sk)[:, :N],
                "library": lambda: torch.mul(qk.view(2, -1, 1024),
                                             sk.unsqueeze(-1))}, iters, 3)
    rows.append(model_width_row(
        "dequantize_batch", 0.0, ts, 2 * N + 2 * (Np // 1024) * 4 + 2 * N * 4,
        check="bit-exact, both rows whole (output element 2^31 is row 1, "
              f"column {2 ** 31 - N})", K=2, N=Np, n=N))
    del qk, sk
    torch.cuda.empty_cache()

    # wsum_q8: the cross-silo merge of three payloads, beside the
    # torch.stack of the peers' payloads that SiloAggregator.
    # apply_cross_silo_vec makes before it (timed on the rows of q3)
    q3 = torch.stack([q for q, _ in qs])
    s3 = torch.stack([s for _, s in qs])
    del qs
    w3 = torch.rand((3,), generator=gen, device="cuda")
    got = ops.weighted_sum_q8(q3, s3, w3, N)
    for a, b in chunks(N):            # a: a multiple of 1024
        if not torch.equal(got[a:b], wsum_q8_windows(
                q3[:, a:], s3[:, a // 1024:], w3, b - a)):
            fail(f"wsum_q8 at model width: not the kernel's FMA chain in "
                 f"[{a}, {b})")
    del got
    torch.cuda.empty_cache()
    ts = timed({"kernel": lambda: ops.weighted_sum_q8(q3, s3, w3, N),
                "plain": lambda: wsum_q8_windows(q3, s3, w3, N),
                "stack": lambda: (torch.stack(list(q3)),
                                  torch.stack(list(s3)))},
               {"kernel": iters, "plain": 1, "stack": iters}, 3)
    tiles = -(-N // 1024)
    # the stack reads and writes the three payloads and their scales
    stack_bound = bound(2 * (3 * Np + 3 * (Np // 1024) * 4))[0]
    rows.append(model_width_row(
        "wsum_q8", 0.0, ts, 3 * N + 3 * tiles * 4 + N * 4, 6.0 * N,
        check="bit-exact with the kernel's FMA chain, the plain version "
              "(its float64 emulation, ref.wsum_q8) in 2^27-column windows",
        M=3, N=Np, n=N, stack_ms=ts["stack"], stack_bound_ms=stack_bound,
        stack_share_of_bound=stack_bound / ts["stack"]))
    del q3, s3
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


def wkv6_y_state_errors(y, s, y0, s0) -> dict:
    """``wkv6``'s outputs against its plain version's: |dy| <= WKV_REL
    max|y| + one bf16 ulp of |y| (y is bf16: the two may round a float32
    value to either side of a bf16 boundary), |dS| <= WKV_REL max|S|."""
    dy = (y.float() - y0.float()).abs()
    ymax, smax = float(y0.float().abs().max()), float(s0.abs().max())
    ds = float((s - s0).abs().max())
    ok = bool((dy <= WKV_REL * ymax + BF16_ULP * y0.float().abs()).all()) \
        and ds <= WKV_REL * smax
    return {"ok": ok, "max_abs_err_y": float(dy.max()), "max_abs_y": ymax,
            "max_abs_err_state": ds, "max_abs_state": smax}


def wkv6_grad_errors(got, want) -> dict:
    """``wkv6_backward``'s gradients against its plain version's, each
    within WKV6_BWD_REL of its max|g| in f32 and BF16_ULP of it in bf16,
    of the plain version's dtype and shape, and finite; a gradient the
    caller did not ask for is None in ``got`` and skipped."""
    errs = {}
    for name, a, b in zip(WKV6_BWD_NAMES, got, want):
        if a is None:
            continue
        top = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        tol = (BF16_ULP if a.dtype == torch.bfloat16 else WKV6_BWD_REL) * top
        errs[name] = {"max_abs_err": err, "max_abs": top, "tol": tol,
                      "ok": a.dtype == b.dtype and a.shape == b.shape
                      and err <= tol and bool(torch.isfinite(a).all())}
    return errs


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
        errs[name] = wkv6_y_state_errors(y, s, *plain(*args))
        if not errs[name]["ok"]:
            fail(f"wkv6 {shape} vs {name}: {errs[name]}")
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
    scan, sub = errs["scan"], errs["subchunks"]
    row = {"name": "wkv6", "shape": shape, "path": True, "B": B, "T": T,
           "H": H, "hs": hs,
           "max_abs_err": max(scan["max_abs_err_y"],
                              scan["max_abs_err_state"]),
           **{k: scan[k] for k in ("max_abs_err_y", "max_abs_err_state",
                                   "max_abs_y", "max_abs_state")},
           "max_abs_err_vs_subchunks": max(sub["max_abs_err_y"],
                                           sub["max_abs_err_state"]),
           "check": f"|dy| <= {WKV_REL} max|y| + 2^-7 |y|, "
                    f"|dS| <= {WKV_REL} max|S|, against the token scan and "
                    "the sub-chunked arithmetic; reruns the same bits",
           "kernel_ms": cuda_ms(lambda: rwkv6.wkv6(*args), iters),
           "plain_ms": cuda_ms(lambda: ref.wkv6_naive(*args),
                               max(2, iters // 20), reps=1),
           # the same call through the autograd Function, as a training
           # step makes it (``wkv6`` skips it outside a gradient)
           "function_ms": cuda_ms(lambda: rwkv6.WKV6.apply(*args), iters),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bound_tc_ms": b_tc_ms * 1e3, "bound_tc_by": b_tc_by,
           "device": torch.cuda.get_device_name(0)}
    row["of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["of_bound_tc"] = row["bound_tc_ms"] / row["kernel_ms"]
    if shape != "large":
        row["_later"] = lambda: one_kernel_a_call(
            f"wkv6 {shape}", lambda: rwkv6.wkv6(*args), "wkv6_kernel")
    return row


# (B, T, H, hs, dtype of r, k, v and dy, a final state's gradient given)
WKV6_BWD_SHAPES = {
    "train": (8, 128, 32, 64, torch.bfloat16, True),   # LM_EXP at full width
    "train-no-dstate": (8, 128, 32, 64, torch.bfloat16, False),
    "long": (4, 1000, 32, 64, torch.bfloat16, True),   # ragged: 31 chunks + 8
    "smoke": (2, 70, 4, 16, torch.float32, True),      # the smoke preset's hs
    "decays": (2, 100, 4, 64, torch.float32, True),    # w = 0, 1 and 1e-30
}
WKV6_BWD_REL = 1e-4            # of each gradient's max|.| in f32
WKV6_BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
# the token-serial wkv6_backward kernel that the chunked one replaced (ms;
# chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W)
WKV6_BWD_EARLIER_MS = {"train": 0.5249, "train-no-dstate": 0.5268,
                       "long": 2.6037, "smoke": 0.1098, "decays": 0.1706}
# gradients asked for alone or in part (dr, dk, dv, dw, du, dstate0): the
# pass runs one role or none, the chunk kernel gets a null state or does
# not run
WKV6_BWD_NEEDS = {"dv": (2,), "dstate0": (5,), "du": (4,), "dr": (0,),
                  "dk+dv+dstate0": (1, 2, 5)}
# the kernels one wkv6_backward call launches (profile names)
WKV6_BWD_KERNELS = ["wkv6_bwd_chunk_kernel", "wkv6_bwd_pass_kernel",
                    "wkv6_du_kernel"]


def check_wkv6_backward(shape: str, gen, iters: int) -> dict:
    """The ``wkv6_backward`` kernel against its plain reverse scan
    (``ref.wkv6_backward_naive``) and against its own chunked arithmetic
    written out in PyTorch (``ref.wkv6_backward_chunks``) on the card,
    every one of the six gradients: |d| <= WKV6_BWD_REL * max|g| in f32,
    BF16_ULP * max|g| for a bf16 gradient (the two may round a float32
    value to either side of a bf16 boundary); one launch of the wrapper a
    call; a rerun gives the same bits (du is summed over batch and chunk in
    a fixed order), and so does a call asking for a part of the gradients
    (WKV6_BWD_NEEDS), which gives None for the rest. Times by CUDA events, kernel and plain in turns,
    beside the bound: r, k, v, w, dy, u and the states read, dr, dk, dv,
    dw, du and dstate0 written, over the memory rate, or 10 hs^2 float32
    operations a token and head, the larger; and beside the same work at
    the units the chunked design gives it (``bound_tc_ms``) and the
    token-serial kernel's times (``earlier_ms``). No one PyTorch call
    computes it: library none."""
    from repro_torch.kernels import ref, rwkv6
    B, T, H, hs, dt, given = WKV6_BWD_SHAPES[shape]
    r, k, v, w, u, s0 = wkv6_inputs(B, T, H, hs, gen)
    r, k, v = (a.to(dt) for a in (r, k, v))
    if shape == "decays":
        w[..., :8] = 0.0
        w[..., 8:16] = 1.0
        w[..., 16:24] = 1e-30
    dy = torch.randn((B, T, H, hs), generator=gen, device="cuda").to(dt)
    ds = torch.randn((B, H, hs, hs), generator=gen, device="cuda") \
        if given else None
    args = (r, k, v, w, u, s0, dy, ds)
    got = launched_once("wkv6_backward", lambda: rwkv6.backward(*args))
    errs = wkv6_grad_errors(got, ref.wkv6_backward_naive(*args))
    if not all(e["ok"] for e in errs.values()):
        fail(f"wkv6_backward {shape}: {errs}")
    errs_chunks = wkv6_grad_errors(got, ref.wkv6_backward_chunks(*args))
    if not all(e["ok"] for e in errs_chunks.values()):
        fail(f"wkv6_backward {shape} vs the chunked arithmetic: "
             f"{errs_chunks}")
    again = rwkv6.backward(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"wkv6_backward {shape}: a rerun gives other bits")
    for part, idx in WKV6_BWD_NEEDS.items():
        sub = rwkv6.backward(*args, needs=tuple(i in idx for i in range(6)))
        if not all((b is None) if i not in idx else torch.equal(a, b)
                   for i, (a, b) in enumerate(zip(got, sub))):
            fail(f"wkv6_backward {shape}: {part} alone is not the full "
                 "call's bits, or another gradient came back")
    del got, again, sub
    e = r.element_size()
    n = B * T * H * hs
    states = B * H * hs * hs * 4
    nbytes = (n * (4 * e + 4) + H * hs * 4 + states * (1 + given)
              + n * (3 * e + 4) + H * hs * 4 + states)
    b_ms, b_by = bound(nbytes, 10.0 * hs * hs * B * T * H)
    # the same work on the units the chunked kernel gives it, a token and
    # head (chunks of C = 32, two sub-chunks): on the tensor cores, as
    # three TF32 products each (a third of their rate), the two passes'
    # state steps, S_in dy, G_out v and KQ G_out (hs^2 multiply-adds each),
    # A^T dY and dY V^T over their causal halves ((C + 1) hs / 2 each), the
    # products across the sub-chunks (Fx, Hx, A's block: 3 C hs / 4); on
    # the CUDA cores the scans and A's diagonal sub-chunks, the decay
    # products and the sums of the terms ((3 C + 3) hs) and rowsum(G_out
    # S_in) once a chunk (hs^2 / C)
    C = 32
    tc_ms = 2.0 * (5.0 * hs * hs + (C + 1) * hs + 0.75 * C * hs) \
        * B * T * H / (TF32_FLOPS / 3) * 1e3
    alu_ms = ((3.0 * C + 3) * hs + hs * hs / C) * B * T * H / F32_FLOPS \
        * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    b_tc_ms, b_tc_by = ((bytes_ms, "bytes") if bytes_ms >= tc_ms + alu_ms
                        else (tc_ms + alu_ms, "operations"))
    ts = timed({"kernel": lambda: rwkv6.backward(*args),
                "plain": lambda: ref.wkv6_backward_naive(*args)},
               {"kernel": iters, "plain": 1}, reps=3)
    row = {"name": "wkv6_backward", "shape": shape, "path": shape == "train",
           "B": B, "T": T, "H": H, "hs": hs, "dtype": str(dt),
           "dstate_given": given,
           "max_abs_err": max(x["max_abs_err"] for x in errs.values()),
           "errors": errs,
           "max_abs_err_vs_chunks": max(x["max_abs_err"]
                                        for x in errs_chunks.values()),
           "check": f"|d| <= {WKV6_BWD_REL} max|g| (f32), {BF16_ULP} "
                    "max|g| (bf16) for each of dr, dk, dv, dw, du, dstate0 "
                    "against ref.wkv6_backward_naive and "
                    "ref.wkv6_backward_chunks; reruns the same bits; "
                    f"{', '.join(WKV6_BWD_NEEDS)} alone the full call's "
                    "bits, the others None",
           "kernel_ms": ts["kernel"], "plain_ms": ts["plain"],
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bound_tc_ms": b_tc_ms, "bound_tc_by": b_tc_by,
           "earlier_ms": WKV6_BWD_EARLIER_MS[shape],
           "earlier": "the token-serial kernel, NVIDIA H100 80GB HBM3, "
                      "700.00 W, chip_smoke.py",
           "device": torch.cuda.get_device_name(0)}
    row["of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["of_bound_tc"] = row["bound_tc_ms"] / row["kernel_ms"]
    if shape in ("train", "smoke", "long"):
        row["_later"] = lambda: backward_profile(
            f"wkv6_backward {shape}", lambda: rwkv6.backward(*args))
    return row


def backward_profile(name: str, call) -> dict:
    """Device time of one ``wkv6_backward`` wrapper call, kernel by kernel
    (profiler); fails unless the call launches each of WKV6_BWD_KERNELS
    once and nothing else. The chunk kernel starts before the pass ends
    (programmatic dependent launch), so its device time includes that wait
    and overlap, and ``device_us_per_call`` sums above the call's time by
    CUDA events; so the call is profiled again with that launch off
    (``by_kernel_no_pdl``: each kernel's own device time)."""
    from repro_torch.kernels import rwkv6
    expect = {k: 1 for k in WKV6_BWD_KERNELS}
    extra = device_time(call, expect=expect)
    rwkv6.set_backward_pdl(False)
    try:
        own = device_time(call, expect=expect)
    finally:
        rwkv6.set_backward_pdl(True)
    for got in (extra, own):
        per_call = {k: v["launches_per_call"]
                    for k, v in got["by_kernel"].items()}
        if per_call != {k: 1.0 for k in WKV6_BWD_KERNELS}:
            fail(f"{name}: {got}, want one launch a call of each of "
                 f"{WKV6_BWD_KERNELS}")
    return {**extra, "device_us_per_call": extra["device_us_per_launch"]
            * extra["launches_seen_per_call"],
            "by_kernel_no_pdl": own["by_kernel"],
            "device_us_per_call_no_pdl": own["device_us_per_launch"]
            * own["launches_seen_per_call"]}


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
    prof = device_time(lambda: env.reconstruct(base),
                       expect={"add_q8_delta": 1})
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
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    from repro_torch.kernels import _build
    from repro_torch.kernels.profile_window import profiled
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=rounds, mode="sync",
                    scorer=scorer, agg_policy="top_k", policy_k=2,
                    compression=compression)
    orch = build_image_experiment(get_config("paper-cnn"), fed,
                                  partition="niid", alpha=0.2, n_train=1500,
                                  n_test=450, seed=0, device="cuda")
    torch.cuda.synchronize()
    before = _build.launch_counts()
    with profiled() as prof:
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


def record_run(orch) -> dict:
    """What a run's silos do, as they do it: each silo's submitted CIDs in
    order ("cids") and, for each cross-silo merge, the number of int8 peer
    groups ``apply_cross_silo_vec`` received ("int8_groups"): one
    ``wsum_q8`` launch a group, none for a peer rebuilt from a delta,
    which merges as float32."""
    rec = {"cids": {s.silo_id: [] for s in orch.silos}, "int8_groups": []}
    for s in orch.silos:
        submit, merge = s._submit, s.cluster.aggregator.apply_cross_silo_vec

        def sub(method, *, _f=submit, _cids=rec["cids"][s.silo_id], **kw):
            # a reverted submission retries with the same CID
            if method == "submit_model" and kw["cid"] not in _cids[-1:]:
                _cids.append(kw["cid"])
            return _f(method, **kw)

        def mrg(own_vec, peers, weights, _f=merge):
            rec["int8_groups"].append(
                len({int(p.q.shape[0]) for p in peers if p.is_q8}))
            return _f(own_vec, peers, weights)

        s._submit, s.cluster.aggregator.apply_cross_silo_vec = sub, mrg
    return rec


def async_run(device: str, *, net: bool = True, faults: bool = True,
              rounds: int = 3, record=None):
    """Async UnifyFL with int8-delta: 3 silos x 2 clients, top-2, paper CNN
    at its published width, every silo at time_scale 0. ``net``: over
    ``wan-heterogeneous`` with gossip (factor 1) and prefetch, a WAL
    directory under ``build/``, and with ``faults`` the kill and restart of
    KILL_NODE; without ``net``, the single-replica ledger. Runs the
    simulated clock dry after ``run`` (gossip and prefetch in flight; their
    decodes launch kernels too). ``record``, a dict, receives
    ``record_run``'s log of the run. Returns (orch, global accuracy, run
    wall seconds, drain wall seconds)."""
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
    if record is not None:
        record.update(record_run(orch))
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


def repeat_summary(a: dict, b: dict, sa: dict, sb: dict) -> dict:
    """Whether two runs of the same export repeat (``record_run`` logs
    ``a``, ``b`` and ``async_summary``s ``sa``, ``sb``): picks, each silo's
    submitted CIDs and the first (silo, round) where they part, the int8
    merge groups, heights."""
    first = next(([sid, i] for sid in a["cids"]
                  for i, (x, y) in enumerate(zip(a["cids"][sid],
                                                 b["cids"][sid])) if x != y),
                 None)
    return {"picks_equal": sa["picks"] == sb["picks"],
            "cids_equal": a["cids"] == b["cids"],
            "first_cid_differs_at": first,
            "int8_groups_equal": a["int8_groups"] == b["int8_groups"],
            "picks": [sa["picks"], sb["picks"]],
            "int8_groups": [a["int8_groups"], b["int8_groups"]],
            "ledger_height": [sa["ledger_height"], sb["ledger_height"]]}


def async_wan_phase(tree) -> dict:
    """``async-int8-delta-wan``: the Async path over the WAN fabric on the
    card with the launch counts set to 0 just before it, ``wsum_q8``
    launched once for each int8 peer group its merges received (none in a
    run whose picks were all rebuilt from deltas); the same run twice more
    on the card, with cuDNN as it is and then with its deterministic
    algorithms, and whether picks and CIDs repeat; the same run on the
    CPU; the same run without the fabric on both (strict parity, and
    ``wsum_q8`` launched, once an int8 peer group)."""
    from repro_torch.kernels import _build
    rec: dict = {}
    _build.reset_launches()
    orch, ge, wall, drain = async_run("cuda", record=rec)
    launches = _build.launch_counts()
    summ = async_summary(orch, ge)
    line = {"phase": "async-int8-delta-wan", "rounds": 3,
            "delays_s": ASYNC_DELAYS, "kill_restart": KILL_NODE,
            "wall_s": wall, "drain_wall_s": drain, "launches": launches,
            "int8_merge_groups": rec["int8_groups"],
            "decoded_models_on_card": decoded_on_card(orch), **summ}
    print(json.dumps(line), flush=True)
    if not orch.ledger.verify() or summ["rounds_done"] != [3, 3, 3]:
        fail(f"async wan run: ledger or rounds {summ['rounds_done']}")
    check_chain("async wan run", summ, faults=True)
    for s in orch.silos:
        if any(t.device.type != "cuda" for t in tree.leaves(s.cluster.params)):
            fail(f"async wan run, {s.silo_id}: params left the card")
    missing = [k for k in ("weighted_sum", "quantize", "dequantize",
                           "add_q8_delta") if launches[k] == 0]
    if missing:
        fail(f"async wan run never launched {missing}")
    if launches["wsum_q8"] != sum(rec["int8_groups"]):
        fail(f"async wan run: wsum_q8 launched {launches['wsum_q8']} times "
             f"for {sum(rec['int8_groups'])} int8 peer groups merged "
             f"({rec['int8_groups']})")

    # does the run repeat on the card? Once more as it ran, then twice with
    # cuDNN's deterministic algorithms (benchmark off), for this check only
    again: dict = {}
    again_summ = async_summary(*async_run("cuda", record=again)[:2])
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    det: list = [{}, {}]
    try:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        det_summ = [async_summary(*async_run("cuda", record=r)[:2])
                    for r in det]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    print(json.dumps({
        "phase": "async-int8-delta-wan-repeat", "cudnn_flags": flags,
        "as_run": repeat_summary(rec, again, summ, again_summ),
        "cudnn_deterministic": repeat_summary(*det, *det_summ)}),
        flush=True)

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

    # without the fabric no CID reaches a tie-break: strict parity; its
    # picks include whole int8 peers, so wsum_q8 launches here
    led: dict = {}
    _build.reset_launches()
    o_c, ge_c, wall_c, _ = async_run("cuda", net=False, record=led)
    led_launches = _build.launch_counts()
    o_h, ge_h, _, _ = async_run("cpu", net=False)
    a, b = async_summary(o_c, ge_c), async_summary(o_h, ge_h)
    print(json.dumps({"phase": "async-int8-delta-ledger", "wall_s": wall_c,
                      "launches": led_launches,
                      "int8_merge_groups": led["int8_groups"], **a,
                      "cpu_global_accuracy": b["global_accuracy"]}),
          flush=True)
    for k in ("rounds_done", "picks", "submit_t", "ledger_height"):
        if a[k] != b[k]:
            fail(f"async ledger run: {k} {a[k]} on the card, {b[k]} on the "
                 "CPU")
    if not any(p for ps in a["picks"] for p in ps):
        fail("async ledger run: no silo merged a peer")
    if not 0 < led_launches["wsum_q8"] == sum(led["int8_groups"]):
        fail(f"async ledger run: wsum_q8 launched "
             f"{led_launches['wsum_q8']} times for int8 peer groups "
             f"{led['int8_groups']}")
    for sid, v in a["global_accuracy"].items():
        if abs(v - b["global_accuracy"][sid]) > ACC_TOL:
            fail(f"async ledger run, {sid}: global accuracy {v} on the card "
                 f"vs {b['global_accuracy'][sid]} on the CPU")
    return {"launches": launches, "wall_s": wall}


def profile_async_wan() -> dict:
    """The Async WAN run once more, under ``torch.profiler``: the device's
    busy share of its wall time and the kernels that fill it. Its launches
    are not counted toward the path."""
    from repro_torch.kernels.profile_window import profiled
    with profiled() as prof:
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
    from repro_torch.kernels.profile_window import profiled
    orch = c4_experiment("cuda", rounds=1)
    torch.cuda.synchronize()
    with profiled() as prof:
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


def moe_ep_check(model, params) -> dict:
    """The MoE's EP shard body (``models/moe._moe_shard``, the
    reference's ``_moe_local_offset``) at full width, one expert block of
    the production ``model`` axis (16 ranks: 4 of 64 experts) after
    another, on layer 0's MoE input of 4 x 64 tokens, the partial outputs
    summed in rank order, against the one-device branch: the dispatch each
    block ran (its expert ids, its rows of the capacity buffer, its picks'
    slots) equal to the branch's for those experts, every kept pick run by
    exactly one block, and the sum within MOE_EP_ULPS bf16 ulps of the
    branch's largest entry (the partials add a token's experts in another
    order)."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(5)
    prompts, _ = request_inputs(cfg, 4, 64, g)
    lp = L.layer_at(params["layers"], 0)
    with torch.inference_mode():
        x = L.embed(params["embed"], prompts, cfg)
        pos = torch.arange(64, dtype=torch.int32, device="cuda").expand(4, 64)
        h, _ = L.attention_block(lp["attn"], L.rms_norm(
            x, lp["attn_norm"], cfg.norm_eps), cfg, positions=pos)
        xn = L.rms_norm(x + h, lp["mlp_norm"], cfg.norm_eps)
        x2 = xn.reshape(-1, cfg.d_model)
        local: dict = {}
        want, _ = moe._moe_local(lp["moe"], x2, cfg, local)
        e_per = cfg.moe.n_experts // MOE_EP_RANKS
        total, same = None, True
        runs = torch.zeros_like(local["slot"])
        for mi in range(MOE_EP_RANKS):
            lo = mi * e_per
            p_l = {k: (v if k == "router" else v[lo:lo + e_per])
                   for k, v in lp["moe"].items()}
            shard: dict = {}
            part, _ = moe._moe_shard(p_l, x2, cfg, lo, e_per, shard)
            mine = (local["idx"] >= lo) & (local["idx"] < lo + e_per)
            same &= torch.equal(shard["idx"], local["idx"]) and \
                torch.equal(shard["buf_idx"],
                            local["buf_idx"][lo:lo + e_per]) and \
                torch.equal(shard["slot"],
                            torch.where(mine, local["slot"], -1))
            runs += shard["slot"] >= 0
            total = part if total is None else total + part
        same &= torch.equal(runs, (local["slot"] >= 0).to(runs.dtype))
    top = float(want.float().abs().max())
    ulp = 2.0 ** (int(torch.tensor(top).log2().floor()) - 7)
    gap = float((total.float() - want.float()).abs().max())
    line = {"phase": f"moe-ep-{cfg.arch_id}", "ranks": MOE_EP_RANKS,
            "experts_a_rank": e_per, "tokens": list(prompts.shape),
            "capacity": moe._capacity(x2.shape[0], cfg),
            "dispatch_equal_local": bool(same), "max_abs_gap": gap,
            "gap_bf16_ulps": gap / ulp, "max_abs_out": top,
            "bit_identical": bool(torch.equal(total, want)),
            "check": "each block's expert ids, buffer rows and slots the "
                     "local branch's, each kept pick run once; gap <= "
                     f"{MOE_EP_ULPS} bf16 ulps of max|out|"}
    print(json.dumps(line), flush=True)
    if not same or not gap <= MOE_EP_ULPS * ulp:
        fail(f"moe-ep {cfg.arch_id}: {line}")
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
        if arch == MOE_EP_ARCH:
            moe_ep_check(model, params)
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
    from repro_torch.kernels.profile_window import profiled
    from repro_torch.launch.serve import serve
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts, frames = request_inputs(model.cfg, 4, 64, g)
    torch.cuda.synchronize()
    with profiled() as prof:
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


# --------------------------------------------------------------------------- #
# Phase 7: federated LM training
# --------------------------------------------------------------------------- #

def lm_experiment(cfg, data_vocab: int, device: str, init_generator=None,
                  exp=None, stream_len: int = LM_STREAM):
    """Sync UnifyFL of 3 silos x 2 clients over 3 Markov dialect streams of
    ``stream_len`` tokens at ``data_vocab``, int8 wire, loss scoring,
    top-2, at ``exp`` (LM_EXP by default): ``build_lm_experiment``'s silos
    through its helper, which takes the streams (here drawn below the
    model's vocabulary) and the generator of the common init."""
    from repro_torch.config import FedConfig
    from repro_torch.core.builder import _lm_experiment
    from repro_torch.data.synthetic import make_lm_dataset
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=LM_ROUNDS,
                    local_epochs=1, mode="sync", scorer="loss",
                    agg_policy="top_k", policy_k=2, compression="int8")
    streams = make_lm_dataset(vocab=data_vocab, length=stream_len,
                              n_dialects=fed.n_silos, seed=0)
    orch = _lm_experiment(cfg, fed, streams, **(exp or LM_EXP),
                          silo_specs=None,
                          seed=0, device=device,
                          init_generator=init_generator)
    # host compute off the simulated clock (as in phase 5): at full width
    # a silo's scoring (two fetches and decodes of 1.72 GB of codes) takes
    # longer on the host than the 5 s scorer deadline, so at time_scale 1
    # every score came late and nothing was picked (on an H100 80GB)
    for s in orch.silos:
        s.time_scale = 0.0
    return orch


def eval_losses(orch) -> list:
    return [s.cluster.evaluate()["loss"] for s in orch.silos]


def lm_reckoning(P: int, arch: str) -> dict:
    """Device bytes the 2-round run should peak at, from the parameter
    count P, at its three highest moments, all in round 2 (float32 silo
    models since round 1: a client's SGD step turns the bf16 init float32,
    as the reference's does). Each holds the 3 silos' models (12P) and the
    int8 payloads decoded in round 1 and kept in the stores' caches (6P).
    A silo's merge adds its flat vector, the delta, eta times the delta
    and the merged vector (16P): 34P. Its FedAvg adds the two clients'
    models (8P), their [2, N] stack (8P) and its average (4P): 38P. The
    backward of its second client's step adds the first client's model,
    the second's and its gradients (12P) and the step's saved activations
    and bf16 weight casts at seq 128, batch 8, and for RWKV-6 the
    backward's workspace (LM_STEP_GB of ``arch``): 30P + LM_STEP_GB.
    Each layer is rematerialised: its activations are saved only at the
    layer boundaries and recomputed a layer at a time in the backward."""
    state = {"silo_models_f32": 12 * P, "decoded_int8_caches": 6 * P}
    base = sum(state.values())
    moments = {"merge_gb": base + 16 * P, "fedavg_gb": base + 20 * P,
               "train_step_gb": base + 12 * P + LM_STEP_GB[arch] * 1e9}
    return {**{k: v / 1e9 for k, v in {**state, **moments}.items()},
            "total_gb": max(moments.values()) / 1e9}


# the reckoning's parts, told apart by the frames of the port that
# allocated a block, the first part that matches (the backward's own
# allocations have none; flatten_batch runs inside fedavg_params)
MEMORY_PARTS = (
    ("flat_vectors", ("flatten_batch",)),
    ("silo_models", ("fedavg_params", "fedopt.py")),
    ("decoded_int8_caches", ("decode_store",)),
    ("client_models", ("_descend",)),
    ("step_activations_and_casts", ("transformer.py", "layers.py",
                                    "rwkv6.py")),
    ("backward", ("outside the port",)),
)


def memory_at_peak(snap: dict, base: int) -> dict:
    """Replay the caching allocator's recorded trace of the card (``base``
    bytes were allocated when recording began): the highest allocated
    total, and the blocks live at that moment summed by the innermost
    three frames of the port in their Python stacks ("before" for blocks
    allocated before recording)."""
    trace = [e for e in snap["device_traces"][0]
             if e["action"] in ("alloc", "free_completed")]

    def site(e) -> str:
        fr = [f"{os.path.basename(f['filename'])}:{f['line']}"
              f"({f['name']})" for f in e.get("frames", [])
              if "repro_torch" in f["filename"]]
        return " < ".join(fr[:3]) or "outside the port"

    total, peak, at = base, base, -1
    for i, e in enumerate(trace):
        total += e["size"] if e["action"] == "alloc" else -e["size"]
        if total > peak:
            peak, at = total, i
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        else:
            live.pop(e["addr"], None)
    by_site: dict = {}
    for e in live.values():
        by_site[site(e)] = by_site.get(site(e), 0) + e["size"]
    by_site["before"] = peak - sum(by_site.values())
    parts: dict = {}
    for key, n in by_site.items():
        part = next((name for name, marks in MEMORY_PARTS
                     if any(m in key for m in marks)), "other")
        parts[part] = parts.get(part, 0) + n
    top = sorted(by_site.items(), key=lambda kv: -kv[1])[:12]
    return {"events": len(trace),
            "complete": len(snap["device_traces"][0]) < LM_MEM_EVENTS,
            "peak_gb": peak / 1e9,
            "peak_at": site(trace[at]) if at >= 0 else "before",
            "parts_gb": {k: v / 1e9 for k, v in parts.items()},
            "live_gb": {k: v / 1e9 for k, v in top}}


def time_mix_init(orch) -> list:
    """Each silo's time-mix leaves as they start, on the host (2.4 GB of
    bf16 for three silos of rwkv6-1.6b would count toward the card's
    peak)."""
    return [{k: s.cluster.params["layers"][k].to("cpu", copy=True)
             for k in TIME_MIX} for s in orch.silos]


def time_mix_moved(orch, init) -> dict:
    """For every silo and time-mix leaf, the layers whose slice differs
    from its init (none where the time-mix gradients are cut; at
    RWKV6_LR's 1e-5 a step of ``decay_base``, float32 entries in [-7,
    -1], mostly rounds away, so some of its layers keep their init)."""
    moved = {}
    for s, before in zip(orch.silos, init):
        for k, was in before.items():
            now = s.cluster.params["layers"][k]
            moved[f"{s.silo_id}/{k}"] = sum(
                bool((now[i].float() != was[i].to(now.device).float()).any())
                for i in range(now.shape[0]))
    return moved


def lm_passes(orch, fed_steps: int, remat: str) -> dict:
    """The forward and backward passes the run made, from its own records:
    a training step is one backward and ``layers.remat_forwards(remat)``
    forwards (two under remat 'full', the second the layers'
    recomputation; ``fed_steps`` steps); a scorer
    evaluates each model it was assigned on its W test windows, one
    forward a window (``fed.scorebatch``: starts every seq_len tokens, at
    most 4); each silo evaluates its own trained model on its W windows
    once a round (its self score, ``Silo.train_and_submit``)."""
    from repro_torch.models import layers as L
    seq = LM_EXP["seq_len"]

    def windows(silo):
        n = len(silo.cluster.test_data["tokens"])
        return len(range(0, min(n - seq - 1, 4 * seq), seq))

    w = {s.silo_id: windows(s) for s in orch.silos}
    scored = sum(w[sid] for e in orch.contract.models.values()
                 for sid in e.assigned)
    own = LM_ROUNDS * sum(w.values())
    return {"backward": fed_steps,
            "forward": L.remat_forwards(remat) * fed_steps + scored + own,
            "scoring_forwards": scored, "self_eval_forwards": own,
            "windows": w}


def lm_train_phase(tree, arch: str) -> dict:
    """``lm-train-<arch>``: 2 Sync rounds at full width and LM_DEPTH's
    depth on the card (a bf16
    init from a seeded generator on the card; float32 params after the
    first SGD step, as in the reference), with the launch counts set to 0
    just before; round 2 under ``torch.profiler`` (device idle share, top
    device operations); eval losses before and after (finite, and falling
    for every silo), every silo merging both peers in round 2, ledger,
    peak memory beside ``lm_reckoning``. RWKV-6 also: after round 1 every
    time-mix leaf of every silo moved from its init in every layer, and
    ``wkv6`` launched once a layer a forward pass, ``wkv6_backward`` once
    a layer a backward pass."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    rwkv = arch.startswith("rwkv6")
    # what earlier phases left in reference cycles would count toward the
    # peak (two runs of the whole script read 78.68 and 83.82 GB without
    # this, on an H100 80GB's 85.0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    # the allocator's trace for qwen3-1.7b only: recording it costs about
    # 10 s a round (its rounds timed with and without it on an H100 80GB),
    # and RWKV-6's peak is the same FedAvg moment of the same reckoning
    record = not rwkv
    if record:
        torch.cuda.memory._record_memory_history(max_entries=LM_MEM_EVENTS,
                                                 stacks="python")
    t0 = time.perf_counter()
    cfg = replace(get_config(arch), n_layers=LM_DEPTH[arch])
    exp = {**LM_EXP, "lr": RWKV6_LR} if rwkv else LM_EXP
    orch = lm_experiment(cfg, LM_DATA_VOCAB, "cuda",
                         torch.Generator(device="cuda").manual_seed(0),
                         exp=exp)
    build_s = time.perf_counter() - t0
    pre = eval_losses(orch)
    init = time_mix_init(orch) if rwkv else None
    # device activity only: with the CPU's op events too, reading a
    # round's profile back took longer than the two rounds on an H100
    # 80GB host
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks, moved = [], {}
    mark_round = orch._mark_round

    def timed_mark(rnd, silo_id=None):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if len(marks) == 1:
            if rwkv:   # off the clock: round 2 starts after it
                moved.update(time_mix_moved(orch, init))
                marks.append(time.perf_counter())
            prof.start()
        else:
            prof.stop()
        mark_round(rnd, silo_id)

    orch._mark_round = timed_mark
    _build.reset_launches()
    t0 = time.perf_counter()
    orch.run(LM_ROUNDS)
    launches = _build.launch_counts()
    walls = [marks[0] - t0, marks[-1] - marks[-2]]
    del init
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    post = eval_losses(orch)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    at_peak = None
    if record:
        at_peak = memory_at_peak(torch.cuda.memory._snapshot(),
                                 allocated_before)
        torch.cuda.memory._record_memory_history(enabled=None)
        at_peak["replay_s"] = time.perf_counter() - t0
    P = sum(t.numel() for t in tree.leaves(orch.silos[0].cluster.params))
    fed = orch.fed
    steps = LM_ROUNDS * fed.n_silos * fed.clients_per_silo * \
        fed.local_epochs * LM_EXP["steps_per_epoch"]
    passes = lm_passes(orch, steps, cfg.remat)
    want = {"wkv6": cfg.n_layers * passes["forward"] if rwkv else 0,
            "wkv6_backward": cfg.n_layers * passes["backward"] if rwkv
            else 0}
    line = {"phase": f"lm-train-{arch}", "rounds": LM_ROUNDS,
            "silos": "3x2", "compression": "int8", "scorer": "loss",
            "policy": "top_k, k=2", **exp, "local_epochs": 1,
            "stream_len": LM_STREAM, "data_vocab": LM_DATA_VOCAB,
            "params": P, "build_s": build_s, "round_wall_s": walls,
            "profiled_round": 2, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / walls[1],
            "top_device_ops": [{"name": e.key[:80], "count": e.count,
                                "ms": e.self_device_time_total / 1e3}
                               for e in top],
            # the ported kernels' own device time in the profiled round
            # (the chunk and du kernels' include their wait for the kernel
            # ahead of them: programmatic dependent launch)
            "ported_kernel_ops": [
                {"name": k, "count": sum(e.count for e in kern if k in e.key),
                 "ms": sum(e.self_device_time_total for e in kern
                           if k in e.key) / 1e3}
                for k in ("wkv6_kernel", *WKV6_BWD_KERNELS)] if rwkv else [],
            "eval_loss_before": pre, "eval_loss_after": post,
            "ledger_height": orch.ledger.height,
            "verify": orch.ledger.verify(),
            "picks": [s.pick_log for s in orch.silos],
            "launches": launches, "passes": passes,
            "wkv6_launches_predicted": want,
            **({"time_mix_layers_moved_after_round_1": moved}
               if rwkv else {}),
            "allocated_before_gb": allocated_before / 1e9,
            "peak_memory_gb": peak / 1e9, "reckoned": lm_reckoning(P, arch),
            "at_peak": at_peak,
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip(),
            "reduced": {"data_vocab":
                        f"{cfg.vocab_size:,} -> {LM_DATA_VOCAB:,}"}}
    print(json.dumps(line), flush=True)
    if P != LM_PARAMS[arch]:
        fail(f"{arch}: {P} params, want {LM_PARAMS[arch]}")
    if peak / 1e9 > line["reckoned"]["total_gb"] * (1 + LM_MEM_MARGIN) or \
            (record and not at_peak["complete"]):
        fail(f"LM training run: peak {peak / 1e9:.2f} GB against "
             f"{line['reckoned']['total_gb']:.2f} GB reckoned: {at_peak}")
    if not line["verify"]:
        fail("LM training run: ledger does not verify")
    line["eval_loss_change"] = [b - a for a, b in zip(pre, post)]
    if not all(torch.isfinite(torch.tensor(pre + post))) or not (
            rwkv or all(b < a for a, b in zip(pre, post))):
        fail(f"LM training run: eval losses {pre} -> {post}")
    for s in orch.silos:
        if any(t.device.type != "cuda" or t.dtype != torch.float32
               for t in tree.leaves(s.cluster.params)):
            fail(f"{s.silo_id}: params left the card or are not float32")
        if s.pick_log[-1]["owners"] != sorted(
                o.silo_id for o in orch.silos if o is not s):
            fail(f"{s.silo_id}: round 2 picked {s.pick_log[-1]}")
    missing = [k for k in ("weighted_sum", "quantize", "dequantize",
                           "wsum_q8") if launches[k] == 0]
    if missing:
        fail(f"LM training run never launched {missing}")
    if any(launches[k] != n for k, n in want.items()):
        fail(f"LM training run: wkv6 launches {launches}, want {want}")
    if rwkv and (len(moved) != len(orch.silos) * len(TIME_MIX) or any(
            n == 0 for n in moved.values())):
        fail(f"LM training run: time-mix leaves left as they were: {moved}")
    del orch
    torch.cuda.empty_cache()
    return line


def lm_grads(model, params, batch) -> dict:
    """One client step's gradients: ``torch.autograd.grad`` of the loss,
    as ``fed.client.make_train_step`` takes them, by leaf path."""
    from repro_torch.tree import leaves_with_paths, unflatten
    paths, leaves = zip(*leaves_with_paths(params))
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss, _ = model.loss(unflatten(list(paths), leaves), batch)
    return dict(zip(paths, torch.autograd.grad(loss, leaves)))


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over max |want| (on want's device)."""
    return {"/".join(p): float((got[p].to(g.device).float() - g.float())
                               .abs().max()
                               / max(float(g.float().abs().max()), 1e-30))
            for p, g in want.items()}


class ChunkOrderScan(torch.autograd.Function):
    """The plain scan with its forward's float32 sums taken in the wkv6
    kernel's chunked order (``ref.wkv6_subchunks``) and the plain reverse
    scan as its backward: the same function as ``ref.wkv6_naive`` up to
    rounding, the witness of how far a step's gradients move when only
    the order of the forward's sums changes."""

    @staticmethod
    def forward(r, k, v, w, u, state):
        from repro_torch.kernels import ref
        return ref.wkv6_subchunks(r, k, v, w, u, state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, dstate):
        from repro_torch.kernels import ref
        return ref.wkv6_backward_naive(*ctx.saved_tensors, dy, dstate)


def rwkv6_step_check() -> dict:
    """One client step of ``rwkv6-1.6b`` at full width, on a batch drawn
    as a client draws it (B 8, T 128) from a stream of the phase's data,
    from the phase's init (the same seeded generator on the card), through
    the kernels, held against the plain scan on the card, at each
    (dtype, depth) of RWKV6_STEP_TOL.

    Every call of the step: each ``wkv6`` forward against
    ``ref.wkv6_naive`` and each ``wkv6_backward`` against
    ``ref.wkv6_backward_naive`` on the very operands and cotangent the
    step hands the kernel, by check_wkv6's and check_wkv6_backward's
    rules: two ``wkv6`` launches a layer (its forward and, each layer
    rematerialised, its recomputation in the backward) and one
    ``wkv6_backward``. The whole step's gradients: the
    kernel path against the plain path (autograd of ``ref.wkv6_naive``),
    every leaf within the depth's tolerance of its largest entry, with the
    gap of ``ChunkOrderScan`` to the plain path beside it. At the full
    depth in bf16 (tolerance None) the three paths' gradients are printed,
    ungated: there the step's gradients turn on the rounding of the
    forward, and the plain scan is no better a yardstick than the
    kernel."""
    from repro_torch.config import replace
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.fed.client import Client
    from repro_torch.kernels import _build, ops, ref, rwkv6
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    t0 = time.perf_counter()
    stream = make_lm_dataset(vocab=LM_DATA_VOCAB, length=LM_STREAM,
                             seed=0)[0]
    fwd, bwd = rwkv6.forward, rwkv6.backward
    calls = {"wkv6": [], "wkv6_backward": []}

    def witnessed_forward(*args):
        y, s = fwd(*args)
        calls["wkv6"].append(wkv6_y_state_errors(
            y, s, *ref.wkv6_naive(*args)))
        return y, s

    def witnessed_backward(r, k, v, w, u, s, dy, ds=None, needs=(True,) * 6):
        got = bwd(r, k, v, w, u, s, dy, ds, needs)
        calls["wkv6_backward"].append(wkv6_grad_errors(
            got, ref.wkv6_backward_naive(r, k, v, w, u, s, dy, ds)))
        return got

    def through(wkv, model, params, batch):
        was = ops.wkv6
        ops.wkv6 = wkv
        try:
            return lm_grads(model, params, batch)
        finally:
            ops.wkv6 = was

    max_grad = lambda g: max(float(t.float().abs().max())
                             for t in g.values())
    rows, fails = [], []
    for (dtype, n), tol in RWKV6_STEP_TOL.items():
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(replace(get_config("rwkv6-1.6b"), n_layers=n,
                                    param_dtype=dtype, compute_dtype=dtype))
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        batch = next(Client("c", model, {"tokens": stream,
                                         "seq_len": LM_EXP["seq_len"],
                                         "steps_per_epoch": 1},
                            device="cuda",
                            batch_size=LM_EXP["batch_size"])._batches(1))
        for rows_of in calls.values():
            rows_of.clear()
        rwkv6.forward, rwkv6.backward = witnessed_forward, witnessed_backward
        _build.reset_launches()
        try:
            kernel = lm_grads(model, params, batch)
        finally:
            rwkv6.forward, rwkv6.backward = fwd, bwd
        torch.cuda.synchronize()
        launches = {k: _build.launch_counts()[k] for k in calls}
        plain = through(ref.wkv6_naive, model, params, batch)
        order = through(ChunkOrderScan.apply, model, params, batch)
        gaps = leaf_gaps(kernel, plain)
        bwd_rows = calls["wkv6_backward"]
        row = {"dtype": dtype, "layers": n, "tol": tol,
               "kernel_vs_plain_max_gap": max(gaps.values()),
               "worst_leaf": max(gaps, key=gaps.get),
               "chunk_order_vs_plain_max_gap":
                   max(leaf_gaps(order, plain).values()),
               "kernel_vs_chunk_order_max_gap":
                   max(leaf_gaps(kernel, order).values()),
               "max_abs_grad": {"kernel": max_grad(kernel),
                                "plain": max_grad(plain),
                                "chunk_order": max_grad(order)},
               "launches": launches,
               "per_call_max_rel_err": {
                   "y": max(c["max_abs_err_y"] / max(c["max_abs_y"], 1e-30)
                            for c in calls["wkv6"]),
                   "state": max(c["max_abs_err_state"]
                                / max(c["max_abs_state"], 1e-30)
                                for c in calls["wkv6"]),
                   **{name: max(c[name]["max_abs_err"]
                                / max(c[name]["max_abs"], 1e-30)
                                for c in bwd_rows)
                      for name in bwd_rows[0]}},
               "per_call_failed": [
                   (k, i) for k, rs in calls.items()
                   for i, c in enumerate(rs)
                   if not (c["ok"] if k == "wkv6" else
                           all(e["ok"] for e in c.values()))]}
        rows.append(row)
        if row["per_call_failed"] or launches != {
                "wkv6": L.remat_forwards(model.cfg.remat) * n,
                "wkv6_backward": n} or \
                (tol is not None and not row["kernel_vs_plain_max_gap"]
                 <= tol):
            fails.append(f"{dtype} x {n} layers")
        del kernel, plain, order, params, model
    gc.collect()
    torch.cuda.empty_cache()
    line = {"phase": "lm-train-rwkv6-1.6b-step-vs-plain",
            "seq_len": LM_EXP["seq_len"],
            "batch_size": LM_EXP["batch_size"], "by_depth": rows,
            "s": time.perf_counter() - t0,
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()}
    print(json.dumps(line), flush=True)
    if fails:
        fail(f"RWKV-6 full-width step against the plain scan: {fails}: "
             f"{line}")
    return line


def rwkv6_smoke_grads(params, batch, device: str) -> dict:
    """One client step's gradients (``torch.autograd.grad`` of the loss,
    as ``fed.client.make_train_step`` takes them) of RWKV-6's smoke preset
    in float32, on ``device``."""
    from repro_torch.config import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg = replace(get_smoke_config("rwkv6-1.6b"), param_dtype="float32",
                  compute_dtype="float32")
    return lm_grads(build_model(cfg), tree_map(lambda a: a.to(device),
                                               params),
                    {k: a.to(device) for k, a in batch.items()})


def rwkv6_grad_check() -> dict:
    """One client step of RWKV-6's smoke preset in float32, card against
    CPU, from the same init and the client's own first batch (a Markov
    stream, as the client draws it; both made on the CPU): every leaf's
    gradient within GRAD_REL of its largest entry, every time-mix gradient
    nonzero, ``wkv6`` launched once a layer's forward (``cfg.remat``
    'full' runs it twice a step) and ``wkv6_backward`` once a layer. Beside
    it, the CPU's own move at that point when the params move by
    CHAOS_EPS relative (the model's conditioning, ungated)."""
    import numpy as np
    from repro_torch.config import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.fed.client import Client
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_map
    cfg = replace(get_smoke_config("rwkv6-1.6b"), param_dtype="float32",
                  compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    stream = make_lm_dataset(vocab=cfg.vocab_size, length=2000, seed=0)[0]
    client = Client("c", model, {"tokens": stream, "seq_len": 32,
                                 "steps_per_epoch": 1}, device="cpu",
                    batch_size=2)
    batch = next(client._batches(1))
    _build.reset_launches()
    card = rwkv6_smoke_grads(params, batch, "cuda")
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    cpu = rwkv6_smoke_grads(params, batch, "cpu")
    rng = np.random.default_rng(5)
    moved = rwkv6_smoke_grads(tree_map(lambda t: t * torch.from_numpy(
        1 + CHAOS_EPS * rng.standard_normal(tuple(t.shape))).float(),
        params), batch, "cpu")
    err, self_err = leaf_gaps(card, cpu), leaf_gaps(moved, cpu)
    zero = [p[-1] for p, g in card.items()
            if p[-1] in TIME_MIX and float(g.abs().max()) == 0.0]
    line = {"phase": "lm-train-rwkv6-1.6b-smoke-grads-vs-cpu",
            "max_rel_err": max(err.values()),
            "worst_leaf": max(err, key=err.get), "rel_err": err,
            "grad_rel": GRAD_REL, "zero_time_mix_grads": zero,
            "cpu_self_max_rel_err": max(self_err.values()),
            "cpu_self_eps": CHAOS_EPS,
            "launches": {k: launches[k] for k in ("wkv6", "wkv6_backward")}}
    print(json.dumps(line), flush=True)
    if line["max_rel_err"] > GRAD_REL or zero or \
            line["launches"] != {
                "wkv6": L.remat_forwards(cfg.remat) * cfg.n_layers,
                "wkv6_backward": cfg.n_layers}:
        fail(f"RWKV-6 gradients, card against CPU: {line}")
    return line


def lm_cross_check_cpu(arch: str) -> dict:
    """The same 2-round run at the smoke preset in float32 (vocabulary 256,
    its streams at 256) on the card and on the CPU, from the same init
    drawn on the CPU: equal picks and ledger height, and every silo's eval
    loss within LM_LOSS_TOL. ``qwen3-1.7b`` at LM_EXP (losses near 5.5;
    float32 sums in another order over 16 SGD steps a client and two int8
    merges), held before and after both rounds, and its parameters after
    round 2 within LM_PARAM_RTOL of the CPU's (the norm of the difference
    over the norm). RWKV-6 at the settings of
    ``tests/test_torch_lm_train_recurrent.py`` (RECURRENT_EXP), held after
    round 1 only, to its LM_LOSS_TOL (the losses before training come from
    one init on both sides and are printed): its round-2 losses are
    chaotic on any device (a CHAOS_EPS relative move of the CPU run's init
    moves them by 0.040 on the CPU), so their gap is printed beside the
    CPU's own under that move, ungated."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.config import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.tree import leaves as tree_leaves
    cfg = replace(get_smoke_config(arch), param_dtype="float32",
                  compute_dtype="float32")
    rwkv = arch.startswith("rwkv6")
    exp, stream = (RECURRENT_EXP, RECURRENT_STREAM) if rwkv else \
        (LM_EXP, LM_STREAM)
    runs = {}
    for dev in ("cuda", "cpu") + (("cpu-moved",) if rwkv else ()):
        orch = lm_experiment(cfg, cfg.vocab_size, dev.split("-")[0],
                             exp=exp, stream_len=stream)
        if dev == "cpu-moved":
            rng = np.random.default_rng(5)
            for s in orch.silos:
                for t in tree_leaves(s.cluster.params):
                    t.mul_(torch.from_numpy(1 + CHAOS_EPS * rng.standard_normal(
                        tuple(t.shape))).to(t.dtype))
        losses = [eval_losses(orch)]
        mark = orch._mark_round

        def eval_mark(rnd, silo_id=None, orch=orch, losses=losses,
                      mark=mark):
            if rnd < LM_ROUNDS:
                losses.append(eval_losses(orch))
            mark(rnd, silo_id)

        orch._mark_round = eval_mark
        orch.run(LM_ROUNDS)
        runs[dev] = (orch, losses + [eval_losses(orch)])
    (card, closs), (cpu, ploss) = runs["cuda"], runs["cpu"]
    gap = lambda a, b: [max(abs(x - y) for x, y in zip(ra, rb))
                        for ra, rb in zip(a, b)]
    param_rel = []
    for a, b in zip(card.silos, cpu.silos):
        va = ops.flatten_pytree(a.cluster.params)[0].cpu().double()
        vb = ops.flatten_pytree(b.cluster.params)[0].double()
        param_rel.append(float((va - vb).norm() / vb.norm()))
    rtol = None if rwkv else LM_PARAM_RTOL
    held = slice(1, 2) if rwkv else slice(None)     # rounds held
    line = {"phase": f"lm-train-{arch}-smoke-cross-check-cpu",
            **exp, "stream_len": stream,
            "picks_equal": [s.pick_log for s in card.silos]
            == [s.pick_log for s in cpu.silos],
            "ledger_height": [card.ledger.height, cpu.ledger.height],
            "eval_loss_card": closs, "eval_loss_cpu": ploss,
            "loss_gap_by_round": gap(closs, ploss),
            "max_loss_diff": max(gap(closs, ploss)[held]),
            "held_rounds": list(range(len(closs)))[held],
            "tol": LM_LOSS_TOL[arch],
            "param_rel_diff": param_rel, "param_rtol": rtol}
    if rwkv:
        line["cpu_moved_loss_gap_by_round"] = gap(runs["cpu-moved"][1],
                                                  ploss)
        line["cpu_moved_eps"] = CHAOS_EPS
    print(json.dumps(line), flush=True)
    if not (line["picks_equal"] and card.ledger.height == cpu.ledger.height
            and card.ledger.verify()
            and line["max_loss_diff"] <= LM_LOSS_TOL[arch]
            and (rtol is None or max(param_rel) <= rtol)):
        fail(f"LM training: the card and the CPU differ: {line}")
    return line


def lm_train_cli(arch: str) -> dict:
    """The user's entry point, ``python -m repro_torch.launch.train
    --workload lm --arch <arch> --preset smoke`` (2 rounds, int8, loss
    scoring, top-k) on the card, with the launch counts set to 0 first."""
    from repro_torch.kernels import _build
    from repro_torch.launch.train import main as train_main
    _build.reset_launches()
    ge = train_main(["--workload", "lm", "--arch", arch, "--preset",
                     "smoke", "--rounds", "2", "--scorer", "loss",
                     "--policy", "top_k", "--compression", "int8"])
    line = {"phase": "lm-train-cli" + ("" if arch == LM_ARCH else
                                       f"-{arch}"), "global_eval": ge,
            "launches": _build.launch_counts()}
    print(json.dumps(line), flush=True)
    need = ["weighted_sum", "quantize", "dequantize", "wsum_q8"]
    if arch.startswith("rwkv6"):
        need += ["wkv6", "wkv6_backward"]
    if sorted(ge) != ["silo0", "silo1", "silo2"] or any(
            line["launches"][k] == 0 for k in need):
        fail(f"LM training CLI: {line}")
    return line


# --------------------------------------------------------------------------- #
# Phase 8: the multi-pod UnifyFL round step
# --------------------------------------------------------------------------- #

# qwen3-1.7b at its published width, P pods stacked on the card: 2, the
# reference's production pod count (repro/launch/mesh.py, (2, 16, 16)),
# each pod its own init and batch (tokens, targets rolled by one); one
# round step at lr 0.1 in each configuration of the reference's own test
# (tests/test_exchange.py). `reduced`: a pod's batch is 4 x 512 tokens
# against train_4k's 128 x 4,096 (repro/config.py, LM_SHAPES), so that one
# card holds both pods; the score batch is ExchangeConfig.score_batch = 2
# rows of it
POD_P = 2
POD_BATCH = (4, 512)
POD_LR = 0.1
POD_CONFIGS = {"all": dict(policy="all"),
               "top_k": dict(policy="top_k", k=1),
               "top_k-int8": dict(policy="top_k", k=1, compression="int8"),
               "above_average-multikrum": dict(policy="above_average",
                                               scorer="multikrum")}
POD_INT8_TOL = 0.05    # int8 round against the uncompressed one (the test's)
POD_SERVE = (4, 64, 8)  # a pod's prefill batch and prompt, decode steps
POD_CPU_RTOL = 1e-5    # merged params, card vs CPU, of each leaf's max|.|
# one train step's own peak bytes above its params at 4 x 512 (activations,
# the attention's scores padded to a 1,024-key chunk, bf16 gradients, the
# new params), each layer rematerialised (cfg.remat 'full'): 10.42 GB a
# step, reckoned by launch/opstats.mem_tracker over the step under fake
# tensors (the same reckoning without remat gives 24.74 GB, the step
# measured by the `all` round's steps computed apart, check_all_round's
# step_gb, on an H100 80GB before remat was ported)
POD_STEP_GB = 10.42


def pod_stack(model, P: int, device: str, seed: int = 100):
    """P inits of ``model`` from the seeded generators seed .. seed + P - 1
    on ``device``, stacked [P, ...] leaf by leaf (one init at a time)."""
    from repro_torch import tree
    stack = None
    for i in range(P):
        p = model.init(torch.Generator(device=device).manual_seed(seed + i),
                       device)
        if stack is None:
            stack = tree.tree_map(lambda x: torch.empty(
                (P,) + tuple(x.shape), dtype=x.dtype, device=device), p)
        tree.tree_map(lambda o, x: o[i].copy_(x), stack, p)
        del p
    return stack


def pod_batch(cfg, P: int, rows: int, seq: int, seed: int, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (P, rows, seq), generator=g,
                         device=device)
    return {"tokens": toks, "targets": torch.roll(toks, -1, dims=2)}


def pod_reckoning(N: int, P: int) -> dict:
    """Device bytes the int8 round step should peak at, from the parameter
    count N (bf16: a model Bm = 2N bytes). Held by the phase throughout:
    the P pods and the uncompressed ``top_k`` round's merged stack, kept
    for the int8 gate (2 P Bm). Training pod i adds the trained stack (P
    Bm, allocated first) and the step's own live bytes (POD_STEP_GB); the
    merge adds, beside the trained stack, the dequantized stack (P Bm),
    the merged stack (P Bm) and one pod's merged tree before its copy
    (Bm)."""
    Bm = 2 * N
    held = 2 * P * Bm
    moments = {"train_gb": held + P * Bm + POD_STEP_GB * 1e9,
               "merge_gb": held + 3 * P * Bm + Bm}
    return {"held_gb": held / 1e9, **{k: v / 1e9 for k, v in moments.items()},
            "total_gb": max(moments.values()) / 1e9}


def leaf_max_rel(a, b) -> float:
    """max|a - b| over max|b| (float32 views)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def check_all_round(model, stack, batch, out) -> dict:
    """``all``: each pod's merged leaves are the float32 mean of the P pods'
    ``make_train_step`` outputs, computed apart, to one bf16 ulp of the
    leaf's largest entry, and the pods agree bit for bit. Returns the gap
    and each step's own peak bytes above its params."""
    from repro_torch import tree
    from repro_torch.core.exchange import _pod, make_train_step
    ts = make_train_step(model, POD_LR)
    apart, step_gb = [], []
    for i in range(POD_P):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        apart.append(ts(_pod(stack, i), _pod(batch, i))[0])
        torch.cuda.synchronize()
        step_gb.append((torch.cuda.max_memory_allocated() - before) / 1e9)
    gap, rounded = 0.0, True
    for o, *pods in zip(tree.leaves(out), *(tree.leaves(t) for t in apart)):
        mean = pods[0].float()
        for q in pods[1:]:
            mean = mean + q.float()
        mean = mean * (1.0 / POD_P)
        gap = max(gap, leaf_max_rel(o[0], mean))
        rounded &= torch.equal(o[0], mean.to(o.dtype))
        if not all(torch.equal(o[0], o[i]) for i in range(1, POD_P)):
            fail("pod round all: the pods' merged params differ")
    if not gap <= BF16_ULP:
        fail(f"pod round all: {gap} of a leaf's largest entry from the mean "
             f"of the pods trained apart, over one bf16 ulp")
    return {"gap_to_mean_apart": gap, "equal_to_rounded_mean": bool(rounded),
            "step_gb": step_gb}


def check_scored_round(out, info) -> float:
    """A scored round: every W row sums to 1 within 1e-6, and each pod's
    merged leaves are ``ref.weighted_sum_ordered`` of the gathered stack
    and its W row, bit for bit (2^26 columns at a time). Returns the
    largest gap to the plain merge (``ref.weighted_sum``), of each leaf's
    largest entry."""
    from repro_torch import tree
    from repro_torch.kernels import ref
    W = info["weights"]
    if not float((W.sum(dim=1) - 1.0).abs().max()) <= 1e-6:
        fail(f"pod round: W rows do not sum to 1: {W.tolist()}")
    gap = 0.0
    for (path, g), o in zip(tree.leaves_with_paths(info["gathered"]),
                            tree.leaves(out)):
        x, o = g.reshape(POD_P, -1), o.reshape(POD_P, -1)
        for i in range(POD_P):
            for a, b in chunks(x.shape[1], 1 << 26):
                xc = x[:, a:b]
                if not torch.equal(o[i, a:b], ref.weighted_sum_ordered(
                        xc, W[i]).to(g.dtype)):
                    fail(f"pod round: {'/'.join(path)} of pod {i} is not the "
                         f"ordered weighted sum in [{a}, {b})")
                gap = max(gap, leaf_max_rel(o[i, a:b],
                                            ref.weighted_sum(xc, W[i])))
    return gap


def check_int8_round(out, out_topk, info) -> dict:
    """int8: every leaf within POD_INT8_TOL of the uncompressed ``top_k``
    round, and each pod's codes round-trip each leaf within
    amax / 127 * 0.51."""
    from repro_torch import tree
    from repro_torch.core.exchange import _dq8, _q8
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(tree.leaves(out), tree.leaves(out_topk)))
    worst = 0.0
    for leaf in tree.leaves(info["trained"]):
        for i in range(POD_P):
            x = leaf[i].float()
            q, sc = _q8(leaf[i])
            amax = float(x.abs().max())
            err = float((_dq8(q, sc, torch.float32) - x).abs().max())
            worst = max(worst, err / max(amax / 127, 1e-30))
    if not gap < POD_INT8_TOL or not worst <= 0.51:
        fail(f"pod round int8: {gap} from the uncompressed round (bound "
             f"{POD_INT8_TOL}), code round trip {worst} x amax/127")
    return {"gap_to_uncompressed": gap, "round_trip_of_amax_127": worst}


def pod_serve_phase(model, stack) -> dict:
    """``make_pod_serve_step``: each pod prefills 4 x 64 tokens, its cache
    padded to 64 + 8 as ``serve`` pads it, then 8 greedy decode steps; each
    pod's prefill and decode logits equal ``model.prefill`` /
    ``model.decode_step`` on that pod's params alone, bit for bit."""
    from repro_torch import tree
    from repro_torch.core.exchange import _pod, make_pod_serve_step
    from repro_torch.launch.serve import pad_cache
    B, S, steps = POD_SERVE
    toks = pod_batch(model.cfg, POD_P, B, S, seed=21)["tokens"]
    pre = make_pod_serve_step(model, None, "prefill")
    dec = make_pod_serve_step(model, None, "decode")

    def padded(cache, lead=()):
        full = tree.tree_map(lambda c: torch.zeros(
            lead + tuple(c.shape), dtype=c.dtype, device="cuda"),
            model.init_cache(B, S + steps, "cuda"))
        return pad_cache(full, cache)

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = pre(stack, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache = padded(cache, (POD_P,))
        ids, steps_logits = logits[:, :, -1].argmax(-1), []
        t0 = time.perf_counter()
        for s in range(steps):
            out, cache = dec(stack, {"token": ids, "pos": S + s}, cache)
            steps_logits.append(out)
            ids = out.argmax(-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        same = True
        for i in range(POD_P):
            p = _pod(stack, i)
            alone, c = model.prefill(p, {"tokens": toks[i]})
            same &= torch.equal(alone, logits[i])
            c, nxt = padded(c), alone[:, -1].argmax(-1)
            for s in range(steps):
                alone, c = model.decode_step(p, {"token": nxt, "pos": S + s},
                                             c)
                same &= torch.equal(alone, steps_logits[s][i])
                nxt = alone.argmax(-1)
    line = {"phase": f"pod-serve-{model.cfg.arch_id}", "pods": POD_P,
            "batch": B, "prompt_len": S, "decode_steps": steps,
            "prefill_s": prefill_s, "decode_s_per_step": decode_s / steps,
            "equal_to_each_pod_alone": bool(same),
            "finite": bool(torch.isfinite(logits).all()),
            "device": torch.cuda.get_device_name(0)}
    print(json.dumps(line), flush=True)
    if not same or not line["finite"]:
        fail("pod serve step: a pod's logits differ from its own serving, or "
             "are not finite")
    return line


def pod_merge_row(info) -> dict:
    """``weighted_sum`` at the pod merge's operand: M = 2, the bf16
    embedding leaf of ``qwen3-1.7b`` (153,600 x 2,048, the vocabulary padded)
    as the round gathered it, W row 0 on the card; CUDA events (kernel,
    plain, ``torch.tensordot`` as the reference writes the merge), the
    profiler's device time a launch, the bytes bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wsum import weighted_sum
    x = info["gathered"]["embed"]["embedding"].reshape(POD_P, -1)
    w = info["weights"][0].contiguous()
    fns = {"kernel": lambda: weighted_sum(x, w),
           "plain": lambda: ref.weighted_sum(x, w),
           "library": lambda: torch.tensordot(
               w, x.to(torch.float32), dims=([0], [0])).to(x.dtype)}
    ts = timed(fns, 10, reps=3)
    dev = device_time(fns["kernel"], expect={"weighted_sum": 1})
    M, N = x.shape
    b_ms, b_by = bound((M + 1) * N * x.element_size(), 2.0 * M * N)
    line = {"phase": "pod-merge-weighted_sum", "M": M, "N": N,
            "dtype": str(x.dtype), "ms": ts["kernel"],
            "dev_us": dev["device_us_per_launch"], "plain_ms": ts["plain"],
            "library_ms": ts["library"], "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ts["kernel"],
            "bit_equal_to_ordered": bool(torch.equal(
                fns["kernel"](), ref.weighted_sum_ordered(x, w).to(x.dtype))),
            "device": torch.cuda.get_device_name(0)}
    print(json.dumps(line), flush=True)
    if not line["bit_equal_to_ordered"]:
        fail("pod merge row: weighted_sum is not its ordered FMA chain")
    return line


def pod_profile(model, stack, batch) -> dict:
    """One ``top_k`` round step under ``torch.profiler``: the device's busy
    share of its wall time and the operations that fill it (a profile
    that saw no kernel is taken again, as ``device_time`` does)."""
    from repro_torch.core.exchange import (ExchangeConfig,
                                           make_unifyfl_round_step)
    from repro_torch.kernels.profile_window import profiled
    step = make_unifyfl_round_step(model, None,
                                   ExchangeConfig(**POD_CONFIGS["top_k"]),
                                   POD_LR)
    for _ in range(PROFILE_TRIES):
        with profiled() as prof:
            t0 = time.perf_counter()
            out, _ = step(stack, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del out
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern:
            break
    else:
        fail("the profiler saw no kernel of the pod round in "
             f"{PROFILE_TRIES} tries")
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    wsum = [e for e in kern if "weighted_sum_kernel" in e.key]
    line = {"phase": f"profile-pod-round-{model.cfg.arch_id}-top_k",
            "wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_kernels": len(kern),
            "device_launches": sum(e.count for e in kern),
            "weighted_sum_kernel": {
                "count": sum(e.count for e in wsum),
                "ms": sum(e.self_device_time_total for e in wsum) / 1e3},
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}
    print(json.dumps(line), flush=True)
    return line


def pod_cross_check_cpu() -> dict:
    """``pod-round-smoke-cross-check-cpu``: the four round steps at the
    float32 smoke preset, the same pods and batch on the card and on the
    CPU: merged params within POD_CPU_RTOL of each leaf's largest entry,
    W equal."""
    from repro_torch import tree
    from repro_torch.config import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.exchange import (ExchangeConfig,
                                           make_unifyfl_round_step)
    from repro_torch.models import build_model
    model = build_model(replace(get_smoke_config(LM_ARCH),
                                param_dtype="float32",
                                compute_dtype="float32"))
    stack = pod_stack(model, POD_P, "cpu")
    batch = pod_batch(model.cfg, POD_P, 4, 32, seed=7, device="cpu")
    on_card = lambda t: tree.tree_map(lambda x: x.to("cuda"), t)
    rows = {}
    for name, kw in POD_CONFIGS.items():
        step = make_unifyfl_round_step(model, None, ExchangeConfig(**kw),
                                       POD_LR)
        ic, ih = {}, {}
        oc, lc = step(on_card(stack), on_card(batch), ic)
        oh, lh = step(stack, batch, ih)
        gap = max(leaf_max_rel(a.cpu(), b) for a, b in
                  zip(tree.leaves(oc), tree.leaves(oh)))
        w_equal = ("weights" not in ic and "weights" not in ih) or \
            torch.equal(ic["weights"].cpu(), ih["weights"])
        rows[name] = {"merged_max_rel": gap, "w_equal": w_equal,
                      "loss_gap": float((lc.cpu() - lh).abs().max())}
    line = {"phase": "pod-round-smoke-cross-check-cpu", "pods": POD_P,
            "rows": rows}
    print(json.dumps(line), flush=True)
    for name, r in rows.items():
        if not (r["merged_max_rel"] <= POD_CPU_RTOL and r["w_equal"]):
            fail(f"pod round {name}: card vs CPU {r}")
    return line


def pod_round_phase(tree, after_timed) -> dict:
    """``pod-round-qwen3-1.7b-*``: one round step of two stacked pods of
    ``qwen3-1.7b`` at full width in each configuration of POD_CONFIGS, the
    launch counts set to 0 just before each; their gates; the merge's
    ``weighted_sum`` row; a profiled ``top_k`` round; then
    ``after_timed()``, once every timed and profiled row is done; the pod
    serve step; the smoke preset against the CPU. Returns the launches of
    the four rounds, summed."""
    from repro_torch.configs import get_config
    from repro_torch.core.builder import resolve_device
    from repro_torch.core.exchange import (ExchangeConfig,
                                           make_unifyfl_round_step)
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    resolve_device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(get_config(LM_ARCH))
    t0 = time.perf_counter()
    stack = pod_stack(model, POD_P, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t[0].numel() for t in tree.leaves(stack))
    n_leaves = len(tree.leaves(stack))
    print(json.dumps({"phase": f"init-pods-{LM_ARCH}", "pods": POD_P,
                      "params_a_pod": n_params, "leaves": n_leaves,
                      "init_s": time.perf_counter() - t0}), flush=True)
    if n_params != FAMILY_PARAMS[LM_ARCH][0]:
        fail(f"pods of {LM_ARCH}: {n_params} params a pod")
    batch = pod_batch(model.cfg, POD_P, *POD_BATCH, seed=5)
    totals, peaks, kept = {}, {}, {}
    for name, kw in POD_CONFIGS.items():
        step = make_unifyfl_round_step(model, None, ExchangeConfig(**kw),
                                       POD_LR)
        info: dict = {}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        out, losses = step(stack, batch, info)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _build.launch_counts()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        line = {"phase": f"pod-round-{LM_ARCH}-{name}", "pods": POD_P,
                "batch": list(POD_BATCH), "lr": POD_LR, "config": kw,
                "wall_s": wall, "losses": losses.tolist(),
                "scores": info["scores"].tolist()
                if info.get("scores") is not None else None,
                "weights": info["weights"].tolist()
                if "weights" in info else None,
                "weighted_sum_launches": launches["weighted_sum"],
                "launches": launches, "peak_mem_gb": peaks[name]}
        want = 0 if name == "all" else POD_P * n_leaves
        if launches["weighted_sum"] != want or sum(launches.values()) != want:
            print(json.dumps(line), flush=True)
            fail(f"pod round {name}: launches {launches}, want weighted_sum "
                 f"x {want} and nothing else")
        if name == "all":
            line.update(check_all_round(model, stack, batch, out))
        else:
            line["max_rel_gap_to_plain_merge"] = check_scored_round(out, info)
        if name == "top_k":
            pod_merge_row(info)
        if name == "top_k-int8":
            line.update(check_int8_round(out, kept.pop("top_k"), info))
        if name == "above_average-multikrum":
            sk = info["sketches"]
            line["sketch_dists"] = ((sk[:, None] - sk[None]) ** 2).sum(
                -1).tolist()
            if not all(bool(torch.isfinite(t).all())
                       for t in tree.leaves(out)):
                fail("pod round multikrum: a merged leaf is not finite")
        print(json.dumps(line), flush=True)
        if name == "top_k":
            kept["top_k"] = out
        del out, info
    reckon = pod_reckoning(n_params, POD_P)
    peak = max(peaks.values())
    print(json.dumps({"phase": f"pod-round-{LM_ARCH}-memory",
                      "peak_gb_by_round": peaks,
                      "max_memory_allocated_gb": peak, "reckoning": reckon,
                      "card_gb": torch.cuda.get_device_properties(
                          0).total_memory / 1e9}), flush=True)
    if abs(peak - reckon["total_gb"]) > LM_MEM_MARGIN * reckon["total_gb"]:
        fail(f"pod rounds peaked at {peak} GB against {reckon['total_gb']} "
             "reckoned")
    pod_profile(model, stack, batch)
    after_timed()
    pod_serve_phase(model, stack)
    del stack, batch
    gc.collect()
    torch.cuda.empty_cache()
    pod_cross_check_cpu()
    return {"launches": totals}


# --------------------------------------------------------------------------- #
# Phase 9: the mesh layer, part 2 (DTensor placements, the dry run)
# --------------------------------------------------------------------------- #

def start_dryruns() -> list:
    """The dry run of each DRYRUN_CELLS cell, one process each, all started
    together (each on a fake process group of the production mesh's 256 or
    512 ranks, fake cuda tensors; nothing on the card is allocated). Their
    records go to DRYRUN_OUT."""
    os.makedirs(os.path.join(HERE, DRYRUN_OUT), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = []
    for arch, shape, multi in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh",
               "multi" if multi else "single", "--out", DRYRUN_OUT, "--force"]
        procs.append(((arch, shape, multi), time.perf_counter(),
                      subprocess.Popen(cmd, cwd=HERE, env=env,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    return procs


def card_processes() -> list:
    """The processes holding a context on the card, as ``nvidia-smi
    --query-compute-apps`` lists them (pid, used MiB); a container may
    hide them."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def finish_dryruns(procs) -> list:
    """Wait for the dry-run processes and print a ``dryrun-*`` line a
    cell: per-device FLOPs, the traffic proxy, collectives by kind and
    axis with their bytes, the peak, the roofline terms (H100 data-sheet
    constants) and the dominant one. Fails on a cell that failed, and
    unless the multi-pod cell counted ``weighted_sum``'s fake op, the
    RWKV-6 cell ``wkv6`` and ``wkv6_backward``'s, and the OLMoE cell ran
    its experts a block of 4 (64 experts over the 16-rank model axis)."""
    lines = []
    for (arch, shape, multi), t0, p in procs:
        out = p.communicate(timeout=600)[0]
        tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
        path = os.path.join(HERE, DRYRUN_OUT, tag + ".json")
        if p.returncode != 0 or not os.path.exists(path):
            fail(f"dry run {tag}: exit {p.returncode}\n{out[-3000:]}")
        with open(path) as f:
            rec = json.load(f)
        h, ma, rf = rec["hlo"], rec["memory_analysis"], rec["roofline"]
        line = {"phase": f"dryrun-{arch}-{shape}-"
                         f"{'multi' if multi else 'single'}",
                "mesh": rec["mesh"], "ranks": rec["n_devices"],
                "wall_s": time.perf_counter() - t0,
                "flops_per_device": h["flops"],
                "model_flops_per_device": rf["model_flops_per_dev"],
                "traffic_bytes": h["traffic_bytes"],
                "collective_bytes": h["collective_bytes"],
                "collectives": [{k: c[k] for k in ("kind", "axis", "bytes",
                                                   "count")}
                                for c in h["collectives_by_axis"]],
                "flops_by_op": h["flops_by_op"],
                "argument_bytes": ma["argument_bytes"],
                "peak_bytes": h["peak_bytes"],
                "roofline_s": {k: v for k, v in rf.items()
                               if k.endswith("_s")},
                "dominant": rf["dominant"],
                "constants": rec["constants"]}
        print(json.dumps(line), flush=True)
        ops = h["flops_by_op"]
        if multi and not ops.get("repro_torch::weighted_sum"):
            fail(f"dry run {tag}: the merge's weighted_sum was not counted")
        if arch.startswith("rwkv6") and not (
                ops.get("repro_torch::wkv6") and
                ops.get("repro_torch::wkv6_backward")):
            fail(f"dry run {tag}: wkv6 / wkv6_backward not counted: {ops}")
        if not h["flops"] > 0 or h["peak_bytes"] <= 0:
            fail(f"dry run {tag}: {line}")
        lines.append(line)
    return lines


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_one_rank() -> dict:
    """``make_train_step`` of ``qwen3-1.7b`` at full width (remat 'full',
    4 x 512 tokens, phase 8's shape) with DTensor params on a (1, 1) mesh
    over a real one-rank NCCL group, against the same step on plain
    tensors and against the dry run of the same cell at (1, 1) on a fake
    group: new params and loss bit for bit the plain step's, its local-op
    FLOPs (``launch/opstats``) equal to the dry run's, and
    ``torch.cuda.max_memory_allocated`` within MESH_PEAK_MARGIN of the
    dry run's peak (arguments and the step's own bytes)."""
    import torch.distributed as dist
    from repro_torch import pshard, tree
    from repro_torch.config import ShapeConfig
    from repro_torch.core.exchange import make_train_step
    from repro_torch.launch import dryrun, opstats
    from repro_torch.launch.mesh import make_production_mesh
    t0 = time.perf_counter()
    B, S = POD_BATCH
    shape = ShapeConfig("train_4k", S, B, "train")
    rec = dryrun.run_cell(LM_ARCH, "train_4k", False, mesh_shape=(1, 1),
                          device="cuda", shape=shape, verbose=False)
    dry_s = time.perf_counter() - t0
    model, params = init_full_width(LM_ARCH, FAMILY_PARAMS[LM_ARCH])
    g = torch.Generator(device="cuda").manual_seed(9)
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), generator=g,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
    step = make_train_step(model, dryrun.LR)
    plain, plain_m = step(params, batch)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_production_mesh(shape=(1, 1))
        with pshard.use_mesh(mesh):
            dp = pshard.distribute_params(params, model.param_rules())
            db = {k: pshard.place(v, mesh, pshard.BATCH, None)
                  for k, v in batch.items()}
        args = (dp, db)
        arg_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                        for a in args for t in tree.leaves(a))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        counter = opstats.OpCounter(opstats.group_axes(mesh))
        with counter, pshard.use_mesh(mesh), pshard.dtensor_context(dp):
            new, metrics = step(dp, db)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() - before + arg_bytes
        same = all(torch.equal(a.to_local(), b) for a, b in
                   zip(tree.leaves(new), tree.leaves(plain)))
        loss_same = bool(torch.equal(metrics["loss"].to_local(),
                                     plain_m["loss"]))
        placed = sorted({str(tuple(t.placements)) for t in tree.leaves(new)})
    finally:
        dist.destroy_process_group()
    dry_peak = rec["hlo"]["peak_bytes"]
    line = {"phase": f"mesh-one-rank-{LM_ARCH}", "mesh": [1, 1],
            "tokens": [B, S], "remat": model.cfg.remat,
            "params_equal_plain": bool(same), "loss_equal_plain": loss_same,
            "loss": float(plain_m["loss"]),
            "flops_local_ops": counter.stats.flops,
            "flops_dry_run": rec["hlo"]["flops"],
            "max_memory_allocated_gb": peak / 1e9,
            "dry_run_peak_gb": dry_peak / 1e9,
            "peak_rel_gap": (peak - dry_peak) / dry_peak,
            "argument_bytes": arg_bytes,
            "dry_run_argument_bytes": rec["memory_analysis"]["argument_bytes"],
            "new_param_placements": placed, "step_s": step_s,
            "dry_run_s": dry_s, "s": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    if not (same and loss_same):
        fail(f"mesh one rank: the DTensor step is not the plain step's bits")
    if counter.stats.flops != rec["hlo"]["flops"] or \
            arg_bytes != rec["memory_analysis"]["argument_bytes"]:
        fail(f"mesh one rank: FLOPs or argument bytes differ from the dry "
             f"run's: {line}")
    if abs(peak - dry_peak) > MESH_PEAK_MARGIN * dry_peak:
        fail(f"mesh one rank: peak {peak / 1e9:.3f} GB against the dry "
             f"run's {dry_peak / 1e9:.3f} GB")
    del params, plain, new, dp
    gc.collect()
    torch.cuda.empty_cache()
    return line


def main() -> int:
    # set before the first allocation on the card: phase 7 holds three
    # silos of qwen3-1.7b and their 13.8 GB FedAvg stacks, and without
    # expandable segments the caching allocator's multi-GB blocks
    # fragment (on an H100 80GB: out of memory with 25.6 GB reserved but
    # free in pieces)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    check_model_width(gen)
    wkv6_rows = [check_wkv6("main", gen, iters=200),
                 check_wkv6("long", gen, iters=50)]
    finish_rows([check_wkv6("large", gen, iters=20)])
    wkv6_bwd_rows = [check_wkv6_backward(shape, gen, iters=20)
                     for shape in WKV6_BWD_SHAPES]
    # every CUDA-event timing is done: now the profiles
    finish_rows(main_rows + wkv6_rows + wkv6_bwd_rows)
    main_rows += [wkv6_rows[0], wkv6_bwd_rows[0]]
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

    # phase 7: federated LM training at full width, the CLI; qwen3-1.7b,
    # then rwkv6-1.6b through the wkv6 backward kernel (their smoke
    # presets against the CPU run in phase 9, beside the dry runs)
    lm = {}
    for arch in LM_ARCHS:
        if arch.startswith("rwkv6"):
            rwkv6_step_check()
        lm[arch] = lm_train_phase(tree, arch)
        if arch.startswith("rwkv6"):
            rwkv6_grad_check()
        lm_train_cli(arch)

    # phase 8: the multi-pod round step, two pods of qwen3-1.7b at full
    # width on the card, its serve step, the smoke preset against the CPU;
    # the dry run's cells (host processes on fake groups) start once its
    # timed and profiled rows are done, so that none of them shares the
    # host's cores with another process
    dry: list = []
    try:
        pod = pod_round_phase(tree, lambda: dry.extend(start_dryruns()))

        # phase 9: the mesh layer, part 2: the DTensor step on one real
        # rank against the plain step and the dry run, then the dry run's
        # cells; while they run, phase 7's untimed CPU checks
        t9 = time.perf_counter()
        mesh_one_rank()
        on_card = card_processes()
        for arch in LM_ARCHS:
            lm_cross_check_cpu(arch)
        finish_dryruns(dry)
        print(json.dumps({"phase": "mesh-layer-part-2",
                          "s": time.perf_counter() - t9,
                          "dry_run_pids": [p.pid for _, _, p in dry],
                          "card_processes_during_dry_runs": on_card}),
              flush=True)
    finally:
        for _, _, p in dry:      # a failed phase leaves none running
            if p.poll() is None:
                p.kill()
                p.wait()

    # phase 10: the kernels line and the result line
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
        "wkv6_backward": ("wkv6_backward",
                          "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                          "no Pallas counterpart: the reference "
                          "differentiates wkv_chunked "
                          "(src/repro/models/rwkv6.py:80)",
                          "wkv6_backward"),
    }
    # each kernel's launches on the main path that runs it; dequantize and
    # dequantize_batch are one kernel behind one wrapper, one count
    path_launches = {k: launches[k] for k in
                     ("weighted_sum", "quantize", "dequantize", "wsum_q8")}
    path_launches.update({k: launches_d[k] for k in
                          ("add_q8_delta", "gram_q8", "gram_and_norms")})
    path_launches["wkv6"] = sum(r["wkv6_launches"] for r in serving)
    # the backward's main path is RWKV-6 training at full width
    path_launches["wkv6_backward"] = \
        lm["rwkv6-1.6b"]["launches"]["wkv6_backward"]
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
                        "launches_lm_train": lm[LM_ARCH]["launches"][
                            counter],
                        "launches_lm_train_rwkv6":
                            lm["rwkv6-1.6b"]["launches"][counter],
                        "launches_pod_round": pod["launches"][counter],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        **({"bound_tc_ms": r["bound_tc_ms"]}
                           if "bound_tc_ms" in r else {}),
                        "library_ms": r["library_ms"],
                        "n": r.get("n", r.get("N")),
                        "library_n": r.get("library_n"),
                        "check": r["check"]})
    if len(kernels) != 10:
        fail(f"the kernels line lists {len(kernels)} kernels, want 10")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
