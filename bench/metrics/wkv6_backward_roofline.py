"""Kernels layer: the ``wkv6_backward`` kernels (``kernels/rwkv6.py``: the
pass, chunk and du kernels of one call) against their roofline: over the
profiled steps' calls, the least time each could take, the larger of its
bytes (r, k, v, dy in their dtype and w, u, the states in float32 read;
dr, dk, dv, dw, du and the initial state's gradient written) at the
memory rate and 10 hs^2 float32 operations a token and head at the
float32 rate, over the device time of the three kernels."""

CALLS = ["repro_torch.kernels.rwkv6.backward"]
SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
KERNELS = ("wkv6_bwd_pass_kernel", "wkv6_bwd_chunk_kernel", "wkv6_du_kernel")


def bound_s(args, peaks) -> float:
    (B, T, H, hs), dt = args[0]
    given = len(args) > 7 and args[7] is not None
    n = B * T * H * hs
    e = SIZE[dt]
    states = B * H * hs * hs * 4
    nbytes = (n * (4 * e + 4) + H * hs * 4 + states * (1 + given)
              + n * (3 * e + 4) + H * hs * 4 + states)
    return max(nbytes / peaks["hbm_bytes_per_s"],
               10.0 * hs * hs * B * T * H / peaks["f32_flops"])


def read(ctx):
    calls = ctx.calls.get(CALLS[0], [])
    dev = ctx.trace.device_s(lambda n: any(k in n for k in KERNELS))
    if not calls or dev <= 0 or not ctx.peaks:
        return None
    return 100.0 * sum(bound_s(c, ctx.peaks) for c in calls) / dev
