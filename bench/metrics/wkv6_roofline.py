"""Kernels layer: the ``wkv6`` forward kernel (``kernels/rwkv6.py``, the
RWKV-6 time mix's recurrence) against its roofline: over the profiled
steps' calls, the least time each could take, the larger of its bytes
(r, k, v and y in their dtype, w in float32, u, the state read and
written) at the memory rate and its float32 operations (5 hs + 5 an
element: y = S^T r and the bonus, the state's update) at the float32
rate, over the device time of ``wkv6_kernel``. The kernel's tensor-core
form is not credited: the share is of the float32 bound."""

CALLS = ["repro_torch.kernels.rwkv6.forward"]
SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(r, peaks) -> float:
    (B, T, H, hs), dt = r
    n = B * T * H * hs
    e = SIZE[dt]
    nbytes = n * (4 * e + 4) + H * hs * 4 + 2 * B * H * hs * hs * 4
    return max(nbytes / peaks["hbm_bytes_per_s"],
               (5.0 * hs + 5) * n / peaks["f32_flops"])


def read(ctx):
    calls = ctx.calls.get(CALLS[0], [])
    dev = ctx.trace.device_s(lambda n: "wkv6_kernel" in n)
    if not calls or dev <= 0 or not ctx.peaks:
        return None
    return 100.0 * sum(bound_s(c[0], ctx.peaks) for c in calls) / dev
