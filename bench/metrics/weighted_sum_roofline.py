"""Kernels layer: ``weighted_sum`` (``kernels/wsum.py``, the merge of every
leaf in a scored exchange) against its roofline: the sum over the
profiled steps' calls of the least time each could take (its bytes, each
input read once and the output written once, at the card's memory rate,
or its 2 M N float32 operations at the float32 rate, the larger) over the
device time of ``weighted_sum_kernel``."""

CALLS = ["repro_torch.core.exchange.weighted_sum"]
SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(x_shape, x_dtype, peaks) -> float:
    M, N = x_shape
    e = SIZE[x_dtype]
    nbytes = M * N * e + N * e + M * 4
    return max(nbytes / peaks["hbm_bytes_per_s"],
               2.0 * M * N / peaks["f32_flops"])


def read(ctx):
    calls = ctx.calls.get(CALLS[0], [])
    dev = ctx.trace.device_s(lambda n: "weighted_sum_kernel" in n)
    if not calls or dev <= 0 or not ctx.peaks:
        return None
    return 100.0 * sum(bound_s(*c[0], ctx.peaks) for c in calls) / dev
