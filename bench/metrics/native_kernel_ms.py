"""Model layer: device time a profiled step of PyTorch's own
``at::native::`` kernels (elementwise, copies, reductions) that the
model's unfused operations launch."""


def read(ctx):
    tr = ctx.trace
    if not tr.steps or not tr.device:
        return None
    return 1e3 * tr.device_s(lambda n: "at::native::" in n) / tr.steps
