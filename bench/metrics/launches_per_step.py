"""Host path: device kernels launched a profiled step (copies and sets
not counted), from the device trace."""


def read(ctx):
    tr = ctx.trace
    if not tr.steps or not tr.device:
        return None
    return len(tr.kernels()) / tr.steps
