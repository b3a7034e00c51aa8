"""Device: share of a step's wall time in which no kernel, copy or set
ran on the card. The busy time is the union of the device intervals of
the profiled steps, not their sum, a step; the wall time is a step of
the same run's window, which no profiler slows (a profiler session,
even one that records the device's activity alone, slows the host that
launches the work)."""


def read(ctx):
    tr = ctx.trace
    if not tr.steps or not tr.device or not ctx.window_steps:
        return None
    return 100.0 * (1.0 - (tr.busy_s() / tr.steps)
                    / (ctx.window_s / ctx.window_steps))
