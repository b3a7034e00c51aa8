"""Round step layer: wall time a step inside ``exchange_stacked`` (the
int8 coding, the scoring forwards, the policy and the merge; under 'all'
the mean), from the traced window's spans, each closed by a
synchronize."""


def read(ctx):
    t = ctx.spans.get("exchange")
    if not t or not ctx.window_steps:
        return None
    return 1e3 * sum(t) / ctx.window_steps
