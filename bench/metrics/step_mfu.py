"""Round step layer: the whole step's share of the card's dense bf16 peak
in the traced window: the model FLOPs of its steps (3 forwards a trained
token, one a scored token, recomputation not counted) over its wall
time. It bounds what any kernel's gain can add to the step's rate."""


def read(ctx):
    if not ctx.peaks or not ctx.window_steps or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.flops_a_step * ctx.window_steps / ctx.window_s \
        / ctx.peaks["bf16_flops"]
