"""Round step layer: wall time a step inside the pods' train-step calls
(``core/exchange.py`` ``train_pods`` -> ``make_train_step``), from the
traced window's spans, each closed by a synchronize."""


def read(ctx):
    t = ctx.spans.get("train")
    if not t or not ctx.window_steps:
        return None
    return 1e3 * sum(t) / ctx.window_steps
