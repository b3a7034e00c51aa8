"""Model layer: device wall a window step inside ``train.forward`` (the
call of ``model.loss`` in ``core/exchange.py`` ``make_train_step``),
summed over the pods, from the program's CUDA-event spans (``spans.py``).
The harness synchronizes before each pod's train step in a traced window,
so this holds the drained queue's wait for the host's first launches."""
from bench import spans


def read(ctx):
    return spans.wall_ms(ctx, "train.forward")
