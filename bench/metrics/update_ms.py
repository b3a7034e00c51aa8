"""Round step layer: device wall a window step inside ``train.update``
(the SGD update of every parameter in float32), summed over the pods,
from the program's CUDA-event spans (``spans.py``)."""
from bench import spans


def read(ctx):
    return spans.wall_ms(ctx, "train.update")
