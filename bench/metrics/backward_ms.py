"""Model layer: device wall a window step inside ``train.backward``
(``torch.autograd.grad`` and the gradients' pinning, remat's
recomputation of the forward included), summed over the pods, from the
program's CUDA-event spans (``spans.py``)."""
from bench import spans


def read(ctx):
    return spans.wall_ms(ctx, "train.backward")
