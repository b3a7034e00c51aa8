"""Round step layer: device wall a window step inside ``exchange.merge``
(the policy's weights and each pod's ``weighted_sum`` merges and copies),
from the program's CUDA-event spans (``spans.py``)."""
from bench import spans


def read(ctx):
    return spans.wall_ms(ctx, "exchange.merge")
