"""Round step layer: device wall a window step inside ``exchange.score``
(the score matrix: every pod's no-grad forwards of every gathered model
on its scoring rows), from the program's CUDA-event spans
(``spans.py``)."""
from bench import spans


def read(ctx):
    return spans.wall_ms(ctx, "exchange.score")
