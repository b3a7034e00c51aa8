"""Round step layer: device wall a window step inside ``exchange.q8`` (the
int8 coding and decoding of every pod's model, ``_q8`` / ``_dq8``), from
the program's CUDA-event spans (``spans.py``). The harness synchronizes
before the exchange in a traced window, so this holds the drained queue's
wait for the host's first launches."""
from bench import spans


def read(ctx):
    return spans.wall_ms(ctx, "exchange.q8")
