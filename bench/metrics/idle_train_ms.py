"""Device layer: idle time a step inside the pods' ``train`` spans, from
the profiled steps: their device wall, placed on the device trace by
``spans.py``'s anchor, less the busy union inside them. The harness does
not synchronize in those steps, so the queue is not drained before a pod's
train step and the value is the program's own idle."""
from bench import spans


def read(ctx):
    return spans.idle_ms(ctx, "train")
