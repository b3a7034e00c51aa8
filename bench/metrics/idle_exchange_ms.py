"""Device layer: idle time a step inside the ``exchange`` span, from the
profiled steps: its device wall, placed on the device trace by
``spans.py``'s anchor, less the busy union inside it (no synchronize of
the harness's there)."""
from bench import spans


def read(ctx):
    return spans.idle_ms(ctx, "exchange")
