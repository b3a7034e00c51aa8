"""Round step layer: the int8 coding of the exchange (``exchange.q8``:
``_q8`` and ``_dq8`` in eager torch operations) against its roofline: the
values coded a step (the span's ``elements`` counter) times 6 bytes (the
bf16 leaf read, its int8 code written, the code read, the bf16 value
written) at the card's memory rate, over the span's device wall a window
step."""
from bench import spans


def read(ctx):
    a, q8_ms = spans.analysis(ctx), spans.wall_ms(ctx, "exchange.q8")
    if not q8_ms or not a["elements"] or not ctx.peaks:
        return None
    return 100.0 * a["elements"] * spans.Q8_BYTES \
        / ctx.peaks["hbm_bytes_per_s"] / (q8_ms / 1e3)
