"""In-memory compression API: thin delegation shims over
``repro_torch.core.wire`` (twin of ``repro.core.compression``), kept for the
reference's import surface."""
from __future__ import annotations

from repro_torch.core import wire
from repro_torch.core.wire import DecodedModel, decode_flat  # noqa: F401


def compress(params, method: str = "int8", *, base=None,
             topk_frac: float = 0.01):
    return wire.compress_pytree(params, method, base=base,
                                topk_frac=topk_frac)


def decompress(payload, like, *, base=None):
    return wire.decompress_pytree(payload, like, base=base)


def payload_bytes(payload) -> int:
    return wire.payload_bytes(payload)
