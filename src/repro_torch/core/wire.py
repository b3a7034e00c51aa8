"""repro_torch.core.wire — the model exchange codec (``ModelEnvelope``).

Twin of ``repro.core.wire``: every model that crosses a silo boundary is
encoded and decoded here. An envelope is versioned and self-describing, and
its store payload is byte-identical to the reference's for equal inputs, so
CIDs match and each package decodes the other's payloads:

  method        payload                                     base chain
  ----------    ----------------------------------------    ----------
  raw           f32 flat vector                             —
  int8          dense per-tile int8 (quant layout)          —
  topk-delta    magnitude top-k of (vec - base)             ``base_cid``

``int8-delta`` (tile-sparse int8 deltas, rebuilt by the fused
``add_q8_delta`` kernel) is not ported yet: ROADMAP.md, queue 2 item 6.

Payload arrays are tensors on the decoding device; ``to_store`` hands the
store numpy copies.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import ops

WIRE_VERSION = 1
METHODS = ("raw", "int8", "int8-delta", "topk-delta")
QT = ops.QTILE                 # quantization tile (scale granularity)

# Exact keystr paths of envelope fields as serialized by store.serialize_pytree
_kp = lambda name: f"['{name}']"
K_WIRE = _kp("__wire__")
K_METHOD = _kp("__method__")
K_N = _kp("n")
K_BASE = _kp("base_cid")
K_Q = _kp("q")
K_SCALES = _kp("scales")
K_IDX = _kp("idx")
K_VALS = _kp("vals")
K_VEC = _kp("vec")

_ARRAY_FIELDS = ("q", "scales", "idx", "vals", "vec")

# legacy compression-method names -> wire methods
_METHOD_ALIASES = {"none": "raw", "raw": "raw", "int8": "int8",
                   "int8-delta": "int8-delta", "topk": "topk-delta",
                   "topk-delta": "topk-delta"}


def resolve_method(compression: str) -> str:
    """Map a ``FedConfig.compression`` value onto a wire method."""
    try:
        return _METHOD_ALIASES[compression]
    except KeyError:
        raise ValueError(f"unknown compression/wire method {compression!r} "
                         f"(choose from {sorted(_METHOD_ALIASES)})") from None


def _int8_delta_not_ported():
    return NotImplementedError(
        "wire method 'int8-delta' is not ported yet (ROADMAP.md, queue 2 "
        "item 6: add_q8_delta)")


def _tensor(a, device) -> torch.Tensor:
    """A store array (often a read-only view of the payload bytes) as a
    tensor of its own on ``device``."""
    return torch.from_numpy(np.array(a)).to(device)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class ModelEnvelope:
    """One wire-encoded model: method + payload arrays + base reference."""

    __slots__ = ("method", "n", "base_cid", "q", "scales", "idx", "vals",
                 "vec")

    def __init__(self, method: str, n: int, *, base_cid: str = "",
                 q=None, scales=None, idx=None, vals=None, vec=None):
        if method not in METHODS:
            raise ValueError(f"unknown wire method {method!r}")
        self.method = method
        self.n = int(n)
        self.base_cid = base_cid or ""
        self.q = q
        self.scales = scales
        self.idx = idx
        self.vals = vals
        self.vec = vec

    def nbytes(self) -> int:
        """True payload size: the bytes this envelope puts on the wire."""
        return sum(_numpy(getattr(self, f)).nbytes
                   for f in _ARRAY_FIELDS if getattr(self, f) is not None)

    def to_store(self) -> Dict[str, np.ndarray]:
        """Self-describing payload dict for ``store.put`` (deterministic)."""
        out = {"__wire__": np.asarray(WIRE_VERSION, np.int64),
               "__method__": np.asarray(self.method),
               "n": np.asarray(self.n, np.int64)}
        if self.base_cid:
            out["base_cid"] = np.asarray(self.base_cid)
        for f in _ARRAY_FIELDS:
            a = getattr(self, f)
            if a is not None:
                out[f] = _numpy(a)
        return out

    # -- reconstruction ----------------------------------------------------- #
    def reconstruct(self, base_vec=None):
        """Flat f32 [n] model on the payload's device. ``base_vec``
        overrides the base chain (a delta with no base given reconstructs
        against zeros)."""
        n = self.n
        if self.method == "raw":
            return self.vec.to(torch.float32)
        if self.method == "int8":
            return ops.dequantize(self.q, self.scales, n)
        if self.method == "int8-delta":
            raise _int8_delta_not_ported()
        idx = self.idx.long()
        base = (torch.zeros((n,), dtype=torch.float32, device=idx.device)
                if base_vec is None
                else torch.as_tensor(base_vec, dtype=torch.float32,
                                     device=idx.device)[:n])
        return base.index_add(0, idx, self.vals.to(torch.float32))


# --------------------------------------------------------------------------- #
# Encoding
# --------------------------------------------------------------------------- #

def encode_vec(vec, method: str, *, base_vec=None, base_cid: str = "",
               topk_frac: float = 0.01) -> ModelEnvelope:
    """Encode a flat f32 [n] model vector (a tensor on any device).

    ``topk-delta`` encodes (vec - base_vec), or a delta against zeros when
    no base is given (the legacy sparsify-the-model semantics)."""
    method = resolve_method(method)
    vec = vec.to(torch.float32)
    n = int(vec.shape[0])
    if method == "raw":
        return ModelEnvelope("raw", n, vec=vec)
    if method == "int8":
        q, s, _ = ops.quantize(vec)
        return ModelEnvelope("int8", n, q=q, scales=s)
    if method == "int8-delta":
        raise _int8_delta_not_ported()
    if base_vec is None:
        base_cid = ""
        delta = vec
    else:
        delta = vec - torch.as_tensor(base_vec, dtype=torch.float32,
                                      device=vec.device)[:n]
    k = max(1, int(n * topk_frac))
    # stable, like jnp.argsort: equal magnitudes keep index order
    idx = torch.argsort(-delta.abs(), stable=True)[:k].to(torch.int32)
    return ModelEnvelope("topk-delta", n, base_cid=base_cid,
                         idx=idx, vals=delta[idx.long()])


def encode_update(params, fed, *, spec=None, base=("", None)) -> ModelEnvelope:
    """Encode a silo's params per its ``FedConfig`` (the round submit path).
    ``base`` is ``(base_cid, decoded base vector)`` for delta coding."""
    vec, _ = ops.flatten_pytree(params, spec)
    base_cid, base_vec = base
    return encode_vec(vec, resolve_method(fed.compression),
                      base_vec=base_vec, base_cid=base_cid,
                      topk_frac=fed.topk_frac)


# --------------------------------------------------------------------------- #
# Decoded-model representation (zero-copy exchange path)
# --------------------------------------------------------------------------- #

class DecodedModel:
    """A peer model decoded from its wire envelope, kept in exchange form.

    Quantized payloads stay as (q int8, scales) so the fused kernels consume
    them without materializing the f32 vector; ``vec()`` reconstructs
    lazily and memoizes. Delta envelopes resolve their base chain through
    ``resolver`` (the store node's decoded cache)."""

    __slots__ = ("n", "method", "base_cid", "q", "scales", "idx", "vals",
                 "_vec", "_resolver")

    def __init__(self, n: int, *, q=None, scales=None, vec=None,
                 method: Optional[str] = None, base_cid: str = "",
                 idx=None, vals=None,
                 resolver: Optional[Callable[[str], "DecodedModel"]] = None):
        self.n = int(n)
        self.q = q
        self.scales = scales
        self.idx = idx
        self.vals = vals
        self.base_cid = base_cid or ""
        self._vec = vec
        self._resolver = resolver
        if method is None:  # int8 payload or vec
            method = "int8" if q is not None else "raw"
        self.method = method

    @property
    def is_q8(self) -> bool:
        """Whole-model int8: directly consumable by the fused kernels."""
        return self.method == "int8" and self.q is not None

    @property
    def needs_base(self) -> bool:
        return bool(self.base_cid) and self._vec is None

    def vec(self):
        """Flat f32 [n] view of the model (reconstructed once, then cached).
        Delta models resolve ``base_cid`` through the resolver; a missing
        base without a resolver is an error."""
        if self._vec is None:
            base = None
            if self.base_cid:
                if self._resolver is None:
                    raise KeyError(f"delta base {self.base_cid} needs a "
                                   "store-bound resolver to reconstruct")
                base = self._resolver(self.base_cid).vec()
            env = ModelEnvelope(self.method, self.n, base_cid=self.base_cid,
                                q=self.q, scales=self.scales, idx=self.idx,
                                vals=self.vals)
            self._vec = env.reconstruct(base)
        return self._vec


def decode_store(flat: Dict[str, np.ndarray], device,
                 resolver: Optional[Callable] = None) -> DecodedModel:
    """Store payload (keystr -> array dict) -> DecodedModel on ``device``.

    Handles v1 ``__wire__`` envelopes, the only payloads silos exchange."""
    if K_WIRE not in flat:
        raise ValueError("not a wire envelope payload")
    t = lambda key: _tensor(flat[key], device) if key in flat else None
    version = int(np.asarray(flat[K_WIRE]))
    if version > WIRE_VERSION:
        raise ValueError(f"wire envelope v{version} is newer than this "
                         f"codec (v{WIRE_VERSION})")
    method = str(np.asarray(flat[K_METHOD]))
    n = int(np.asarray(flat[K_N]))
    base_cid = str(np.asarray(flat[K_BASE])) if K_BASE in flat else ""
    if method == "raw":
        return DecodedModel(n, vec=t(K_VEC).to(torch.float32), method="raw")
    if method == "int8":
        return DecodedModel(n, q=t(K_Q), scales=t(K_SCALES), method="int8")
    if method == "int8-delta":
        raise _int8_delta_not_ported()
    if method == "topk-delta":
        return DecodedModel(n, idx=t(K_IDX), vals=t(K_VALS),
                            method="topk-delta", base_cid=base_cid,
                            resolver=resolver)
    raise ValueError(f"unknown wire method {method!r} in envelope")
