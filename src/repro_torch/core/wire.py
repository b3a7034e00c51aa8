"""repro_torch.core.wire — the model exchange codec (``ModelEnvelope``).

Twin of ``repro.core.wire``: every model that crosses a silo boundary is
encoded and decoded here. An envelope is versioned and self-describing, and
its store payload is byte-identical to the reference's for equal inputs, so
CIDs match and each package decodes the other's payloads:

  method        payload                                     base chain
  ----------    ----------------------------------------    ----------
  raw           f32 flat vector                             —
  int8          dense per-tile int8 (quant layout)          —
  int8-delta    tile-sparse int8 of (vec - base)            ``base_cid``
  topk-delta    magnitude top-k of (vec - base)             ``base_cid``

Delta methods reference their base by CID; the sender computes its delta
against the *decoded* base (what receivers reconstruct), so both sides
share bit-identical base vectors. ``int8-delta`` elides quantization tiles
whose delta is zero after quantization, or stays within ``delta_rtol``
quantization steps of the base tile; its reconstruction is the fused
``add_q8_delta`` kernel, which never builds the f32 delta.

Decoded payload arrays are tensors on the decoding device; an encoded
``int8-delta`` envelope keeps the numpy arrays of its tile elision.
``to_store`` hands the store numpy arrays.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree
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
K_TILES = _kp("tiles")
K_IDX = _kp("idx")
K_VALS = _kp("vals")
K_VEC = _kp("vec")

_ARRAY_FIELDS = ("q", "scales", "tiles", "idx", "vals", "vec")

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


def _padded_n(n: int) -> int:
    """Length of the dense quantized form of an n-vector (quant padding)."""
    return n + (-n) % ops.QUANT_BLOCK


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

    __slots__ = ("method", "n", "base_cid", "q", "scales", "tiles", "idx",
                 "vals", "vec")

    def __init__(self, method: str, n: int, *, base_cid: str = "",
                 q=None, scales=None, tiles=None, idx=None, vals=None,
                 vec=None):
        if method not in METHODS:
            raise ValueError(f"unknown wire method {method!r}")
        self.method = method
        self.n = int(n)
        self.base_cid = base_cid or ""
        self.q = q
        self.scales = scales
        self.tiles = tiles
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
        dev = (self.idx if self.method == "topk-delta" else self.q).device
        base = (torch.zeros((n,), dtype=torch.float32, device=dev)
                if base_vec is None
                else torch.as_tensor(base_vec, dtype=torch.float32,
                                     device=dev)[:n])
        if self.method == "topk-delta":
            return base.index_add(0, self.idx.long(),
                                  self.vals.to(torch.float32))
        # int8-delta: scatter the kept tiles into the dense quant grid, then
        # one fused base + s*q pass (the f32 delta is never built)
        tiles = self.tiles.long()
        T = int(tiles.shape[0])
        if T == 0:
            return base
        total = _padded_n(n) // QT
        qd = torch.zeros((total, QT), dtype=torch.int8, device=dev)
        qd[tiles] = self.q.reshape(T, QT)
        sd = torch.zeros((total,), dtype=torch.float32, device=dev)
        sd[tiles] = self.scales.to(torch.float32)
        return ops.add_q8_delta(base, qd.reshape(-1), sd, n)


# --------------------------------------------------------------------------- #
# Encoding
# --------------------------------------------------------------------------- #

def encode_vec(vec, method: str, *, base_vec=None, base_cid: str = "",
               topk_frac: float = 0.01,
               delta_rtol: float = 1.0) -> ModelEnvelope:
    """Encode a flat f32 [n] model vector (a tensor on any device).

    Delta methods encode (vec - base_vec); without a base they fall back to
    a whole-model envelope (``int8-delta`` -> ``int8``) or a delta against
    zeros (``topk-delta``, the legacy sparsify-the-model semantics)."""
    method = resolve_method(method)
    vec = vec.to(torch.float32)
    n = int(vec.shape[0])
    if method == "raw":
        return ModelEnvelope("raw", n, vec=vec)
    if method == "int8" or (method == "int8-delta" and base_vec is None):
        q, s, _ = ops.quantize(vec)
        return ModelEnvelope("int8", n, q=q, scales=s)
    if base_vec is None:
        base_cid = ""
        delta = vec
    else:
        base_vec = torch.as_tensor(base_vec, dtype=torch.float32,
                                   device=vec.device)[:n]
        delta = vec - base_vec
    if method == "topk-delta":
        k = max(1, int(n * topk_frac))
        # stable, like jnp.argsort: equal magnitudes keep index order
        idx = torch.argsort(-delta.abs(), stable=True)[:k].to(torch.int32)
        return ModelEnvelope("topk-delta", n, base_cid=base_cid,
                             idx=idx, vals=delta[idx.long()])
    # int8-delta: dense quantize, then tile-sparse elision on the host
    q, s, _ = ops.quantize(delta)
    qt = _numpy(q).reshape(-1, QT)
    s_np = _numpy(s)
    keep = np.abs(qt).max(axis=1) > 0        # drops padding + exact zeros
    if delta_rtol > 0:
        dpad = np.zeros((qt.shape[0] * QT,), np.float32)
        dpad[:n] = _numpy(delta)
        damax = np.abs(dpad).reshape(-1, QT).max(axis=1)
        bpad = np.zeros_like(dpad)
        bpad[:n] = _numpy(base_vec)
        bamax = np.abs(bpad).reshape(-1, QT).max(axis=1)
        # noise floor: one quantization step of the base tile; deltas that
        # never exceed delta_rtol steps are invisible at q8 wire fidelity
        keep &= damax > delta_rtol * bamax / 127.0
    tiles = np.nonzero(keep)[0].astype(np.int32)
    return ModelEnvelope("int8-delta", n, base_cid=base_cid,
                         q=qt[keep].reshape(-1),
                         scales=s_np[keep].astype(np.float32), tiles=tiles)


def encode_update(params, fed, *, spec=None, base=("", None)) -> ModelEnvelope:
    """Encode a silo's params per its ``FedConfig`` (the round submit path).
    ``base`` is ``(base_cid, decoded base vector)`` for delta coding."""
    vec, _ = ops.flatten_pytree(params, spec)
    base_cid, base_vec = base
    return encode_vec(vec, resolve_method(fed.compression),
                      base_vec=base_vec, base_cid=base_cid,
                      topk_frac=fed.topk_frac, delta_rtol=fed.delta_rtol)


def chain_depth_of(node, cid: str, *, max_links: int = 64) -> int:
    """Delta links under ``cid`` on a store node's local blocks (0 = whole
    model): the walk a late joiner or a catch-up performs, which
    ``FedConfig.keyframe_every`` bounds. Stops where the chain leaves the
    node."""
    from repro_torch.core.store import deserialize_pytree
    depth, cur = 0, cid
    while depth < max_links:
        data = node.read_local(cur)
        if data is None:
            break
        base = base_cid_of_store(deserialize_pytree(data))
        if not base:
            break
        depth += 1
        cur = base
    return depth


def base_cid_of_store(flat: Dict) -> str:
    """The delta-base CID a store payload references ('' when none), from a
    plain-key payload (``to_store`` output) or a deserialized one (keystr
    keys)."""
    b = flat.get(K_BASE)
    if b is None:
        b = flat.get("base_cid")
    return str(np.asarray(b)) if b is not None else ""


# --------------------------------------------------------------------------- #
# Decoded-model representation (zero-copy exchange path)
# --------------------------------------------------------------------------- #

class DecodedModel:
    """A peer model decoded from its wire envelope, kept in exchange form.

    Quantized payloads stay as (q int8, scales) so the fused kernels consume
    them without materializing the f32 vector; ``vec()`` reconstructs
    lazily and memoizes. Delta envelopes resolve their base chain through
    ``resolver`` (the store node's decoded cache)."""

    __slots__ = ("n", "method", "base_cid", "q", "scales", "tiles", "idx",
                 "vals", "_vec", "_resolver")

    def __init__(self, n: int, *, q=None, scales=None, vec=None,
                 method: Optional[str] = None, base_cid: str = "",
                 tiles=None, idx=None, vals=None,
                 resolver: Optional[Callable[[str], "DecodedModel"]] = None):
        self.n = int(n)
        self.q = q
        self.scales = scales
        self.tiles = tiles
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
                                q=self.q, scales=self.scales,
                                tiles=self.tiles, idx=self.idx,
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
        return DecodedModel(n, q=t(K_Q), scales=t(K_SCALES), tiles=t(K_TILES),
                            method="int8-delta", base_cid=base_cid,
                            resolver=resolver)
    if method == "topk-delta":
        return DecodedModel(n, idx=t(K_IDX), vals=t(K_VALS),
                            method="topk-delta", base_cid=base_cid,
                            resolver=resolver)
    raise ValueError(f"unknown wire method {method!r} in envelope")


def decode_flat(flat: Dict[str, np.ndarray], device) -> DecodedModel:
    """Resolver-less decode (non-delta payloads, tests)."""
    return decode_store(flat, device)


def _envelope_from_store(flat: Dict, device) -> Optional[ModelEnvelope]:
    """Parse a plain-key payload dict (pre-serialization form) back into an
    envelope with tensors on ``device``; None when it is not an envelope."""
    if "__wire__" not in flat:
        return None
    g = lambda k: _tensor(flat[k], device) if k in flat else None
    return ModelEnvelope(str(np.asarray(flat["__method__"])),
                         int(np.asarray(flat["n"])),
                         base_cid=(str(np.asarray(flat["base_cid"]))
                                   if "base_cid" in flat else ""),
                         q=g("q"), scales=g("scales"), tiles=g("tiles"),
                         idx=g("idx"), vals=g("vals"), vec=g("vec"))


# --------------------------------------------------------------------------- #
# In-memory compression API (repro_torch.core.compression delegates here)
# --------------------------------------------------------------------------- #

def compress_pytree(params, method: str = "int8", *, base=None,
                    topk_frac: float = 0.01) -> Dict:
    """Payload dict for a params tree; delta-coded iff ``base`` is given."""
    vec, _ = ops.flatten_pytree(params)
    bvec = ops.flatten_pytree(base)[0] if base is not None else None
    m = resolve_method(method)
    if m == "int8" and bvec is not None:
        m = "int8-delta"
    # "__inline__": the base is supplied by the decompress caller, not a CID
    return encode_vec(vec, m, base_vec=bvec, topk_frac=topk_frac,
                      base_cid="__inline__" if bvec is not None else ""
                      ).to_store()


def decompress_pytree(payload: Dict, like, *, base=None):
    """Inverse of ``compress_pytree`` on ``like``'s device; delta payloads
    reconstruct against ``base`` (or ``like`` when no base is passed)."""
    vec, spec = ops.flatten_pytree(like)
    env = _envelope_from_store(payload, vec.device)
    if env is None:
        raise ValueError("not a wire envelope payload")
    bvec = None
    if env.base_cid:  # delta vs a caller-supplied base (legacy: like)
        bvec = ops.flatten_pytree(base)[0] if base is not None else vec
    return ops.unflatten_pytree(env.reconstruct(bvec), spec)


def payload_bytes(payload) -> int:
    """Total bytes of a payload (envelope dict or params tree)."""
    return sum(_numpy(leaf).nbytes for leaf in tree.leaves(payload))
