"""Shared harness of the LM-family parity tests
(``test_torch_transformer.py``, ``test_torch_moe.py``,
``test_torch_rglru.py``, ``test_torch_encdec.py``): one config in both
packages with the reference's init carried across as numpy arrays, and a
serving trace (prefill, the cache padded as ``serve`` pads it, then
teacher-forced decode steps) on each side. Its own tests hold
``serve.pad_cache`` to the reference's padding.

Tolerances, per compared output:

- float32: F32_REL = 1e-5 of the output's largest magnitude (float32 sums
  in another order through a few layers).
- bf16: twice the reference's own bf16 rounding error, i.e. of how far its
  bf16 output lies from its float32 evaluation of the same weights, and at
  least one bf16 ulp (2^-7) of the largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch.serve import pad_cache
from repro_torch.models import build_model as tbuild
from repro_torch.tree import leaves, leaves_with_paths

F32_REL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_FACTOR = 2.0
F32 = dict(param_dtype="float32", compute_dtype="float32")


class Case:
    """One config in both packages with the reference's init in both.
    ``jover`` / ``tover`` are overrides for one side only (a ``MoEConfig``
    belongs to its package)."""

    def __init__(self, arch, dtype="float32", jover=None, tover=None,
                 **over):
        if dtype == "float32":
            over = {**F32, **over}
        self.jcfg = jreplace(jsmoke(arch), **over, **(jover or {}))
        self.tcfg = treplace(tsmoke(arch), **over, **(tover or {}))
        self.dtype = dtype
        self.jm, self.tm = jbuild(self.jcfg), tbuild(self.tcfg)
        self.ref = self.jm.init(jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.ref), "cpu")
        if dtype == "bfloat16":
            self.jm32 = jbuild(jreplace(self.jcfg, **F32))
            self.ref32 = jax.tree.map(lambda a: a.astype(jnp.float32),
                                      self.ref)

    def tokens(self, seed, shape=(2, 12)):
        return np.random.default_rng(seed).integers(
            0, self.jcfg.vocab_size, shape)

    def frames(self, seed, B, M):
        return np.random.default_rng(seed).standard_normal(
            (B, M, self.jcfg.d_model)).astype(np.float32)

    def check(self, got, want, what, want32=None):
        got = [g.to(torch.float32).numpy() for g in got]
        want = [np.asarray(jnp.asarray(w, jnp.float32)) for w in want]
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (what, i, g.shape, w.shape)
            top = np.abs(w).max()
            if want32 is None:
                tol = F32_REL * top
            else:
                w32 = np.asarray(want32[i], np.float32)
                tol = max(BF16_FACTOR * np.abs(w - w32).max(), BF16_ULP * top)
            err = np.abs(g - w).max()
            assert err <= tol, f"{what}[{i}]: max err {err}, tol {tol}"


def init_layout(arch, dtype, **over):
    """(the port's own init, whether it has the leaves, shapes and dtypes
    of the reference's init, as ``jax.eval_shape`` gives them)."""
    if dtype == "float32":
        over = {**F32, **over}
    jm = jbuild(jreplace(jsmoke(arch), **over))
    tp = tbuild(treplace(tsmoke(arch), **over)).init(
        torch.Generator().manual_seed(0), "cpu")
    got = [(p, tuple(l.shape), str(l.dtype).split(".")[-1])
           for p, l in leaves_with_paths(tp)]
    want = [(p, tuple(l.shape), str(l.dtype)) for p, l in leaves_with_paths(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))]
    return tp, got == want


def ref_trace(model, params, batch, ids):
    """Reference prefill of ``batch`` (numpy), the cache padded to S +
    steps as ``repro.launch.serve`` pads it, then one decode step a column
    of ``ids``: [prefill logits, cache leaves, then logits and cache leaves
    a step], the leaves in sorted-key order. Prefill and decode are
    jitted, as the reference's serving driver jits them."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    logits, cache = prefill(params, jb)
    out = [logits, *jax.tree.leaves(cache)]
    B, S = batch["tokens"].shape
    full = model.init_cache(B, S + ids.shape[1])
    cache = jax.tree.map(
        lambda f, g: jax.lax.dynamic_update_slice(f, g.astype(f.dtype),
                                                  (0,) * f.ndim)
        if f.shape != g.shape else g, full, cache)
    for i in range(ids.shape[1]):
        logits, cache = decode(
            params, {"token": jnp.asarray(ids[:, i], jnp.int32),
                     "pos": jnp.int32(S + i)}, cache)
        out += [logits, *jax.tree.leaves(cache)]
    return out


def port_trace(model, params, batch, ids):
    """``ref_trace`` on the port (on the CPU), the cache padded by
    ``serve``'s own padding."""
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    B, S = batch["tokens"].shape
    with torch.inference_mode():
        logits, cache = model.prefill(params, tb)
        out = [logits, *[t.clone() for t in leaves(cache)]]
        cache = pad_cache(model.init_cache(B, S + ids.shape[1], "cpu"),
                          cache)
        for i in range(ids.shape[1]):
            logits, cache = model.decode_step(
                params, {"token": torch.from_numpy(ids[:, i]),
                         "pos": S + i}, cache)
            out += [logits, *[t.clone() for t in leaves(cache)]]
    return out


def check_loss(case, batch):
    """Loss and metrics, without and with a mask (the reference's loss
    jitted)."""
    B, S = batch["tokens"].shape
    mask = (np.arange(S) < S - 3).astype(np.float32)[None].repeat(B, 0)
    for m in (None, mask):
        b = dict(batch)
        if m is not None:
            b["mask"] = m
        jl, jmet = jax.jit(case.jm.loss)(case.ref, {k: jnp.asarray(v)
                                                    for k, v in b.items()})
        tl, tmet = case.tm.loss(case.tp, {k: torch.from_numpy(np.asarray(v))
                                          for k, v in b.items()})
        case.check([tl, tmet["ce"], tmet["aux"]],
                   [jl, jmet["ce"], jmet["aux"]], "loss")


def test_pad_cache_is_the_references_padding():
    """Nested leaves: one of the same shape kept as it is (the very
    tensor), the others written into the leading slots of the zero leaf,
    as ``jax.lax.dynamic_update_slice`` at the origin writes them."""
    rng = np.random.default_rng(0)
    got = {"k": rng.standard_normal((2, 3, 5, 1, 4)).astype(np.float32),
           "rec": {"h": rng.standard_normal((2, 3, 8)).astype(np.float32)},
           "mem_k": rng.standard_normal((2, 3, 4, 1, 4)).astype(np.float32)}
    full = {"k": np.zeros((2, 3, 9, 1, 4), np.float32),
            "rec": {"h": np.zeros((2, 3, 8), np.float32)},
            "mem_k": np.zeros((2, 3, 6, 1, 4), np.float32)}
    want = jax.tree.map(
        lambda f, g: jax.lax.dynamic_update_slice(f, g, (0,) * f.ndim)
        if f.shape != g.shape else g, full, got)
    tgot = jax.tree.map(torch.from_numpy, got)
    out = pad_cache(jax.tree.map(torch.from_numpy, full), tgot)
    assert out["rec"]["h"] is tgot["rec"]["h"]
    for a, b in zip(leaves(out), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
