"""RWKV-6 on the port against ``repro.models.rwkv6`` at the smoke config
(bf16, 2 layers, d_model 64, head size 16) and at a float32 ``replace`` of
it, with the reference's init carried across as numpy arrays.

Tolerances, per compared output:

- float32: 1e-4 of the output's largest magnitude (float32 sums in another
  order through two layers).
- bf16: twice the reference's own bf16 rounding error, i.e. of how far its
  bf16 output lies from its float32 evaluation of the same weights and
  inputs (and at least one bf16 ulp, 2^-7, of the largest magnitude). JAX
  on the CPU keeps some fused intermediates in float32 where PyTorch rounds
  every operation to bf16, so the two frameworks round at different
  places. A port as close to float32 as the reference lies within twice
  that error of it (triangle inequality).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro.models import rwkv6 as jrwkv
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as TL
from repro_torch.models import rwkv6 as trwkv
from repro_torch.tree import leaves_with_paths, tree_map

F32_REL = 1e-4
BF16_ULP = 2.0 ** -7
BF16_FACTOR = 2.0
B, S = 2, 12
F32 = dict(param_dtype="float32", compute_dtype="float32")


class Case:
    """One config in both packages, the reference's init in both, and the
    reference's float32 evaluation of the same weights (bf16 yardstick)."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.jcfg, self.tcfg = jsmoke("rwkv6-1.6b"), tsmoke("rwkv6-1.6b")
        if dtype == "float32":
            self.jcfg, self.tcfg = (jreplace(self.jcfg, **F32),
                                    treplace(self.tcfg, **F32))
        self.ref = jbuild(self.jcfg).init(jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.ref), "cpu")
        self.j32 = jreplace(self.jcfg, **F32)
        self.ref32 = jax.tree.map(lambda a: a.astype(jnp.float32), self.ref)

    def check(self, got, run_ref, what):
        """``run_ref(cfg, params)`` evaluates the reference; its output tree
        and ``got`` are compared leaf by leaf."""
        want = jax.tree.leaves(run_ref(self.jcfg, self.ref))
        got = jax.tree.leaves(got)
        if self.dtype == "bfloat16":
            want32 = jax.tree.leaves(run_ref(self.j32, self.ref32))
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            g = g.to(torch.float32).numpy()
            w = np.asarray(jnp.asarray(w, jnp.float32))
            assert g.shape == w.shape, (what, i)
            top = np.abs(w).max()
            if self.dtype == "float32":
                tol = F32_REL * top
            else:
                w32 = np.asarray(want32[i], np.float32)
                tol = max(BF16_FACTOR * np.abs(w - w32).max(),
                          BF16_ULP * top)
            err = np.abs(g - w).max()
            assert err <= tol, f"{what}[{i}]: max err {err}, tol {tol}"


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    return Case(request.param)


def _tokens(seed, shape=(B, S), vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _act(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def _jx(a, cfg):
    """A numpy activation in the reference's compute dtype."""
    return jnp.asarray(a).astype(JL.dtype_of(cfg.compute_dtype))


def _tx(a, cfg):
    return torch.from_numpy(a).to(TL.dtype_of(cfg.compute_dtype))


def test_init_layout_matches_reference(case):
    tp = tbuild(case.tcfg).init(torch.Generator().manual_seed(0), "cpu")
    got = [(p, tuple(l.shape), str(l.dtype).split(".")[-1])
           for p, l in leaves_with_paths(tp)]
    want = [(p, tuple(l.shape), str(l.dtype))
            for p, l in leaves_with_paths(jax.tree.map(np.asarray, case.ref))]
    assert got == want
    lp = tp["layers"]
    assert lp["wr"].shape == (2, 64, 64)          # stacked [L, ...]
    assert lp["decay_base"].dtype == torch.float32
    assert float(lp["decay_base"].min()) >= -7 and \
        float(lp["decay_base"].max()) <= -1


def test_rms_norm_embed_logits_and_cross_entropy(case):
    tc, tp = case.tcfg, case.tp
    x = _act((B, S, 64), 1)
    case.check(TL.rms_norm(_tx(x, tc), tp["final_norm"], tc.norm_eps),
               lambda c, p: JL.rms_norm(_jx(x, c), p["final_norm"],
                                        c.norm_eps), "rms_norm")
    tok = _tokens(0)
    case.check(TL.embed(tp["embed"], torch.from_numpy(tok), tc),
               lambda c, p: JL.embed(p["embed"], jnp.asarray(tok), c),
               "embed")
    lt = TL.logits_out(tp["embed"], _tx(x, tc), tc)
    assert lt.shape[-1] == 2048 and lt.dtype == _tx(x, tc).dtype  # padded
    case.check(lt, lambda c, p: JL.logits_out(p["embed"], _jx(x, c), c),
               "logits_out")
    tgt = _tokens(2)
    mask = (np.arange(S) < S - 3).astype(np.float32)[None].repeat(B, 0)
    for m in (None, mask):
        ce = TL.cross_entropy(lt, torch.from_numpy(tgt), tc.vocab_size,
                              None if m is None else torch.from_numpy(m))
        case.check(ce, lambda c, p: JL.cross_entropy(
            JL.logits_out(p["embed"], _jx(x, c), c), jnp.asarray(tgt),
            c.vocab_size, None if m is None else jnp.asarray(m)),
            "cross_entropy")


def test_time_mix_and_channel_mix(case):
    tc = case.tcfg
    lt = tree_map(lambda a: a[0], case.tp["layers"])
    x, prev = _act((B, S, 64), 3), _act((B, 1, 64), 4)
    s0 = _act((B, 4, 16, 16), 5) * 0.1
    out, last, st = trwkv.time_mix(lt, _tx(x, tc), tc, _tx(prev, tc),
                                   torch.from_numpy(s0))
    assert torch.equal(last, _tx(x, tc)[:, -1:])
    case.check((out, st), lambda c, p: jrwkv.time_mix(
        jax.tree.map(lambda a: a[0], p["layers"]), _jx(x, c), c,
        _jx(prev, c), jnp.asarray(s0))[::2], "time_mix")
    cm, _ = trwkv.channel_mix(lt, _tx(x, tc), _tx(prev, tc))
    case.check(cm, lambda c, p: jrwkv.channel_mix(
        jax.tree.map(lambda a: a[0], p["layers"]), _jx(x, c),
        _jx(prev, c))[0], "channel_mix")


def test_prefill_logits_and_state(case):
    tok = _tokens(6)
    logits, st = tbuild(case.tcfg).prefill(case.tp,
                                           {"tokens": torch.from_numpy(tok)})
    assert set(st) == {"tm_x", "cm_x", "wkv"}
    assert st["wkv"].dtype == torch.float32
    assert st["tm_x"].dtype == TL.dtype_of(case.dtype)
    case.check((logits, st), lambda c, p: jbuild(c).prefill(
        p, {"tokens": jnp.asarray(tok)}), "prefill")


def test_init_cache_matches_reference(case):
    got = tbuild(case.tcfg).init_cache(3, 40, "cpu")
    want = jbuild(case.jcfg).init_cache(3, 40)
    assert [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in leaves_with_paths(got)] == \
        [(p, tuple(a.shape), str(a.dtype))
         for p, a in leaves_with_paths(jax.tree.map(np.asarray, want))]
    assert not any(torch.any(t) for t in got.values())


def test_decode_chain_of_eight_steps(case):
    """Teacher-forced: both sides are fed the same 8 tokens after the
    prefill, so each step compares logits and state, not greedy picks."""
    tok, feed = _tokens(7), _tokens(8, shape=(B, 8))

    def chain(model, params, as_array, pos):
        _, st = model.prefill(params, {"tokens": as_array(tok)})
        out = []
        for i in range(8):
            logits, st = model.decode_step(
                params, {"token": as_array(feed[:, i]), "pos": pos(S + i)}, st)
            out.append((logits, st["wkv"]))
        return out

    got = chain(tbuild(case.tcfg), case.tp, torch.from_numpy, int)
    assert got[0][0].shape == (B, 2048)
    case.check(got, lambda c, p: chain(jbuild(c), p, jnp.asarray, jnp.int32),
               "decode chain")


def test_loss_fn(case):
    batch = {"tokens": _tokens(9), "targets": _tokens(10)}
    loss, metrics = tbuild(case.tcfg).loss(
        case.tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == {"loss", "ce", "aux"}
    case.check(loss, lambda c, p: jbuild(c).loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0], "loss")
