"""The dense and vlm decoder families on the port (``models/layers.py``'s
attention half, ``models/transformer.py``, ``launch/serve.py``) against
``repro.models.transformer`` on the CPU, at the smoke presets of
``qwen3-1.7b`` (qk-norm, GQA), ``gemma-2b`` (MQA, GeGLU, scaled
embedding), ``minicpm-2b`` (odd vocab 250 padded to 2048),
``qwen1.5-110b`` (QKV bias, untied) and ``chameleon-34b`` (``vlm``,
untied), with the reference's init carried across as numpy arrays.

Tolerances, per compared output:

- float32: F32_REL = 1e-5 of the output's largest magnitude (float32 sums
  in another order through two layers; measured errors are below 1e-6 of
  it).
- bf16: twice the reference's own bf16 rounding error, i.e. of how far its
  bf16 output lies from its float32 evaluation of the same weights, and at
  least one bf16 ulp (2^-7) of the largest magnitude (the bound of
  ``tests/test_torch_rwkv6.py``: the frameworks round at different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as TL
from repro_torch.models import transformer as ttrans
from repro_torch.tree import leaves_with_paths

F32_REL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_FACTOR = 2.0
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ["qwen3-1.7b", "gemma-2b", "minicpm-2b", "qwen1.5-110b",
         "chameleon-34b"]
B, S, STEPS = 2, 12, 6
WINDOW = 32        # mixtral-8x7b's smoke attn_window, on a dense config


class Case:
    """One config in both packages with the reference's init in both."""

    def __init__(self, arch, dtype="float32", **over):
        self.jcfg, self.tcfg = jsmoke(arch), tsmoke(arch)
        if dtype == "float32":
            over = {**F32, **over}
        self.jcfg, self.tcfg = jreplace(self.jcfg, **over), \
            treplace(self.tcfg, **over)
        self.dtype = dtype
        self.jm, self.tm = jbuild(self.jcfg), tbuild(self.tcfg)
        self.ref = self.jm.init(jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.ref), "cpu")
        if dtype == "bfloat16":
            self.jm32 = jbuild(jreplace(self.jcfg, **F32))
            self.ref32 = jax.tree.map(lambda a: a.astype(jnp.float32),
                                      self.ref)

    def tokens(self, seed, shape=(B, S)):
        return np.random.default_rng(seed).integers(
            0, self.jcfg.vocab_size, shape)

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


def _ref_run(model, params, toks, ids):
    """Reference prefill, then one decode step a column of ``ids``
    (teacher forcing): [prefill logits, k, v, then logits, k, v a step]."""
    logits, cache = model.prefill(params, {"tokens": jnp.asarray(toks)})
    out = [logits, cache["k"], cache["v"]]
    W = cache["k"].shape[2]
    full = model.init_cache(toks.shape[0], toks.shape[1] + ids.shape[1])
    cache = jax.tree.map(
        lambda f, g: jax.lax.dynamic_update_slice(f, g.astype(f.dtype),
                                                  (0,) * f.ndim)
        if f.shape != g.shape else g, full, cache)
    for i in range(ids.shape[1]):
        logits, cache = model.decode_step(
            params, {"token": jnp.asarray(ids[:, i], jnp.int32),
                     "pos": jnp.int32(toks.shape[1] + i)}, cache)
        out += [logits, cache["k"], cache["v"]]
    return out, W


def _port_run(model, params, toks, ids):
    with torch.inference_mode():
        logits, cache = model.prefill(params,
                                      {"tokens": torch.from_numpy(toks)})
        out = [logits, cache["k"].clone(), cache["v"].clone()]
        full = model.init_cache(toks.shape[0], toks.shape[1] + ids.shape[1],
                                "cpu")
        for name in cache:
            if full[name].shape != cache[name].shape:
                full[name][:, :, :cache[name].shape[2]] = cache[name]
            else:
                full[name] = cache[name]
        cache = full
        for i in range(ids.shape[1]):
            logits, cache = model.decode_step(
                params, {"token": torch.from_numpy(ids[:, i]),
                         "pos": toks.shape[1] + i}, cache)
            out += [logits, cache["k"].clone(), cache["v"].clone()]
    return out


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def test_init_layout_matches_the_reference(case):
    """The same leaves, shapes and dtypes, the layers stacked [L, ...]."""
    tp = case.tm.init(torch.Generator().manual_seed(0), "cpu")
    got = [(p, tuple(l.shape), str(l.dtype).split(".")[-1])
           for p, l in leaves_with_paths(tp)]
    want = [(p, tuple(l.shape), str(l.dtype)) for p, l in
            leaves_with_paths(jax.tree.map(np.asarray, case.ref))]
    assert got == want
    assert tp["layers"]["attn"]["wq"].shape[0] == case.tcfg.n_layers


def test_prefill_logits_and_cache_match_the_reference(case):
    toks = case.tokens(0)
    jl, jc = case.jm.prefill(case.ref, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tc = case.tm.prefill(case.tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape[-1] == case.tcfg.padded_vocab()
    case.check([tl, tc["k"], tc["v"]], [jl, jc["k"], jc["v"]], "prefill")


def test_decode_steps_match_the_reference(case):
    """Prefill, pad the cache to S + STEPS as ``serve`` does, then STEPS
    teacher-forced decode steps: logits and the whole cache each step."""
    toks, ids = case.tokens(1), case.tokens(2, (B, STEPS))
    want, _ = _ref_run(case.jm, case.ref, toks, ids)
    case.check(_port_run(case.tm, case.tp, toks, ids), want, "decode")


def test_loss_matches_the_reference(case):
    toks, tgt = case.tokens(3), case.tokens(4)
    mask = (np.arange(S) < S - 3).astype(np.float32)[None].repeat(B, 0)
    for m in (None, mask):
        jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
        tb = {"tokens": torch.from_numpy(toks),
              "targets": torch.from_numpy(tgt)}
        if m is not None:
            jb["mask"], tb["mask"] = jnp.asarray(m), torch.from_numpy(m)
        (jloss, _), (tloss, tm) = case.jm.loss(case.ref, jb), \
            case.tm.loss(case.tp, tb)
        case.check([tloss, tm["ce"]], [jloss, jloss], "loss")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "chameleon-34b"])
def test_bf16_prefill_and_decode_track_the_reference(arch):
    """At the presets' own bf16: within twice the reference's bf16 error."""
    c = Case(arch, "bfloat16")
    toks, ids = c.tokens(5), c.tokens(6, (B, STEPS))
    want, _ = _ref_run(c.jm, c.ref, toks, ids)
    want32, _ = _ref_run(c.jm32, c.ref32, toks, ids)
    c.check(_port_run(c.tm, c.tp, toks, ids), want, "bf16", want32)


# --------------------------------------------------------------------------- #
# Attention: across KV chunks, sliding windows, the rolling cache
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("window,causal,T", [(None, True, 1100),
                                             (WINDOW, True, 1100),
                                             (None, False, 1100),
                                             (700, True, 2100),
                                             (None, True, 1024)])
def test_chunked_attention_matches_across_chunks(window, causal, T):
    """S = T queries over T keys: 1100 crosses one 1024-key chunk boundary
    and pads the last chunk, 2100 two, 1024 is exactly one chunk; float32,
    4 heads over 2 KV heads of 16."""
    rng = np.random.default_rng(T + (window or 0))
    q = rng.standard_normal((1, T, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, T, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, T, 2, 16)).astype(np.float32)
    want = np.asarray(JL.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=0,
        window=window, causal=causal))
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), q_offset=0,
                               window=window, causal=causal).numpy()
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


@pytest.mark.parametrize("prompt", [20, 40, 64])
def test_sliding_window_and_rolling_cache_match(prompt):
    """``attn_window`` = 32 on qwen3's smoke preset: a prompt inside the
    window (the cache pads from 20 slots to the window), one past it (the
    prefill rolls its last 32 keys) and one twice its size; then decode
    steps past the window, writing slot ``pos % 32``."""
    c = Case("qwen3-1.7b", attn_window=WINDOW)
    toks, ids = c.tokens(7, (B, prompt)), c.tokens(8, (B, 16))
    want, W = _ref_run(c.jm, c.ref, toks, ids)
    assert W == min(WINDOW, prompt)
    c.check(_port_run(c.tm, c.tp, toks, ids), want, "window")


def test_decode_attention_matches_with_part_of_the_cache_valid():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    for n_valid in (1, 7, 10):
        want = np.asarray(JL.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            n_valid=n_valid))
        got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc),
                                  n_valid=n_valid).numpy()
        assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


@pytest.mark.parametrize("name", ["layer_norm", "rope", "gelu_mlp"])
def test_helper_layers_match(name):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    if name == "layer_norm":
        sc, bi = rng.standard_normal(16).astype(np.float32), \
            rng.standard_normal(16).astype(np.float32)
        want = JL.layer_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi))
        got = TL.layer_norm(*map(torch.from_numpy, (x, sc, bi)))
    elif name == "rope":
        pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) * 37
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
        got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    else:
        c = Case("gemma-2b")
        h = rng.standard_normal((2, 5, 64)).astype(np.float32)
        want = JL.mlp_block(jax.tree.map(lambda a: a[0],
                                         c.ref["layers"]["mlp"]),
                            jnp.asarray(h), c.jcfg)
        got = TL.mlp_block({k: v[0] for k, v in
                            c.tp["layers"]["mlp"].items()},
                           torch.from_numpy(h), c.tcfg)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= F32_REL * np.abs(want).max()


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,over", [("qwen3-1.7b", {}),
                                       ("minicpm-2b", {}),
                                       ("chameleon-34b", {}),
                                       ("qwen3-1.7b",
                                        {"attn_window": WINDOW})])
def test_serve_gives_the_reference_ids_in_float32(monkeypatch, arch, over):
    """``repro.launch.serve.main`` at seed 0 (3 x 20 prompt + 10), and the
    port's ``serve`` with the params and prompts that ``main`` draws: the
    same greedy ids (the argmax over the padded vocabulary, as the
    reference takes it). With the window the cache pads from 20 slots to
    the window and decoding rolls past it."""
    jcfg = jreplace(jsmoke(arch), **F32, **over)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
    want = jserve.main(["--arch", arch, "--batch", "3", "--prompt-len",
                        "20", "--gen", "10", "--seed", "0"])
    rng = jax.random.PRNGKey(0)
    params = jbuild(jcfg).init(rng)
    prompts = np.array(jax.random.randint(rng, (3, 20), 0, jcfg.vocab_size))
    got = tserve.serve(tbuild(treplace(tsmoke(arch), **F32, **over)),
                       params_from_numpy(jax.tree.map(np.asarray, params),
                                         "cpu"), prompts, 10, "cpu")
    assert got["ids"].shape == (3, 10) and got["finite"]
    np.testing.assert_array_equal(got["ids"], want)


def test_main_serves_qwen3_with_its_defaults_on_the_cpu(capsys):
    """The CLI's defaults (``qwen3-1.7b``, smoke preset, 4 x 64 + 32)."""
    ids = tserve.main(["--device", "cpu"])
    assert ids.shape == (4, 32)
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b" in out and "device=cpu" in out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmoe-1b-7b"])
def test_moe_family_waits_for_its_slice(arch):
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        tbuild(tsmoke(arch))
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        ttrans.init_params(torch.Generator(), tsmoke(arch), "cpu")
