"""The dense and vlm decoder families on the port (``models/layers.py``'s
attention half, ``models/transformer.py``, ``launch/serve.py``) against
``repro.models.transformer`` on the CPU, at the smoke presets of
``qwen3-1.7b`` (qk-norm, GQA), ``gemma-2b`` (MQA, GeGLU, scaled
embedding), ``minicpm-2b`` (odd vocab 250 padded to 2048),
``qwen1.5-110b`` (QKV bias, untied) and ``chameleon-34b`` (``vlm``,
untied), with the reference's init carried across as numpy arrays.

Tolerances are those of ``test_torch_lm_parity`` (the harness the LM-family
tests share): F32_REL = 1e-5 of each output's largest magnitude in
float32 (measured errors are below 1e-6 of it); in bf16 twice the
reference's own bf16 error and at least one bf16 ulp (the bound of
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
from repro_torch import tree
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as TL
from repro_torch.models import transformer as ttrans
from test_torch_lm_parity import (F32, F32_REL, Case, init_layout, port_trace,
                             ref_trace)

ARCHS = ["qwen3-1.7b", "gemma-2b", "minicpm-2b", "qwen1.5-110b",
         "chameleon-34b"]
B, S, STEPS = 2, 12, 6
WINDOW = 32        # mixtral-8x7b's smoke attn_window, on a dense config


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def test_init_layout_matches_the_reference(case):
    """The same leaves, shapes and dtypes, the layers stacked [L, ...]."""
    tp, same = init_layout(case.tcfg.arch_id, "float32")
    assert same
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
    want = ref_trace(case.jm, case.ref, {"tokens": toks}, ids)
    case.check(port_trace(case.tm, case.tp, {"tokens": toks}, ids), want,
               "decode")


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
    toks, ids = {"tokens": c.tokens(5)}, c.tokens(6, (B, STEPS))
    want = ref_trace(c.jm, c.ref, toks, ids)
    want32 = ref_trace(c.jm32, c.ref32, toks, ids)
    c.check(port_trace(c.tm, c.tp, toks, ids), want, "bf16", want32)


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
    toks, ids = {"tokens": c.tokens(7, (B, prompt))}, c.tokens(8, (B, 16))
    want = ref_trace(c.jm, c.ref, toks, ids)
    assert want[1].shape[2] == min(WINDOW, prompt)  # k: [L, B, W, KV, hd]
    c.check(port_trace(c.tm, c.tp, toks, ids), want, "window")


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
    """It waits no more: the moe family builds as a decoder whose layers
    hold ``"moe"`` in place of ``"mlp"`` (``tests/test_torch_moe.py`` holds
    it to the reference)."""
    assert tbuild(tsmoke(arch)).kind == "decoder"
    p = ttrans.init_params(torch.Generator(), tsmoke(arch), "cpu")
    assert "moe" in p["layers"] and "mlp" not in p["layers"]


def test_unstacked_layers_give_the_sliced_gradients(monkeypatch):
    """The forward unbinds each stacked ``[L, ...]`` weight once
    (``layers.unstack_layers``): its gradients are bit for bit those of
    slicing a layer at a time (``layers.layer_at``), which zero-fills an
    ``[L, ...]`` gradient a layer."""
    cfg = treplace(tsmoke("qwen3-1.7b"), **F32)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    grad = torch.func.grad(lambda p: model.loss(p, batch)[0])
    got = grad(params)
    sliced = []
    monkeypatch.setattr(TL, "unstack_layers", lambda t, n: sliced.append(n)
                        or [TL.layer_at(t, i) for i in range(n)])
    want = dict(tree.leaves_with_paths(grad(params)))
    assert sliced == [cfg.n_layers]
    for path, a in tree.leaves_with_paths(got):
        assert torch.equal(a, want[path]), path
