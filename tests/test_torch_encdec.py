"""The ``encdec`` family on the port (``models/encdec.py``: SeamlessM4T's
encoder-decoder backbone over stub audio frames) against
``repro.models.encdec`` on the CPU, at the smoke preset of
``seamless-m4t-medium`` (2 + 2 layers), with the reference's init carried
across as numpy arrays.

Tolerances are those of ``test_torch_lm_parity``: F32_REL = 1e-5 of each
output's largest magnitude in float32, twice the reference's own bf16
error (at least one bf16 ulp) in bf16.

The reference pads every cache leaf to ``init_cache(B, S + gen)`` after
the prefill, the encoder memory too: ``mem_k``/``mem_v`` get
``src_len(S + gen)`` slots for the ``src_len(S)`` the encoder made, and
decode steps attend to the zero slots. The port copies that;
``test_padded_memory_decode_is_the_references`` pins it.
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
from repro.models import encdec as jed
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import encdec as ted
from test_torch_lm_parity import (F32, F32_REL, Case, check_loss, init_layout,
                             port_trace, ref_trace)

ARCH = "seamless-m4t-medium"
B, S, STEPS = 2, 12, 6


@pytest.fixture(scope="module")
def case():
    return Case(ARCH)


def _batch(c, seed, S_=S):
    return {"tokens": c.tokens(seed, (B, S_)),
            "frames": c.frames(seed + 1, B, jed.src_len(S_))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_matches_the_reference(dtype):
    tp, same = init_layout(ARCH, dtype)
    assert same
    cfg = tsmoke(ARCH)
    assert tp["enc_layers"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert tp["dec_layers"]["cross_attn"]["wk"].shape[0] == cfg.n_layers


def test_src_len():
    for n in (1, 3, 4, 12, 64, 1100, 1132):
        assert ted.src_len(n) == jed.src_len(n)


def test_encode_and_cross_attention_match(case):
    """The non-causal encoder over [2, 3, 64] frames; one decoder layer's
    cross-attention of 12 queries over that memory."""
    b = _batch(case, 0)
    want = jax.jit(jed.encode, static_argnums=2)(
        case.ref, jnp.asarray(b["frames"]), case.jcfg)
    mem = ted.encode(case.tp, torch.from_numpy(b["frames"]), case.tcfg)
    case.check([mem], [want], "encode")
    x = np.random.default_rng(2).standard_normal((B, S, 64)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0],
                      case.ref["dec_layers"]["cross_attn"])
    tp = {k: v[0] for k, v in case.tp["dec_layers"]["cross_attn"].items()}
    cw = jed._cross_attention(jp, jnp.asarray(x), want, case.jcfg)
    cg = ted._cross_attention(tp, torch.from_numpy(x), mem, case.tcfg)
    case.check([cg], [cw], "cross-attention")


def test_prefill_and_decode_match(case):
    """Prefill logits and cache (self k, v and the projected memory), the
    cache padded to S + STEPS as ``serve`` pads it (memory 3 -> 4 slots),
    then STEPS teacher-forced decode steps: logits and the whole cache
    each step."""
    b, ids = _batch(case, 3), case.tokens(5, (B, STEPS))
    want = ref_trace(case.jm, case.ref, b, ids)
    case.check(port_trace(case.tm, case.tp, b, ids), want, "serve trace")


def test_loss_matches_the_reference(case):
    b = _batch(case, 6)
    b["targets"] = case.tokens(8, (B, S))
    check_loss(case, b)


def test_bf16_prefill_and_decode_track_the_reference():
    """At the preset's own bf16: within twice the reference's bf16
    error."""
    c = Case(ARCH, "bfloat16")
    b, ids = _batch(c, 9), c.tokens(11, (B, STEPS))
    want = ref_trace(c.jm, c.ref, b, ids)
    want32 = ref_trace(c.jm32, c.ref32, b, ids)
    c.check(port_trace(c.tm, c.tp, b, ids), want, "bf16", want32)


def test_padded_memory_decode_is_the_references(case):
    """B 2, S 16, gen 8: the encoder makes 4 memory slots, ``serve`` pads
    them to src_len(24) = 6 as the reference does, and the first decode
    step attends to the two zero slots too. Its logits equal the
    reference's and differ from those over the unpadded memory by far
    more than the tolerance."""
    b, gen = _batch(case, 12, 16), 8
    first = case.tokens(14, (B, 1))
    want = ref_trace(case.jm, case.ref, b, np.repeat(first, gen, 1))
    got = port_trace(case.tm, case.tp, b, np.repeat(first, gen, 1))
    n_leaves = 5                       # logits, k, mem_k, mem_v, v
    assert got[2].shape[2] == 4 and got[n_leaves + 2].shape[2] == 6
    case.check(got, want, "padded memory")
    with torch.inference_mode():
        _, cache = case.tm.prefill(case.tp, {
            k: torch.from_numpy(v) for k, v in b.items()})
        full = case.tm.init_cache(B, 16 + gen, "cpu")
        full["k"][:, :, :16], full["v"][:, :, :16] = cache["k"], cache["v"]
        full["mem_k"], full["mem_v"] = cache["mem_k"], cache["mem_v"]
        unpadded, _ = case.tm.decode_step(
            case.tp, {"token": torch.from_numpy(first[:, 0]), "pos": 16},
            full)
    padded = got[n_leaves]
    gap = float((padded - unpadded).abs().max())
    assert gap > 100 * F32_REL * float(padded.abs().max())


def test_serve_gives_the_reference_ids_in_float32(monkeypatch):
    """``repro.launch.serve.main`` at seed 0 (3 x 20 prompt + 10, frames
    [3, 5, 64] drawn from its key) and the port's ``serve`` with the
    params, prompts and frames that ``main`` draws: the same greedy ids."""
    jcfg = jreplace(jsmoke(ARCH), **F32)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
    want = jserve.main(["--arch", ARCH, "--batch", "3", "--prompt-len",
                        "20", "--gen", "10", "--seed", "0"])
    rng = jax.random.PRNGKey(0)
    params = jbuild(jcfg).init(rng)
    prompts = np.array(jax.random.randint(rng, (3, 20), 0, jcfg.vocab_size))
    frames = np.array(jax.random.normal(rng, (3, jed.src_len(20), 64)))
    model = tbuild(treplace(tsmoke(ARCH), **F32))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = tserve.serve(model, tp, prompts, 10, "cpu", frames)
    assert got["ids"].shape == (3, 10) and got["finite"]
    np.testing.assert_array_equal(got["ids"], want)
    with pytest.raises(ValueError, match="frames"):
        tserve.serve(model, tp, prompts, 10, "cpu")
