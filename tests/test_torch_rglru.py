"""The ``hybrid`` family on the port (``models/rglru.py``: RecurrentGemma's
RG-LRU blocks and local MQA attention, 2:1) against ``repro.models.rglru``
on the CPU, at the smoke preset of ``recurrentgemma-9b`` (3 layers: one
group, no tail) and at 4 and 5 layers (a tail of one and of two rec
layers, as the full config's 38 layers end), with the reference's init
carried across as numpy arrays.

Tolerances are those of ``test_torch_lm_parity``: F32_REL = 1e-5 of each
output's largest magnitude in float32, twice the reference's own bf16
error (at least one bf16 ulp) in bf16. The scan is also held to a token
loop of the recurrence in float64.
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
from repro.models import rglru as jrg
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import rglru as trg
from test_torch_lm_parity import (F32, F32_REL, Case, check_loss, init_layout,
                             port_trace, ref_trace)

ARCH = "recurrentgemma-9b"
B, S, STEPS = 2, 12, 6
D = 16


@pytest.fixture(scope="module", params=[3, 4, 5])
def case(request):
    return Case(ARCH, n_layers=request.param)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= F32_REL * top, f"max err {err}, tol {F32_REL * top}"


def _lru_inputs(T, strong, seed):
    """x, r, i [2, T, D] float32, lam [D], h0 [2, D]. ``strong``: r = 1 on
    most channels (a_t = exp(-8 softplus(lam)) ~ 3e-5 a token) and r = 0
    on the first two (a_t = 1: the 1e-12 clip under the square root)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    r = rng.uniform(0.0, 1.0, (2, T, D)).astype(np.float32)
    if strong:
        r[:] = 1.0
        r[..., :2] = 0.0
    i = rng.uniform(0.0, 1.0, (2, T, D)).astype(np.float32)
    lam = rng.uniform(0.9, 1.1, D).astype(np.float32)
    h0 = rng.standard_normal((2, D)).astype(np.float32)
    return x, r, i, lam, h0


def _token_loop(x, r, i, lam, h0):
    """h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (i_t x_t), float64."""
    x, r, i, lam, h = (np.asarray(a, np.float64) for a in (x, r, i, lam, h0))
    a = np.exp(-8.0 * np.log1p(np.exp(lam)) * r)
    b = np.sqrt(np.clip(1.0 - a * a, 1e-12, 1.0)) * (i * x)
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("n", [3, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_matches_the_reference(n, dtype):
    """Groups stacked [G, ...], the tail [n_layers % 3, ...], lru_lam
    float32 in a bf16 model too."""
    tp, same = init_layout(ARCH, dtype, n_layers=n)
    assert same
    assert tp["groups"]["rec1"]["wi"].shape[0] == n // 3
    assert ("tail" in tp) == (n % 3 > 0)
    if n % 3:
        assert tp["tail"]["rec"]["wi"].shape[0] == n % 3
    assert tp["groups"]["rec1"]["lru_lam"].dtype == torch.float32


@pytest.mark.parametrize("T,strong", [(1, False), (13, False), (64, True),
                                      (100, False), (130, True)])
def test_rg_lru_matches_the_reference_and_a_token_loop(T, strong):
    """h0 folded in, T = 1 (a decode step) to 130 tokens (8 doubling
    steps), strong decays over >= 64 tokens and channels at the clip."""
    args = _lru_inputs(T, strong, seed=T)
    jy, jh = jax.jit(jrg.rg_lru)(*map(jnp.asarray, args))
    ty, th = trg.rg_lru(*map(torch.from_numpy, args))
    assert np.isfinite(ty.numpy()).all()
    _close(ty, jy)
    _close(th, jh)
    want = _token_loop(*args)
    _close(ty, want)
    _close(th, want[:, -1])


@pytest.mark.parametrize("S_", [1, 2, 9])
def test_conv1d_matches_the_reference_and_a_token_loop(S_):
    """The four taps over the kept tail and the new inputs; the new tail
    is the last three inputs."""
    rng = np.random.default_rng(S_)
    x = rng.standard_normal((2, S_, D)).astype(np.float32)
    w = rng.standard_normal((4, D)).astype(np.float32)
    tail = rng.standard_normal((2, 3, D)).astype(np.float32)
    jy, jt = jrg._conv1d(*map(jnp.asarray, (x, w, tail)))
    ty, tt = trg._conv1d(*map(torch.from_numpy, (x, w, tail)))
    _close(ty, jy)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    xx = np.concatenate([tail, x], axis=1)
    loop = np.stack([sum(xx[:, t + k] * w[k] for k in range(4))
                     for t in range(S_)], axis=1)
    _close(ty, loop)


def test_prefill_state_and_decode_match(case):
    """Prefill logits and the whole cache (rec states, the tail's, k, v),
    then the attention cache padded to S + STEPS as ``serve`` pads it and
    STEPS teacher-forced decode steps: logits and the whole cache each
    step."""
    toks, ids = case.tokens(0, (B, S)), case.tokens(1, (B, STEPS))
    want = ref_trace(case.jm, case.ref, {"tokens": toks}, ids)
    case.check(port_trace(case.tm, case.tp, {"tokens": toks}, ids), want,
               "serve trace")


def test_loss_matches_the_reference(case):
    check_loss(case, {"tokens": case.tokens(2, (B, S)),
                      "targets": case.tokens(3, (B, S))})


@pytest.mark.parametrize("prompt", [40, 70])
def test_prompt_past_the_window_rolls_the_cache(prompt):
    """Prompts longer than the smoke window of 32 (the prefill keeps its
    last 32 keys in slot order pos % 32), then decode steps writing slot
    pos % 32; 5 layers, so the tail runs too."""
    c = Case(ARCH, n_layers=5)
    toks, ids = c.tokens(4, (B, prompt)), c.tokens(5, (B, 8))
    want = ref_trace(c.jm, c.ref, {"tokens": toks}, ids)
    assert want[1].shape[2] == 32       # the prefill's k: [G, B, W, 1, hd]
    c.check(port_trace(c.tm, c.tp, {"tokens": toks}, ids), want, "window")


def test_bf16_prefill_and_decode_track_the_reference():
    """At the preset's own bf16, 5 layers: within twice the reference's
    bf16 error."""
    c = Case(ARCH, "bfloat16", n_layers=5)
    toks, ids = c.tokens(6, (B, S)), c.tokens(7, (B, STEPS))
    want = ref_trace(c.jm, c.ref, {"tokens": toks}, ids)
    want32 = ref_trace(c.jm32, c.ref32, {"tokens": toks}, ids)
    c.check(port_trace(c.tm, c.tp, {"tokens": toks}, ids), want, "bf16",
            want32)


@pytest.mark.parametrize("n_layers", [3, 5])
def test_serve_gives_the_reference_ids_in_float32(monkeypatch, n_layers):
    """``repro.launch.serve.main`` at seed 0 (3 x 20 prompt + 20: decoding
    crosses the smoke window of 32) and the port's ``serve`` with the
    params and prompts that ``main`` draws: the same greedy ids."""
    jcfg = jreplace(jsmoke(ARCH), **F32, n_layers=n_layers)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
    want = jserve.main(["--arch", ARCH, "--batch", "3", "--prompt-len",
                        "20", "--gen", "20", "--seed", "0"])
    rng = jax.random.PRNGKey(0)
    params = jbuild(jcfg).init(rng)
    prompts = np.array(jax.random.randint(rng, (3, 20), 0, jcfg.vocab_size))
    got = tserve.serve(tbuild(treplace(tsmoke(ARCH), **F32,
                                       n_layers=n_layers)),
                       params_from_numpy(jax.tree.map(np.asarray, params),
                                         "cpu"), prompts, 20, "cpu")
    assert got["ids"].shape == (3, 20) and got["finite"]
    np.testing.assert_array_equal(got["ids"], want)
