"""The ``moe`` family on the port (``models/moe.py``, ``models/transformer.py``
with ``"moe"`` in place of ``"mlp"``, ``launch/serve.py``) against
``repro.models.moe`` and ``repro.models.transformer`` on the CPU, at the
smoke presets of ``olmoe-1b-7b`` (64 experts top-8 at full width; 4 top-2
here, qk-norm) and ``mixtral-8x7b`` (GQA 2:1 and a 32-token sliding window
here), with the reference's init carried across as numpy arrays.

Tolerances are those of ``test_torch_lm_parity``: F32_REL = 1e-5 of each
output's largest magnitude in float32, twice the reference's own bf16
error (at least one bf16 ulp) in bf16. Routing and dispatch are integers
and compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoE
from repro.config import replace as jreplace
from repro.configs import get_config as jget
from repro.configs import get_smoke_config as jsmoke
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch.config import MoEConfig as TMoE
from repro_torch.config import replace as treplace
from repro_torch.configs import get_config as tget
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from test_torch_lm_parity import (F32, Case, check_loss, init_layout, port_trace,
                             ref_trace)

ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]
B, S, STEPS = 2, 12, 6
# scan_layers off and no remat: the reference runs its layers eagerly, so
# its routing can be read layer by layer
EAGER = dict(scan_layers=False, remat="none")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param, **EAGER)


def _record_routes(monkeypatch, mod):
    """Wrap ``mod._route`` to keep each call's top-k expert ids."""
    seen, route = [], mod._route

    def rec(router_w, x2d, cfg):
        out = route(router_w, x2d, cfg)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(mod, "_route", rec)
    return seen


def _layer0(tree):
    return {k: (_layer0(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_matches_the_reference(arch, dtype):
    """``"moe"`` in place of ``"mlp"``, experts stacked [L, E, d, f], the
    router float32 in a bf16 model too."""
    tp, same = init_layout(arch, dtype)
    assert same
    cfg, moe = tsmoke(arch), tp["layers"]["moe"]
    assert tuple(moe["wi"].shape) == (cfg.n_layers, cfg.moe.n_experts,
                                      cfg.d_model, cfg.d_ff)
    assert moe["router"].dtype == torch.float32 and "mlp" not in tp["layers"]


@pytest.mark.parametrize("capacity", [1, 2, 3, 8])
def test_dispatch_indices_match_exactly(capacity):
    """Given expert picks with collisions over capacity (expert 1 picked
    by 5 tokens, expert 0 by 4): the same buffer and the same slots, -1
    where a pick was dropped, earlier tokens first."""
    top_i = np.array([[1, 0], [1, 2], [0, 1], [1, 3], [0, 1], [2, 0],
                      [3, 2], [1, 0]], np.int32)
    jb, js = jax.jit(jmoe._dispatch_indices, static_argnums=(1, 2))(
        jnp.asarray(top_i), 4, capacity)
    tb, ts = tmoe._dispatch_indices(torch.from_numpy(top_i).long(), 4,
                                    capacity)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy() == -1).any() == (capacity < 5)


def test_zero_router_ties_pick_the_lowest_experts():
    """A zero router: every probability is 1/E and the reference's top_k
    picks experts 0..k-1 for every token; so does the port."""
    cfg = treplace(tget("olmoe-1b-7b"), **F32)
    x = np.random.default_rng(0).standard_normal((5, 16)).astype(np.float32)
    w = np.zeros((16, 64), np.float32)
    jp, ji, jaux = jmoe._route(jnp.asarray(w), jnp.asarray(x), jget(
        "olmoe-1b-7b"))
    tp, ti, taux = tmoe._route(torch.from_numpy(w), torch.from_numpy(x), cfg)
    want = np.broadcast_to(np.arange(8), (5, 8))
    np.testing.assert_array_equal(np.asarray(ji), want)
    np.testing.assert_array_equal(ti.numpy(), want)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def _reference_combine(y, top_i, slot, top_p):
    """The reference's combine, ``repro/models/moe.py:117-125`` (gate,
    scale, expert-major scatter-add), on given expert outputs."""
    E, C, D = y.shape
    T = top_i.shape[0]
    buf, _ = jmoe._dispatch_indices(top_i, E, C)
    gate = jnp.zeros((E, C), top_p.dtype)
    gate = gate.at[top_i, slot].add(jnp.where(slot >= 0, top_p, 0.0),
                                    mode="drop")
    y = y * gate[:, :, None].astype(y.dtype)
    out = jnp.zeros((T + 1, D), y.dtype)
    out = out.at[buf.reshape(-1)].add(y.reshape(-1, D), mode="drop")
    return out[:T]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_is_the_references_bit_for_bit(dtype):
    """8 experts, top-4 picks with drops at capacity 3: the port sums each
    token's kept rows in ascending expert id in the output dtype, so in
    bf16 too its bits are the reference scatter-add's (with k > 2 the
    order of the sum shows in the bits)."""
    rng = np.random.default_rng(7)
    T, E, k, C, D = 12, 8, 4, 3, 16
    top_i = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    p = rng.uniform(0.05, 1.0, (T, k)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    y = rng.standard_normal((E, C, D)).astype(np.float32)
    jd = jnp.dtype(dtype)
    _, slot = jmoe._dispatch_indices(jnp.asarray(top_i), E, C)
    assert (np.asarray(slot) == -1).any()
    want = jax.jit(_reference_combine)(
        jnp.asarray(y, jd), jnp.asarray(top_i), slot, jnp.asarray(p, jd))
    td = getattr(torch, dtype)
    got = tmoe._combine(torch.from_numpy(y).to(td),
                        torch.from_numpy(top_i).long(),
                        torch.from_numpy(np.array(slot)).long(),
                        torch.from_numpy(p).to(td))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("tokens,want", [(4, 1), (4 * 64, 40),
                                         (4 * 1100, 688)])
def test_capacity_of_the_full_config(tokens, want):
    """olmoe-1b-7b: ceil(T k / E cf) clamped to [1, T]: a decode step of
    batch 4, a 4 x 64 and a 4 x 1100 prefill."""
    assert tmoe._capacity(tokens, tget("olmoe-1b-7b")) == want
    assert jmoe._capacity(tokens, jget("olmoe-1b-7b")) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_the_reference(dtype):
    """One layer's block on the same [2, 12, 64] input, with drops (smoke
    capacity 18 of 24 tokens x 2 picks over 4 experts)."""
    c = Case("olmoe-1b-7b", dtype)
    jp = jax.tree.map(lambda a: a[0], c.ref["layers"]["moe"])
    tp = _layer0(c.tp["layers"]["moe"])
    x = np.random.default_rng(1).standard_normal((B, S, 64)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    block = jax.jit(jmoe.moe_block, static_argnums=2)
    jout, jaux = block(jp, jx, c.jcfg)
    tout, taux = tmoe.moe_block(tp, torch.from_numpy(x).to(
        getattr(torch, dtype)), c.tcfg)
    want32 = None
    if dtype == "bfloat16":
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        want32 = list(block(jp32, jx.astype(jnp.float32), c.jm32.cfg))
    assert tout.dtype == getattr(torch, dtype)
    c.check([tout, taux], [jout, jaux], f"moe_block {dtype}", want32)


def test_prefill_decode_and_routing_match(case, monkeypatch):
    """Prefill logits and cache, then the cache padded to S + STEPS as
    ``serve`` pads it and STEPS teacher-forced decode steps (logits and
    the whole cache each step); the prefill's routing, layer by layer,
    equal."""
    toks, ids = case.tokens(0, (B, S)), case.tokens(1, (B, STEPS))
    want = ref_trace(case.jm, case.ref, {"tokens": toks}, ids)
    case.check(port_trace(case.tm, case.tp, {"tokens": toks}, ids), want,
               "serve trace")
    jr, tr = _record_routes(monkeypatch, jmoe), \
        _record_routes(monkeypatch, tmoe)
    case.jm.prefill(case.ref, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        case.tm.prefill(case.tp, {"tokens": torch.from_numpy(toks)})
    assert len(jr) == len(tr) == case.tcfg.n_layers
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(t, j)


def test_loss_and_aux_match(case):
    """``ce + aux_loss_coef * aux``, aux summed over the layers."""
    batch = {"tokens": case.tokens(2, (B, S)),
             "targets": case.tokens(3, (B, S))}
    check_loss(case, batch)
    _, met = case.tm.loss(case.tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert float(met["aux"]) > 0.0


def test_batch4_decode_drops_as_the_reference_does():
    """8 experts top-2 at capacity factor 1: a decode step of batch 4 has
    capacity ceil(4 x 2 / 8) = 1, so a token whose expert an earlier token
    of the batch took loses that contribution. Same logits, and the drop
    shows: the dispatch of the step's picks has slots -1."""
    c = Case("olmoe-1b-7b", jover={"moe": JMoE(8, 2, 1.0)},
             tover={"moe": TMoE(8, 2, 1.0)})
    assert tmoe._capacity(4, c.tcfg) == 1
    toks, ids = c.tokens(4, (4, 10)), c.tokens(5, (4, 3))
    want = ref_trace(c.jm, c.ref, {"tokens": toks}, ids)
    c.check(port_trace(c.tm, c.tp, {"tokens": toks}, ids), want, "drop")
    x = np.random.default_rng(6).standard_normal((4, 64)).astype(np.float32)
    _, top_i, _ = tmoe._route(c.tp["layers"]["moe"]["router"][0],
                              torch.from_numpy(x), c.tcfg)
    _, slot = tmoe._dispatch_indices(top_i, 8, 1)
    assert (slot == -1).any()


def test_serve_gives_the_reference_ids_in_float32(monkeypatch):
    """``repro.launch.serve.main`` at seed 0 (3 x 20 prompt + 10) and the
    port's ``serve`` with the params and prompts that ``main`` draws, for
    both presets: the same greedy ids."""
    for arch in ARCHS:
        jcfg = jreplace(jsmoke(arch), **F32)
        monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
        want = jserve.main(["--arch", arch, "--batch", "3", "--prompt-len",
                            "20", "--gen", "10", "--seed", "0"])
        rng = jax.random.PRNGKey(0)
        params = jbuild(jcfg).init(rng)
        prompts = np.array(jax.random.randint(rng, (3, 20), 0,
                                              jcfg.vocab_size))
        got = tserve.serve(tbuild(treplace(tsmoke(arch), **F32)),
                           params_from_numpy(jax.tree.map(np.asarray, params),
                                             "cpu"), prompts, 10, "cpu")
        assert got["ids"].shape == (3, 10) and got["finite"]
        np.testing.assert_array_equal(got["ids"], want)
