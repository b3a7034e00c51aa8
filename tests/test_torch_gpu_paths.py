"""The edge tier and the LM families on the card, against the same runs on
the CPU. Every test here needs a CUDA device (marker ``gpu``) and skips
without one; the file imports no JAX, so it runs where the card is:

  python -m pytest -m gpu tests/test_torch_gpu_paths.py

Tolerance of the decoder: GPU_REL = 1e-4 of each output's largest
magnitude, float32 with TF32 off (cuBLAS sums in another order than the
CPU's BLAS; ``chip_smoke.py`` holds the full width at depth 2 to the same).
"""
import pytest
import torch

from repro_torch import tree
from repro_torch.config import FedConfig, replace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.builder import build_image_experiment, resolve_device
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.tree import tree_map

GPU_REL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


def _edge(device):
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=2, local_epochs=1,
                    agg_policy="top_k", policy_k=2, edge_per_silo=8,
                    edge_participation=0.5)
    orch = build_image_experiment(get_config("paper-cnn"), fed, n_train=400,
                                  n_test=160, batch_size=8, seed=0,
                                  device=device)
    for s in orch.silos:
        s.time_scale = 0.0
    return orch


@pytest.mark.gpu
def test_gpu_edge_run_matches_the_cpu_and_launches_weighted_sum():
    """Two Sync rounds of 3 silos x 8 edge clients on the card: the CPU
    run's picks, ledger height and edge metrics, and one ``weighted_sum``
    launch a silo and round (``fedavg_up``), nothing else."""
    _cuda()
    card = _edge("cuda")
    _build.reset_launches()
    card.run(2)
    launches = _build.launch_counts()
    cpu = _edge("cpu")
    cpu.run(2)
    keys = ("edge_participants", "edge_trained", "edge_skipped",
            "edge_bytes", "edge_sim_s")
    assert [s.pick_log for s in card.silos] == [s.pick_log for s in cpu.silos]
    assert card.ledger.height == cpu.ledger.height
    assert [[[m[k] for k in keys] for m in s.metrics] for s in card.silos] \
        == [[[m[k] for k in keys] for m in s.metrics] for s in cpu.silos]
    ups = sum(m["edge_trained"] > 0 for s in card.silos for m in s.metrics)
    assert launches == {**{k: 0 for k in launches}, "weighted_sum": ups}
    assert all(t.is_cuda for s in card.silos
               for t in tree.leaves(s.cluster.params))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,over", [("qwen3-1.7b", {}),
                                       ("qwen1.5-110b", {}),
                                       ("qwen3-1.7b", {"attn_window": 32})])
def test_gpu_dense_decoder_matches_the_cpu(arch, over):
    """Smoke width in float32: prefill logits and cache, then 6 decode
    steps fed the card's greedy tokens, on the card and on the CPU; no
    ported kernel launches on this path."""
    _cuda()
    cfg = replace(get_smoke_config(arch), **F32, **over)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(1))

    def run(p, dev, feed=None):
        outs, fed = [], []
        with torch.inference_mode():
            logits, cache = model.prefill(p, {"tokens": prompts.to(dev)})
            outs += [logits, cache["k"].clone()]
            tok = logits[:, -1].argmax(-1)
            for i in range(6):
                tok = tok if feed is None else feed[i].to(dev)
                fed.append(tok)
                logits, cache = model.decode_step(
                    p, {"token": tok, "pos": 40 + i}, cache)
                outs.append(logits)
                tok = logits.argmax(-1)
        return [o.float().cpu() for o in outs], fed

    _build.reset_launches()
    card, feed = run(params, "cuda")
    assert not any(_build.launch_counts().values())
    cpu, _ = run(tree_map(lambda t: t.cpu(), params), "cpu", feed)
    for a, b in zip(card, cpu):
        assert (a - b).abs().max() <= GPU_REL * b.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,over", [("olmoe-1b-7b", {}),
                                       ("mixtral-8x7b", {}),
                                       ("recurrentgemma-9b", {"n_layers": 5}),
                                       ("seamless-m4t-medium", {})])
def test_gpu_lm_families_match_the_cpu(arch, over):
    """The moe, hybrid and encdec families at smoke width in float32: the
    prefill logits and cache, the cache padded as ``serve`` pads it, then
    6 decode steps fed the card's greedy tokens, on the card and on the
    CPU; no ported kernel launches on these paths."""
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models.encdec import src_len
    _cuda()
    cfg = replace(get_smoke_config(arch), **F32, **over)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, src_len(40), cfg.d_model),
                                      generator=g)

    def run(p, dev, feed=None):
        outs, fed = [], []
        with torch.inference_mode():
            logits, cache = model.prefill(p, {k: v.to(dev)
                                              for k, v in batch.items()})
            outs += [logits, *[t.clone() for t in tree.leaves(cache)]]
            cache = pad_cache(model.init_cache(2, 46, dev), cache)
            tok = logits[:, -1].argmax(-1)
            for i in range(6):
                tok = tok if feed is None else feed[i].to(dev)
                fed.append(tok)
                logits, cache = model.decode_step(
                    p, {"token": tok, "pos": 40 + i}, cache)
                outs.append(logits)
                tok = logits.argmax(-1)
            outs += tree.leaves(cache)
        return [o.float().cpu() for o in outs], fed

    _build.reset_launches()
    card, feed = run(params, "cuda")
    assert not any(_build.launch_counts().values())
    cpu, _ = run(tree_map(lambda t: t.cpu(), params), "cpu", feed)
    for a, b in zip(card, cpu):
        assert (a - b).abs().max() <= GPU_REL * b.abs().max()


def _lm_run(device, arch="qwen3-1.7b"):
    from repro_torch.core.builder import build_lm_experiment
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=2, local_epochs=1,
                    scorer="loss", agg_policy="top_k", policy_k=2,
                    compression="int8")
    orch = build_lm_experiment(replace(get_smoke_config(arch), **F32), fed,
                               seq_len=32, batch_size=4, steps_per_epoch=2,
                               stream_len=6000, device=device)
    orch.run(2)
    return orch, [s.cluster.evaluate()["loss"] for s in orch.silos]


@pytest.mark.gpu
def test_gpu_lm_training_matches_the_cpu():
    """Two Sync rounds of federated LM training (int8, loss scoring) at
    qwen3-1.7b's smoke preset in float32: the CPU run's picks and ledger
    height, eval losses within 1e-5 and each silo's parameters within 1e-5
    of the CPU's, as a norm of the difference over the norm
    (``chip_smoke.py``'s LM_LOSS_TOL and LM_PARAM_RTOL), and the path's
    four kernels launched."""
    from repro_torch.kernels import ops
    _cuda()
    _build.reset_launches()
    card, card_loss = _lm_run("cuda")
    launches = _build.launch_counts()
    cpu, cpu_loss = _lm_run("cpu")
    assert [s.pick_log for s in card.silos] == [s.pick_log for s in cpu.silos]
    assert card.ledger.height == cpu.ledger.height
    assert max(abs(a - b) for a, b in zip(card_loss, cpu_loss)) <= 1e-5
    for a, b in zip(card.silos, cpu.silos):
        va = ops.flatten_pytree(a.cluster.params)[0].cpu().double()
        vb = ops.flatten_pytree(b.cluster.params)[0].double()
        assert (va - vb).norm() <= 1e-5 * vb.norm()
    assert all(launches[k] > 0 for k in ("weighted_sum", "quantize",
                                         "dequantize", "wsum_q8"))


GRAD_REL = 1e-4   # of each leaf's largest gradient (test_torch_rwkv6_train)
TIME_MIX = ("wr", "wk", "wv", "wg", "decay_base", "decay_w1", "decay_w2",
            "bonus_u", "mix_mu", "mix_w1", "mix_w2")


def _rwkv6_grads(model, params, batch):
    paths, leaves = zip(*tree.leaves_with_paths(params))
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, _ = model.loss(tree.unflatten(list(paths), leaves), batch)
    return dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.gpu
def test_gpu_rwkv6_client_step_matches_the_cpu():
    """One client step's gradients of the 2-layer RWKV-6 smoke preset in
    float32, on the client's first batch of its Markov stream: on the card
    through the ``wkv6`` and ``wkv6_backward`` kernels (``wkv6`` once a
    layer's forward, which ``cfg.remat`` 'full' runs twice a step;
    ``wkv6_backward`` once a layer), within GRAD_REL of the CPU's
    (autograd of the plain scan), and every time-mix leaf's gradient
    nonzero."""
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.fed.client import Client
    dev = _cuda()
    cfg = replace(get_smoke_config("rwkv6-1.6b"), **F32)
    assert cfg.n_layers == 2
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    stream = make_lm_dataset(vocab=cfg.vocab_size, length=2000, seed=0)[0]
    client = Client("c", model, {"tokens": stream, "seq_len": 32,
                                 "steps_per_epoch": 1}, device="cpu",
                    batch_size=2)
    batch = next(client._batches(1))
    _build.reset_launches()
    card = _rwkv6_grads(model, tree_map(lambda a: a.to(dev), params),
                        {k: a.to(dev) for k, a in batch.items()})
    launches = _build.launch_counts()
    cpu = _rwkv6_grads(model, params, batch)
    assert launches["wkv6"] == L.remat_forwards(cfg.remat) * cfg.n_layers
    assert launches["wkv6_backward"] == cfg.n_layers
    for path, want in cpu.items():
        got = card[path].cpu()
        top = float(want.abs().max())
        assert float((got - want).abs().max()) <= GRAD_REL * top, path
        if path[-1] in TIME_MIX:
            assert float(got.abs().max()) > 0, path


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,hs,dtype", [
    (2, 70, 4, 16, torch.float32), (2, 70, 4, 16, torch.bfloat16),
    (3, 100, 2, 64, torch.bfloat16), (1, 1, 2, 64, torch.float32),
    (2, 1, 3, 16, torch.float32), (3, 45, 2, 16, torch.bfloat16)])
def test_gpu_wkv6_backward_matches_its_plain_version(B, T, H, hs, dtype):
    """The ``wkv6_backward`` kernel against ``ref.wkv6_backward_naive`` and
    its chunked arithmetic (``ref.wkv6_backward_chunks``) on the card,
    ragged T (T = 1 included), with a final state's gradient: each gradient
    within 1e-4 of its max|.| in f32, one bf16 ulp (2^-7) of it in bf16."""
    from repro_torch.kernels import ref, rwkv6
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(B * T + hs)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    r, k, v, dy = (n(B, T, H, hs).to(dtype) for _ in range(4))
    w = torch.sigmoid(2.0 * n(B, T, H, hs))
    u, s0, ds = n(H, hs) * 0.3, n(B, H, hs, hs) * 0.1, n(B, H, hs, hs)
    got = rwkv6.backward(r, k, v, w, u, s0, dy, ds)
    for plain in (ref.wkv6_backward_naive, ref.wkv6_backward_chunks):
        want = plain(r, k, v, w, u, s0, dy, ds)
        for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "dstate"),
                              got, want):
            assert a.dtype == b.dtype, name
            tol = (2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-4) * \
                float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("hs,dtype", [(16, torch.bfloat16),
                                      (64, torch.float32)])
@pytest.mark.parametrize("wanted", [(2,), (5,), (4,), (0,), (1, 2, 5)],
                         ids=["dv", "dstate0", "du", "dr", "dk+dv+dstate0"])
def test_gpu_wkv6_backward_gives_what_it_is_asked_for(hs, dtype, wanted):
    """A call asking for a part of the gradients (the pass on one role or
    none, the chunk kernel with a null state or not at all) gives the full
    call's bits for each of them and None for the rest."""
    from repro_torch.kernels import rwkv6
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(hs)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    r, k, v, dy = (n(2, 45, 3, hs).to(dtype) for _ in range(4))
    w = torch.sigmoid(2.0 * n(2, 45, 3, hs))
    u, s0, ds = n(3, hs) * 0.3, n(2, 3, hs, hs) * 0.1, n(2, 3, hs, hs)
    args = (r, k, v, w, u, s0, dy, ds)
    full = rwkv6.backward(*args)
    part = rwkv6.backward(*args, needs=tuple(i in wanted for i in range(6)))
    for i, (a, b) in enumerate(zip(full, part)):
        if i in wanted:
            assert torch.equal(a, b), i
        else:
            assert b is None, i


@pytest.mark.gpu
def test_gpu_wkv6_takes_its_function_only_under_a_gradient():
    """Outside a gradient ``wkv6`` launches the forward kernel directly
    and records no autograd node; with an input that requires grad it goes
    through ``WKV6``, whose backward launches ``wkv6_backward`` once."""
    from repro_torch.kernels import rwkv6
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    r, k, v = (n(2, 40, 2, 64) for _ in range(3))
    w = torch.sigmoid(n(2, 40, 2, 64))
    u, s0 = n(2, 64) * 0.3, n(2, 2, 64, 64) * 0.1
    _build.reset_launches()
    y, _ = rwkv6.wkv6(r, k, v, w, u, s0)
    assert y.grad_fn is None
    r.requires_grad_()
    with torch.no_grad():
        assert rwkv6.wkv6(r, k, v, w, u, s0)[0].grad_fn is None
    y2, _ = rwkv6.wkv6(r, k, v, w, u, s0)
    assert type(y2.grad_fn).__name__ == "WKV6Backward"
    assert torch.equal(y2.detach(), y)
    torch.autograd.grad(y2.sum(), r)
    counts = _build.launch_counts()
    assert counts["wkv6"] == 3 and counts["wkv6_backward"] == 1
