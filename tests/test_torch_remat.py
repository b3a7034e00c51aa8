"""Per-layer rematerialisation (``layers.remat``, ``cfg.remat``): 'full'
(``torch.utils.checkpoint``), 'dots' (the weight products' outputs kept,
as ``dots_with_no_batch_dims_saveable``) and 'none' give bit-equal loss
and gradients in every trainable family, at the float32 smoke presets;
'full' lowers ``MemTracker``'s peak of a training step; RWKV-6 through
the ``WKV6`` autograd Function (its CPU form) recomputes each layer's
forward once more under 'full', with the same gradients."""
import numpy as np
import pytest
import torch
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch import tree
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.encdec import src_len

torch.set_num_threads(1)

ARCHS = ("qwen3-1.7b", "chameleon-34b", "olmoe-1b-7b", "rwkv6-1.6b",
         "recurrentgemma-9b", "seamless-m4t-medium")


def setup(arch, mode, B=2, S=24):
    cfg = replace(get_smoke_config(arch), param_dtype="float32",
                  compute_dtype="float32", remat=mode)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, src_len(S), cfg.d_model)).astype(np.float32))
    return model, params, batch


def loss_and_grads(model, params, batch):
    paths, leaves = zip(*tree.leaves_with_paths(params))
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, _ = model.loss(tree.unflatten(list(paths), leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True,
                                              materialize_grads=True)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ("full", "dots"))
def test_remat_is_bit_equal(arch, mode):
    want_loss, want = loss_and_grads(*setup(arch, "none"))
    loss, got = loss_and_grads(*setup(arch, mode))
    assert torch.equal(loss, want_loss)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "rwkv6-1.6b"))
def test_full_remat_lowers_the_peak(arch):
    peaks = {}
    for mode in ("none", "full"):
        model, params, batch = setup(arch, mode, B=4, S=128)
        mt = MemTracker()
        mt.track_external(*tree.leaves(params))
        with mt:
            loss_and_grads(model, params, batch)
        peaks[mode] = mt.get_tracker_snapshot("peak")[
            torch.device("cpu")]["Total"]
    assert peaks["full"] < peaks["none"], peaks


def test_full_remat_through_the_wkv6_function(monkeypatch):
    """With ``ops.wkv6`` routed through ``kernels.rwkv6.WKV6`` (as a CUDA
    tensor is), 'full' calls its forward twice a layer (the forward and
    its recomputation) and its backward once, and the gradients are those
    without remat."""
    from repro_torch.kernels import ops, rwkv6
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = rwkv6.WKV6.forward, rwkv6.WKV6.backward

    def forward(*a):
        calls["forward"] += 1
        return fwd(*a)

    def backward(ctx, *g):
        calls["backward"] += 1
        return bwd(ctx, *g)
    monkeypatch.setattr(rwkv6.WKV6, "forward", staticmethod(forward))
    monkeypatch.setattr(rwkv6.WKV6, "backward", staticmethod(backward))
    monkeypatch.setattr(ops, "wkv6", lambda *a: rwkv6.WKV6.apply(*a))
    got = {}
    for mode in ("none", "full"):
        calls.update(forward=0, backward=0)
        model, params, batch = setup("rwkv6-1.6b", mode)
        got[mode] = loss_and_grads(model, params, batch)
        n = model.cfg.n_layers
        assert calls == {"forward": n * (2 if mode == "full" else 1),
                         "backward": n}, (mode, calls)
    assert torch.equal(got["full"][0], got["none"][0])
    for a, b in zip(got["full"][1], got["none"][1]):
        assert torch.equal(a, b)
