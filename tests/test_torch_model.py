"""Paper CNN and optimizers vs the JAX reference, from carried-over params.

Loss, metrics and gradients agree to 1e-5 (float32 convolutions in another
summation order); one optimizer step agrees to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.configs import get_config
from repro.models import build_model as jbuild
from repro.optim import fedopt as jfedopt
from repro.optim import local as jlocal
from repro_torch.configs import get_config as tget
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import build_model as tbuild
from repro_torch.optim import fedopt as tfedopt
from repro_torch.optim import local as tlocal
from repro_torch.tree import leaves_with_paths

TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return jbuild(get_config("paper-cnn")), tbuild(tget("paper-cnn"))


@pytest.fixture(scope="module")
def ref_params(models):
    return jax.tree.map(np.asarray, models[0].init(jax.random.PRNGKey(0)))


def _batch(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _assert_trees_close(t_tree, j_tree, tol):
    for path, a in leaves_with_paths(params_to_numpy(t_tree)):
        b = j_tree
        for k in path:
            b = b[k]
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=str(path))


def test_init_layout_matches_reference(models, ref_params):
    tp = models[1].init(torch.Generator().manual_seed(0), "cpu")
    t_shapes = [(p, tuple(l.shape), l.dtype) for p, l in leaves_with_paths(tp)]
    j_shapes = [(p, tuple(l.shape)) for p, l in leaves_with_paths(ref_params)]
    assert [(p, s) for p, s, _ in t_shapes] == j_shapes
    assert all(d == torch.float32 for _, _, d in t_shapes)
    assert sum(l.numel() for _, l in leaves_with_paths(tp)) == 62_006
    # same fan-in scaling as dense_init: std ~ 1/sqrt(fan_in)
    assert abs(float(tp["fc1"]["w"].std()) * 20 - 1) < 0.05


def test_cnn_loss_metrics_and_grads_match(models, ref_params):
    jm, tm = models
    x, y = _batch()
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, ref_params),
        {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    tg, (tl, tmet) = grad_and_value(tm.loss, has_aux=True)(
        params_from_numpy(ref_params, "cpu"),
        {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert set(tmet) == set(jmet) == {"loss", "ce", "accuracy", "aux"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    assert float(tmet["accuracy"]) == float(jmet["accuracy"])
    _assert_trees_close(tg, jax.tree.map(np.asarray, jg), TOL)


@pytest.mark.parametrize("name,momentum", [("sgd", 0.0), ("sgd", 0.9),
                                           ("adam", 0.0), ("adamw", 0.0)])
def test_local_optimizer_steps_match(ref_params, name, momentum):
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), ref_params)
    jo = jlocal.make_optimizer(name, momentum=momentum, weight_decay=0.01)
    to = tlocal.make_optimizer(name, momentum=momentum, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, ref_params)
    tp = params_from_numpy(ref_params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp,
                           jnp.float32(0.01))
        tp, ts = to.update(params_from_numpy(grads, "cpu"), ts, tp, 0.01)
    _assert_trees_close(tp, jax.tree.map(np.asarray, jp), 1e-6)


@pytest.mark.parametrize("name", ["fedavg", "fedyogi", "fedadam",
                                  "fedadagrad"])
def test_server_optimizers_match(name):
    rng = np.random.default_rng(2)
    own = rng.standard_normal(4096).astype(np.float32)
    deltas = [rng.standard_normal(4096).astype(np.float32) * 0.1
              for _ in range(2)]
    jo, to = jfedopt.make_server_optimizer(name), \
        tfedopt.make_server_optimizer(name)
    jp, tp = jnp.asarray(own), torch.from_numpy(own)
    js, ts = jo.init(jp), to.init(tp)
    for d in deltas:
        jp, js = jo.apply(jp, jnp.asarray(d), js)
        tp, ts = to.apply(tp, torch.from_numpy(d), ts)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


def test_other_families_wait_for_their_slice():
    """No family waits any more: every configuration in ``configs/``
    builds, with the reference's kind for its family."""
    from repro.configs import list_archs
    from repro_torch.configs import list_archs as tlist
    assert tlist(include_paper=True) == list_archs(include_paper=True)
    want = {"dense": "decoder", "vlm": "decoder", "moe": "decoder",
            "ssm": "ssm", "hybrid": "hybrid", "encdec": "encdec",
            "cnn": "cnn"}
    for arch in tlist(include_paper=True):
        cfg = tget(arch)
        assert tbuild(cfg).kind == want[cfg.family] == \
            jbuild(get_config(arch)).kind, arch
