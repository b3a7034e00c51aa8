"""RWKV-6 training: the gradients the port takes on the CPU (through the
plain token scan) against the reference's ``jax.grad`` at the smoke preset
(the step on the card, through the ``wkv6`` and ``wkv6_backward`` kernels,
is ``test_torch_gpu_paths.py``'s; the backward itself is
``test_torch_wkv6_backward.py``'s).

Tolerance: GRAD_REL = 1e-4 of each leaf's largest gradient (float32 sums in
another order through the recurrence; 7.1e-6 measured on another batch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import grad, grad_and_value

from repro.data.synthetic import make_lm_dataset
from repro_torch.interop import params_from_numpy
from repro_torch.tree import leaves_with_paths
from test_torch_lm_parity import Case
from test_torch_lm_fed import KEEP, one_torch_thread  # noqa: F401

GRAD_REL = 1e-4


def test_rwkv6_gradients_match_reference():
    case = Case("rwkv6-1.6b")
    KEEP.append(case.jm)
    stream = make_lm_dataset(vocab=case.jcfg.vocab_size, length=2000,
                             seed=1)[0]
    starts = np.random.default_rng(0).integers(0, len(stream) - 33, 4)
    win = np.stack([stream[s:s + 33] for s in starts]).astype(np.int64)
    batch = {"tokens": win[:, :-1], "targets": win[:, 1:]}
    (jl, _), jg = jax.value_and_grad(case.jm.loss, has_aux=True)(
        case.ref, {k: jnp.asarray(v) for k, v in batch.items()})
    tg, (tl, _) = grad_and_value(case.tm.loss, has_aux=True)(
        case.tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jg)))
    got = leaves_with_paths(tg)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        w = want[path]
        top = np.abs(w).max()
        assert top > 0, path          # every parameter gets a gradient
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * top, path


def test_rwkv6_training_is_ill_conditioned_in_the_reference_too():
    """Why the RWKV-6 training runs are held to a looser loss tolerance
    (``test_torch_lm_train_recurrent.py``): one SGD step from the init
    (lr 0.05), the reference's own embedding gradient moves by more when
    its params move by 2e-7 relative than it differs from the port's at
    the same point, and both exceed GRAD_REL of the largest entry."""
    from repro.fed.client import Client as JClient
    case = Case("rwkv6-1.6b")
    KEEP.append(case.jm)
    stream = make_lm_dataset(vocab=case.jcfg.vocab_size, length=6000,
                             seed=0)[0]
    jc = JClient("c", case.jm, {"tokens": stream, "seq_len": 32,
                                "steps_per_epoch": 1},
                 batch_size=4, lr=0.05, seed=3)
    params, _, _ = jc.local_train(case.ref, 1)
    params = jax.tree.map(np.asarray, params)
    batch = {k: np.asarray(v) for k, v in next(jc._batches(1)).items()}
    jgrad = jax.grad(lambda p, b: case.jm.loss(p, b)[0])
    rng = np.random.default_rng(1)
    moved = jax.tree.map(lambda a: (a * (1 + 2e-7 * rng.standard_normal(
        a.shape))).astype(np.float32), params)
    want = np.asarray(jgrad(params, batch)["embed"]["embedding"])
    again = np.asarray(jgrad(moved, batch)["embed"]["embedding"])
    got = grad(lambda p: case.tm.loss(p, {
        k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()})[
            0])(params_from_numpy(params, "cpu"))["embed"]["embedding"]
    top = np.abs(want).max()
    port_err = np.abs(got.numpy() - want).max()
    self_err = np.abs(again - want).max()
    assert port_err <= self_err, (port_err, self_err, top)
    assert self_err > GRAD_REL * top


def test_client_step_gives_the_torch_func_gradient_bits():
    """The client's step differentiates with ``torch.autograd.grad`` (it
    frees the forward's saved tensors as the backward goes); its RWKV-6
    gradients are bit for bit those of ``torch.func.grad_and_value``,
    which differentiates with grad mode on in the backward: the gate's
    silu (``models/rwkv6._Silu``) takes that backward formula in both."""
    from repro_torch.fed.client import make_train_step
    case = Case("rwkv6-1.6b")
    KEEP.append(case.jm)
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, case.tcfg.vocab_size, (4, 33), generator=g)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    step, opt = make_train_step(case.tm)
    got, _, _ = step(case.tp, opt.init(case.tp), batch, 1.0)
    want, _ = grad_and_value(case.tm.loss, has_aux=True)(case.tp, batch)
    want, got = dict(leaves_with_paths(want)), dict(leaves_with_paths(got))
    for path, p in leaves_with_paths(case.tp):
        assert torch.equal(got[path], p - want[path]), path


def test_gradients_explode_with_depth_in_the_reference_too():
    """Why ``chip_smoke.py`` trains ``rwkv6-1.6b`` at full width at a rate
    far below the LM runs' 0.05 (a fault of the reference's init that the
    port copies): RWKV-6's gradients grow with depth. At the smoke width,
    on two 128-token windows of a Markov stream, the largest gradient
    entry grows from 4.40 at 2 layers to 1,491 at 12 in the reference
    (measured), and alike in the port from the same init: more than 100x
    in both."""
    stream = make_lm_dataset(vocab=256, length=2000, seed=1)[0]
    starts = np.random.default_rng(0).integers(0, len(stream) - 129, 2)
    win = np.stack([stream[s:s + 129] for s in starts]).astype(np.int64)
    batch = {"tokens": win[:, :-1], "targets": win[:, 1:]}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    top = {}
    for n in (2, 12):
        case = Case("rwkv6-1.6b", n_layers=n)
        KEEP.append(case.jm)
        jg = jax.grad(lambda p: case.jm.loss(p, batch)[0])(case.ref)
        tg = grad(lambda p: case.tm.loss(p, tbatch)[0])(case.tp)
        top[n] = (max(float(np.abs(np.asarray(g)).max())
                      for g in jax.tree.leaves(jg)),
                  max(float(g.abs().max()) for _, g in leaves_with_paths(tg)))
    assert top[12][0] > 100 * top[2][0], top
    assert top[12][1] > 100 * top[2][1], top
