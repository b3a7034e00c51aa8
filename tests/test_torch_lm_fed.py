"""Shared harness of the federated LM training tests
(``test_torch_lm_train_*.py``), with a test of its own: one 2-round run
of 3 silos x 2 clients in both packages from the same streams, seeds and
init, at a family's smoke preset in float32 (seq 32, batch 4, 2 steps an
epoch, streams of 6,000 tokens, top-2 of 2 peers with loss scoring and
the int8 wire).

With 3 silos every model's scorers are both other silos, whatever its CID
(``contract._assign_scorers``), and top-2 of 2 peers picks both, so float
noise that moves CIDs between the frameworks cannot move who scores or who
is picked: picks and the ledger height must be equal. Async runs set every
silo's ``time_scale`` to 0, so host compute stays off the simulated clock
and both packages see one schedule.

Every reference object a test builds is appended to KEEP and stays
referenced for the whole test run: the reference's ``fed.client._STEP_CACHE``
keys jitted steps by ``id(model)``, so a reference model that died could
hand its id, and its step, to a later one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JFed
from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.core.builder import build_lm_experiment as jbuild_lm
from repro_torch.config import FedConfig as TFed
from repro_torch.config import replace as treplace
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core.builder import build_lm_experiment as tbuild_lm
from repro_torch.interop import params_from_numpy, params_to_numpy

F32 = dict(param_dtype="float32", compute_dtype="float32")
EXP = dict(seq_len=32, batch_size=4, steps_per_epoch=2, stream_len=6000,
           seed=0)
KEEP = []


def fed_kw(mode="sync", compression="int8"):
    return dict(n_silos=3, clients_per_silo=2, rounds=2, local_epochs=1,
                mode=mode, scorer="loss", agg_policy="top_k", policy_k=2,
                compression=compression)


def losses(orch):
    return [s.cluster.evaluate()["loss"] for s in orch.silos]


def run_pair(arch, mode="sync", compression="int8", rounds=2):
    """(reference orch, port orch, {'pre', 'post'} eval losses of each)
    after ``rounds`` rounds; the reference's init installed in the port."""
    kw = fed_kw(mode, compression)
    jo = jbuild_lm(jreplace(jsmoke(arch), **F32), JFed(**kw), **EXP)
    KEEP.append(jo)
    to = tbuild_lm(treplace(tsmoke(arch), **F32), TFed(**kw), device="cpu",
                   **EXP)
    init = jax.tree.map(np.asarray, jo.silos[0].cluster.params)
    for s in to.silos:
        s.cluster.params = params_from_numpy(init, "cpu")
    for o in (jo, to):
        for s in o.silos:
            s.time_scale = 0.0
    out = {"jpre": losses(jo), "tpre": losses(to)}
    jo.run(rounds)
    to.run(rounds)
    out.update(jpost=losses(jo), tpost=losses(to))
    return jo, to, out


def check_pair(jo, to, out, tol):
    """Equal picks and ledger height, a verified ledger, every silo's eval
    loss before and after and every round's local loss within ``tol``."""
    assert [s.pick_log for s in to.silos] == [s.pick_log for s in jo.silos]
    assert to.ledger.height == jo.ledger.height
    assert to.ledger.verify()
    np.testing.assert_allclose(out["tpre"], out["jpre"], rtol=0, atol=tol)
    np.testing.assert_allclose(out["tpost"], out["jpost"], rtol=0, atol=tol)
    for js, ts in zip(jo.silos, to.silos):
        assert len(ts.metrics) == len(js.metrics)
        for jm, tm in zip(js.metrics, ts.metrics):
            assert abs(tm["local"]["loss"] - jm["local"]["loss"]) <= tol
            assert abs(tm["client_loss"] - jm["client_loss"]) <= tol
    assert all(np.isfinite(out["tpost"]))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch at one intra-op thread for the module's tests, restored after:
    these files run beside five other pytest workers, host-timed tests
    among them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_pair_starts_both_packages_from_one_init():
    """With no round run, every port silo holds the reference's init bit
    for bit and evaluates it to the reference's losses (1e-5 relative)."""
    jo, to, out = run_pair("qwen3-1.7b", rounds=0)
    want = jax.tree.map(np.asarray, jo.silos[0].cluster.params)
    for s in to.silos:
        got = params_to_numpy(s.cluster.params)
        assert jax.tree.all(jax.tree.map(np.array_equal, got, want))
    np.testing.assert_allclose(out["tpre"], out["jpre"], rtol=1e-5)
    assert out["tpost"] == out["tpre"]
    assert to.ledger.height == jo.ledger.height      # the registrations
