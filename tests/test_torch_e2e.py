"""The slice end to end: a 2-round Sync UnifyFL run in both packages.

3 silos x 2 clients, n_train=400, n_test=160, top_k with k=2, seed 0, and
the reference's init installed in the port's clusters. With 3 silos every
model's scorer set is both other silos whatever its CID
(contract._assign_scorers), and top-2 of 2 peers picks both, so float noise
that changes CIDs across frameworks cannot change who scores or who is
picked: the pick owners and the ledger height must be equal.

Accuracy tolerance: 2/160 per silo on the global test set. Both runs take
the same batches from the same seeds; their parameters differ only by
float32 rounding (~1e-7 after two rounds), which can flip a prediction that
sits on a decision boundary, not more.
"""
import jax
import numpy as np
import pytest

from repro.config import FedConfig as JFed
from repro.configs import get_config as jget
from repro.core.builder import build_image_experiment as jbuild_exp
from repro.core.builder import global_eval as jglobal
from repro_torch.config import FedConfig as TFed
from repro_torch.configs import get_config as tget
from repro_torch.core.builder import build_image_experiment as tbuild_exp
from repro_torch.core.builder import global_eval as tglobal
from repro_torch.interop import params_from_numpy

ACC_TOL = 2 / 160


def _fed(cls, compression):
    return cls(n_silos=3, clients_per_silo=2, rounds=2, mode="sync",
               scorer="accuracy", agg_policy="top_k", policy_k=2,
               compression=compression)


def _exp(build, fed, **kw):
    return build(fed, partition="niid", alpha=0.2, n_train=400, n_test=160,
                 seed=0, **kw)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_sync_round_matches_reference(compression):
    jo = _exp(lambda f, **k: jbuild_exp(jget("paper-cnn"), f, **k),
              _fed(JFed, compression))
    init = jax.tree.map(np.asarray, jo.silos[0].cluster.params)
    to = _exp(lambda f, **k: tbuild_exp(tget("paper-cnn"), f, **k),
              _fed(TFed, compression), device="cpu")
    for s in to.silos:
        s.cluster.params = params_from_numpy(init, "cpu")
    jo.run(2)
    to.run(2)
    assert [s.pick_log for s in to.silos] == [s.pick_log for s in jo.silos]
    assert to.silos[0].pick_log[1]["owners"] == ["silo1", "silo2"]
    assert to.ledger.height == jo.ledger.height
    assert to.ledger.verify()
    ja, ta = jglobal(jo), tglobal(to)
    for sid in ja:
        assert abs(ta[sid]["accuracy"] - ja[sid]["accuracy"]) <= ACC_TOL, sid
    for js, ts in zip(jo.silos, to.silos):
        for jm, tm in zip(js.metrics, ts.metrics):
            assert abs(tm["local"]["accuracy"] - jm["local"]["accuracy"]) \
                <= 1 / 50, js.silo_id
    # every submitted model and checkpoint is in the store under its CID
    silo = to.silos[0]
    assert silo.store.has(silo.last_cid)
    cp = silo.checkpoint()
    before = {k: v.clone() for k, v in silo.cluster.params["fc2"].items()}
    silo.cluster.params["fc2"]["w"].zero_()
    silo.restore_from(cp)
    assert (silo.cluster.params["fc2"]["w"] == before["w"]).all()
