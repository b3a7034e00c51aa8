"""The slice end to end: Sync runs with ``int8-delta`` and with MultiKRUM in
both packages, with the reference's init installed in the port's clusters.

3 silos x 2 clients, n_train=400, n_test=160, top_k with k=2, seed 0, as in
test_torch_e2e.py: with 3 silos every model's scorer set is both other
silos and top-2 of 2 peers picks both, so the pick owners and the ledger
height must be equal.

Tolerances:
- global accuracy: 2/160 per silo (float32 rounding between the two
  frameworks can flip a prediction on a decision boundary, not more);
- each MultiKRUM score on the contract: within ``m · 2^-16 · max‖x‖²`` of
  the reference's, ``x`` the round's submitted models. A distance is
  ``sq_i + sq_j - 2 G_ij`` with ``‖x‖² ≈ 10^3`` here and distances near
  0.05, so the float32 sums' order (per-tile int8 products summed in the
  reference's kernel, one matmul in the port's plain version) moves the
  score by a few ulps of ``‖x‖²``, about 10^-3, whatever its size.
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


def _run_both(compression, scorer, rounds):
    fed = lambda cls: cls(n_silos=3, clients_per_silo=2, rounds=rounds,
                          mode="sync", scorer=scorer, agg_policy="top_k",
                          policy_k=2, compression=compression)
    kw = dict(partition="niid", alpha=0.2, n_train=400, n_test=160, seed=0)
    jo = jbuild_exp(jget("paper-cnn"), fed(JFed), **kw)
    init = jax.tree.map(np.asarray, jo.silos[0].cluster.params)
    to = tbuild_exp(tget("paper-cnn"), fed(TFed), device="cpu", **kw)
    for s in to.silos:
        s.cluster.params = params_from_numpy(init, "cpu")
    jo.run(rounds)
    to.run(rounds)
    return jo, to


def _scores(orch):
    return {(e.round, e.owner, sid): v for e in orch.contract.models.values()
            for sid, v in e.scores.items()}


def _max_sq(orch):
    """Per round, the largest ‖x‖² of the models submitted in it."""
    silo = orch.silos[0]
    out = {}
    for e in orch.contract.models.values():
        v = np.asarray(silo.get_decoded(e.cid).vec(), np.float64)
        out[e.round] = max(out.get(e.round, 0.0), float(v @ v))
    return out


@pytest.mark.parametrize("compression,scorer,rounds", [
    ("int8-delta", "accuracy", 3),
    ("int8", "multikrum", 2),
    ("int8-delta", "multikrum", 2),
])
def test_sync_run_matches_reference(compression, scorer, rounds):
    jo, to = _run_both(compression, scorer, rounds)
    assert [s.pick_log for s in to.silos] == [s.pick_log for s in jo.silos]
    assert to.silos[0].pick_log[1]["owners"] == ["silo1", "silo2"]
    assert to.ledger.height == jo.ledger.height
    assert to.ledger.verify()
    ja, ta = jglobal(jo), tglobal(to)
    for sid in ja:
        assert abs(ta[sid]["accuracy"] - ja[sid]["accuracy"]) <= ACC_TOL, sid
    js, ts = _scores(jo), _scores(to)
    assert sorted(ts) == sorted(js)
    assert len(js) == 6 * rounds          # 3 models x 2 scorers a round
    if scorer == "multikrum":
        m = min(to.fed.multikrum_m, 2)
        max_sq = _max_sq(jo)
        for key, want in js.items():
            assert want < 0                   # negated distance sums
            assert abs(ts[key] - want) <= m * 2.0 ** -16 * max_sq[key[0]], key
    if compression == "int8-delta":
        # from round 2 on, every silo ships a delta against its last model
        silo = to.silos[0]
        last = silo.get_decoded(silo.last_cid)
        assert last.method == "int8-delta" and last.base_cid
        assert silo.store.stats["decodes"] > 0
