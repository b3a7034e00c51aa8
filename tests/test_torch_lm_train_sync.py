"""Two Sync rounds of federated LM training (int8 wire, loss scoring) in
both packages at the smoke presets of the dense, vlm and moe families
(``test_torch_lm_fed`` is the harness).

Tolerance: LOSS_TOL = 1e-4 on every eval and client loss (losses near 6;
measured differences up to 1.7e-5, at ``chameleon-34b``: float32 sums in
another order over 8 SGD steps and two merges of int8 codes).
"""
import pytest

from test_torch_lm_fed import check_pair, one_torch_thread, run_pair  # noqa: F401

LOSS_TOL = 1e-4


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "chameleon-34b",
                                  "olmoe-1b-7b"])
def test_sync_lm_run_matches_reference(arch):
    jo, to, out = run_pair(arch)
    check_pair(jo, to, out, LOSS_TOL)
    # round 2 merges both peers: the first round published their models
    assert to.silos[0].pick_log == [{"round": 1, "owners": []},
                                    {"round": 2,
                                     "owners": ["silo1", "silo2"]}]
