"""Federated LM training on the Async engine, and uncompressed on the Sync
one, in both packages at ``qwen3-1.7b``'s smoke preset (``test_torch_lm_fed`` is
the harness; every silo at time_scale 0).

Tolerance: LOSS_TOL = 1e-4 on every eval and client loss (losses near 6;
measured below 1e-6).
"""
from test_torch_lm_fed import check_pair, one_torch_thread, run_pair  # noqa: F401

LOSS_TOL = 1e-4


def test_async_lm_run_matches_reference():
    jo, to, out = run_pair("qwen3-1.7b", mode="async")
    check_pair(jo, to, out, LOSS_TOL)
    assert to.ledger.height == 45
    assert all(s.rounds_done == 2 for s in to.silos)


def test_uncompressed_sync_lm_run_matches_reference():
    jo, to, out = run_pair("qwen3-1.7b", compression="none")
    check_pair(jo, to, out, LOSS_TOL)
