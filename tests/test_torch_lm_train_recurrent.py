"""Two Sync rounds of federated LM training (int8 wire, loss scoring) in
both packages at the smoke presets of the recurrent families: the RG-LRU
hybrid (``recurrentgemma-9b``) and RWKV-6 (``rwkv6-1.6b``, ``ssm``), on the
CPU, where RWKV-6 trains through the plain token scan
(``test_torch_lm_fed`` is the harness).

Tolerance on every eval and client loss (losses near 6):
- hybrid: 1e-4 (measured 5e-7).
- ssm: 1e-2 (measured 1.3e-3 int8, 5.7e-3 uncompressed). RWKV-6's training
  is ill-conditioned at this preset, in the reference too: one SGD step
  from the shared init, the reference's own embedding gradient moves by
  7.1e-3 (of a largest entry 6.6) when its params move by 2e-7 relative,
  while the two packages' gradients at that point differ by 2.4e-3
  (``test_torch_rwkv6_train.py``, which also holds the gradients at the
  init to 1e-4 of each leaf), so the runs drift apart step by step.
"""
import pytest

from test_torch_lm_fed import check_pair, one_torch_thread, run_pair  # noqa: F401


@pytest.mark.parametrize("arch,tol", [("recurrentgemma-9b", 1e-4),
                                      ("rwkv6-1.6b", 1e-2)])
def test_sync_lm_run_matches_reference(arch, tol):
    jo, to, out = run_pair(arch)
    check_pair(jo, to, out, tol)
