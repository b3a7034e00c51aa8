"""``correct`` at the small sizes on the CPU: a sound run passes its cell's
limits; the control (the reference in fp8 in the program's place) fails
them; and a run whose timed path is broken underneath comes out not
correct, for each fault a training cell can have and for a wrong
``wkv6`` backward in the RWKV-6 cell."""
import pytest
import torch

from bench import faults, harness, judge, smoke
from bench.reference.round import FAULTS

torch.set_num_threads(1)

CELLS = ("pod_topk_int8.qwen3-1.7b", "pod_mean.rwkv6-1.6b")


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    res = smoke.run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(workload):
    _, cfg, mix = smoke.cell(workload)
    fam = harness.family(cfg["family"])
    st = harness.setup(cfg, mix, 7, "cpu", lambda: None)
    ref = harness.reference_digests(fam, cfg, mix, 7, st.batches, "cpu")
    fp8 = harness.reference_digests(fam, cfg, mix, 7, st.batches, "cpu",
                                    "fp8")
    checks = judge.compare(judge.readings(fp8, ref), judge.limits(workload))
    assert not all(c["ok"] for c in checks.values()), checks


def _unchanged(mts):
    def make(model, lr=0.01):
        ts = mts(model, lr)

        def step(params, batch, info=None):
            return params, ts(params, batch, info)[1]
        return step
    return make


def _half_batch(mts):
    def make(model, lr=0.01):
        ts = mts(model, lr)

        def step(params, batch, info=None):
            n = batch["tokens"].shape[0] // 2
            return ts(params, {k: v[:n] for k, v in batch.items()}, info)
        return step
    return make


def _no_exchange(xs):
    return lambda stack, *a, **kw: stack


PLANTED = {"unchanged": ("make_train_step", _unchanged),
           "half_batch": ("make_train_step", _half_batch),
           "no_exchange": ("exchange_stacked", _no_exchange)}


@pytest.mark.parametrize("fault", sorted(PLANTED))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    from repro_torch.core import exchange
    attr, wrap = PLANTED[fault]
    monkeypatch.setattr(exchange, attr, wrap(getattr(exchange, attr)))
    res = smoke.run(workload)
    assert not res["correct"], res["checks"]


def test_every_reference_fault_is_planted_in_the_program():
    assert set(FAULTS) <= set(PLANTED)


@pytest.mark.parametrize("fault", ("wkv6_dk_half", "wkv6_decay_squared"))
def test_a_wrong_wkv6_backward_is_not_correct(fault):
    with faults.planted(fault):
        res = smoke.run("pod_mean.rwkv6-1.6b")
    assert not res["correct"], res["checks"]


def test_a_planted_fault_is_removed_on_exit():
    from repro_torch.kernels import rwkv6
    before = (rwkv6.backward, rwkv6.wkv6, rwkv6.ref.wkv6_backward_naive)
    with faults.planted("wkv6_dk_half"):
        assert rwkv6.backward is not before[0]
    assert (rwkv6.backward, rwkv6.wkv6,
            rwkv6.ref.wkv6_backward_naive) == before


@pytest.mark.parametrize("lims, ok", [
    ({"grad": 0.1, "loss": None}, True),     # loss read, not compared
    ({"grad": 0.1}, False),                  # loss read, no limit named
    ({"grad": 0.1, "loss": None, "q8": 1.0}, False),   # q8 not read
    ({"grad": 0.01, "loss": None}, False)])
def test_limits_compare_what_they_name(lims, ok):
    checks = judge.compare({"grad": 0.05, "loss": 3.0}, lims)
    assert all(c["ok"] for c in checks.values()) == ok, checks
