"""``repro_torch.optim.make_schedule`` against ``repro.optim.make_schedule``
at every step of 100-step schedules.

Tolerance: 2 float32 ulps of the rate or of ``base_lr``, whichever is
larger (EPS below): ``torch.exp`` and ``torch.cos`` may round the last bit
apart from XLA's, and near the end of the cosine ``1 + cos(pi p)`` keeps
only the ulps of 1, i.e. of ``base_lr``. The constant schedule and every
warm-up and stable step are bit for bit (no transcendental in them).
"""
import numpy as np
import pytest
import torch

from repro.optim import make_schedule as jschedule
from repro_torch.optim import make_schedule as tschedule

EPS = 2 * 2.0 ** -23
BASE_LR = 0.3

CASES = [("constant", {}),
         ("wsd", dict(warmup_steps=10, decay_frac=0.2)),
         ("wsd", {}),
         ("wsd", dict(warmup_steps=30, decay_frac=0.5)),
         ("cosine", dict(warmup_steps=10)),
         ("cosine", {}),
         ("cosine", dict(warmup_steps=99))]


@pytest.mark.parametrize("name,kw", CASES)
def test_schedule_matches_reference_at_every_step(name, kw):
    js = jschedule(name, BASE_LR, 100, **kw)
    ts = tschedule(name, BASE_LR, 100, **kw)
    want = np.array([np.asarray(js(s)) for s in range(100)])
    got = np.array([ts(s).numpy() for s in range(100)])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=EPS, atol=EPS * BASE_LR)
    if name != "cosine":    # warm-up and stable steps: no exp, same bits
        flat = want == want.max()
        warm = np.arange(100) < kw.get("warmup_steps", 0)
        np.testing.assert_array_equal(got[flat | warm], want[flat | warm])


def test_wsd_schedule_shape():
    """The reference's ``tests/test_fed.py`` schedule test, on the port."""
    sched = tschedule("wsd", 1.0, 100, warmup_steps=10, decay_frac=0.2)
    assert float(sched(0)) < 0.2            # warmup
    assert float(sched(50)) == 1.0          # stable
    assert float(sched(99)) < 0.1           # decay
    const = tschedule("constant", 0.01, 100)
    assert float(const(7)) == pytest.approx(0.01)
    assert isinstance(const(7), torch.Tensor)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        tschedule("linear", 0.1, 10)
