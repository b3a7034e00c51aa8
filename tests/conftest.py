# NOTE: deliberately no XLA_FLAGS here — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py forces 512 host devices.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (subprocess / multi-device)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where none is visible")
