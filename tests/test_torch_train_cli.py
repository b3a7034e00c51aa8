"""``python -m repro_torch.launch.train``: the reference CLI's flags plus
``--device``, both workloads on the CPU, and the card by default."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.train import main
from test_torch_lm_fed import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _flags(module):
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(re.findall(r"--[a-z][a-z-]*", out.stdout))


def test_flags_are_the_references_plus_device():
    ref = _flags("repro.launch.train")
    port = _flags("repro_torch.launch.train")
    assert "--workload" in ref and "--compression" in ref
    assert port - ref == {"--device"} and ref <= port


def test_lm_workload_runs_on_the_cpu(capsys):
    ge = main(["--workload", "lm", "--arch", "qwen3-1.7b", "--rounds", "1",
               "--clients", "1", "--scorer", "loss", "--policy", "top_k",
               "--compression", "int8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "workload=lm arch=qwen3-1.7b mode=sync silos=3x1" in out
    assert "verify=True" in out
    assert sorted(ge) == ["silo0", "silo1", "silo2"]
    for m in ge.values():
        assert np.isfinite(m["loss"])
        assert m["accuracy"] == pytest.approx(np.exp(-m["loss"]), rel=1e-6)


def test_image_workload_runs_on_the_cpu(capsys, tmp_path):
    out_path = tmp_path / "run.json"
    ge = main(["--workload", "image", "--rounds", "1", "--device", "cpu",
               "--out", str(out_path)])
    assert "workload=image arch=paper-cnn" in capsys.readouterr().out
    assert all(0.0 <= m["accuracy"] <= 1.0 for m in ge.values())
    assert out_path.exists()


def test_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--workload", "lm", "--arch", "qwen3-1.7b", "--rounds", "1"])
