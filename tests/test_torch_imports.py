"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package, and the entry point runs on
the GPU unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

GUARD = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib") or name == "repro" \\
                    or name.startswith("repro."):
                raise ImportError(f"port imported {name!r}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, "src")
    sys.path.insert(0, ".")
    import repro_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for name in names:
        importlib.import_module(name)
    importlib.import_module("chip_smoke")
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not leaked, leaked
    print(len(names))
""")


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30      # every module was imported


def test_chip_smoke_names_no_jax_import():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    roots = {m.split(".")[0] for m in mods}
    assert not roots & {"jax", "jaxlib", "repro"}, mods
    assert "repro_torch" in roots


def test_entry_point_defaults_to_the_gpu():
    """``device=None`` means the CUDA device: with no card it raises rather
    than carrying on on the CPU; with one, params land on it."""
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    fed = FedConfig(n_silos=3, clients_per_silo=1, rounds=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_image_experiment(get_config("paper-cnn"), fed, n_train=60,
                                   n_test=30)
        return
    orch = build_image_experiment(get_config("paper-cnn"), fed, n_train=60,
                                  n_test=30)
    assert orch.silos[0].cluster.params["fc1"]["w"].is_cuda
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("kw,match", [
    (dict(mode="async"), "AsyncOrchestrator"),
    (dict(scorer="multikrum"), "scoring"),
    (dict(edge_per_silo=2), "edge"),
    (dict(compression="int8-delta"), None),
])
def test_later_slices_raise(kw, match):
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    fed = FedConfig(n_silos=3, clients_per_silo=1, rounds=1, **kw)
    if match is None:   # int8-delta builds; its first encode raises
        orch = build_image_experiment(get_config("paper-cnn"), fed,
                                      n_train=60, n_test=30, device="cpu")
        with pytest.raises(NotImplementedError, match="add_q8_delta"):
            orch.run(1)
        return
    with pytest.raises(NotImplementedError, match=match):
        build_image_experiment(get_config("paper-cnn"), fed, n_train=60,
                               n_test=30, device="cpu")
