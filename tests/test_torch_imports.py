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
    for must in ("repro_torch.net", "repro_torch.net.fabric",
                 "repro_torch.net.gossip", "repro_torch.net.prefetch",
                 "repro_torch.net.faults", "repro_torch.chain.sync",
                 "repro_torch.obs.report", "repro_torch.chain.light",
                 "repro_torch.edge.devices", "repro_torch.edge.fleet",
                 "repro_torch.fed.hbfl", "repro_torch.models.transformer"):
        assert must in names, must
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


def test_async_and_fabric_default_to_the_gpu():
    """Async over a fabric with faults builds on the CUDA device by
    default: with no card it raises before anything runs on the CPU."""
    from repro_torch.config import FaultScenario, FedConfig, NetConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    from repro_torch.core.orchestrator import AsyncOrchestrator
    fed = FedConfig(n_silos=3, clients_per_silo=1, rounds=1, mode="async",
                    compression="int8-delta",
                    net=NetConfig(preset="wan-heterogeneous", scenarios=(
                        FaultScenario(action="kill", node="silo1",
                                      round=1),)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_image_experiment(get_config("paper-cnn"), fed, n_train=60,
                                   n_test=30)
        return
    orch = build_image_experiment(get_config("paper-cnn"), fed, n_train=60,
                                  n_test=30)
    assert isinstance(orch, AsyncOrchestrator)
    assert all(s.store.device.type == "cuda" for s in orch.silos)


@pytest.mark.parametrize("kw,match", [
    (dict(mode="async"), None),
    (dict(net="wan-uniform"), None),
    (dict(edge_per_silo=2), None),
    (dict(scorer="multikrum", compression="int8-delta"), None),
    (dict(arch="olmoe-1b-7b"), None),
])
def test_later_slices_raise(kw, match):
    """Every slice named here is ported: Async, the net fabric, the edge
    tier and MultiKRUM over int8-delta build and run 2 rounds, and the
    ``moe`` family (the last LM family to be ported with ``hybrid`` and
    ``encdec``) builds at full width."""
    from repro_torch.config import FedConfig, NetConfig
    from repro_torch.configs import get_config
    from repro_torch.core.builder import build_image_experiment
    if "arch" in kw:    # an LM family: the model API builds it
        from repro_torch.models import build_model
        model = build_model(get_config(kw["arch"]))
        assert (model.kind, model.cfg.family) == ("decoder", "moe")
        return
    cfg = get_config("paper-cnn")
    if "net" in kw:
        kw = dict(net=NetConfig(preset=kw["net"]))
    fed = FedConfig(n_silos=3, clients_per_silo=1, rounds=1, **kw)
    if match is None:   # ported by now: builds and runs
        orch = build_image_experiment(cfg, fed, n_train=60, n_test=30,
                                      device="cpu")
        orch.run(2)
        assert orch.ledger.verify()
        assert all(s.rounds_done == 2 for s in orch.silos)
        if fed.net is not None:
            orch.env.run()
            assert orch.chain.converged()
            assert orch.fabric.stats["chain_bytes"] > 0
        if fed.edge_per_silo:
            assert all(len(s.cluster.edge_fleet.clients) == 2
                       and s.cluster.edge_fleet.stats["rounds"] == 2
                       and all("edge_participants" in m for m in s.metrics)
                       for s in orch.silos)
        return
    with pytest.raises(NotImplementedError, match=match):
        build_image_experiment(cfg, fed, n_train=60, n_test=30, device="cpu")


def test_no_port_message_names_an_old_queue_item():
    """The port's refusals cite ROADMAP.md queue 1 as it is numbered now:
    item 4 the edge tier, item 5 LM training."""
    src = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(src):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    text = f.read()
                assert "item 7" not in text and "item 9" not in text, name
