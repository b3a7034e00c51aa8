"""Nothing the benchmark runs loads JAX, Flax or the JAX package ``repro``
(top-level module names compared whole: ``repro_torch`` is the port and
is allowed), and the plain references load nothing of the port."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

GUARD = textwrap.dedent("""
    import sys

    class Refuse:
        def __init__(self, names):
            self.names = names

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in self.names:
                raise ImportError(f"loaded {name!r}")
            return None

    sys.meta_path.insert(0, Refuse(set(sys.argv[1].split(","))))
    sys.path.insert(0, ".")
""")

RUN = GUARD + textwrap.dedent("""
    import torch
    torch.set_num_threads(1)
    import bench.control, bench.run
    from bench import harness, smoke
    spec = harness.spec()
    for m in spec["per_layer"]:
        harness.reader(m["name"])
    for w in spec["workloads"]:
        res = smoke.run(w["name"], trace=True)
        assert res["checks"], res
    bad = harness.forbidden_modules()
    assert not bad, bad
    assert "repro_torch.core.exchange" in sys.modules
    print("ok")
""")

REFERENCE = GUARD + textwrap.dedent("""
    import torch
    from bench.reference import dense, exchange, numerics, round, ssm
    from bench import smoke, weights
    for w in ("pod_topk_int8.qwen3-1.7b", "pod_mean.rwkv6-1.6b"):
        _, cfg, mix = smoke.cell(w)
        fam = dense if cfg["family"] == "dense" else ssm
        pods = [weights.make(fam.param_specs(cfg), 3, "cpu")] * mix["pods"]
        x = torch.randint(0, cfg["vocab_size"], (mix["pods"], 2, 33))
        batch = {"tokens": x[..., :-1], "targets": x[..., 1:]}
        round.round_step(pods, batch, fam, cfg, mix, cfg["lr"],
                         numerics.Numerics())
    leaked = [m for m in sys.modules if m.split(".")[0] == "repro_torch"]
    assert not leaked, leaked
    print("ok")
""")


def _run(code, refuse):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, refuse], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", out.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    _run(RUN, "jax,jaxlib,flax,repro")


def test_the_references_load_nothing_of_the_port():
    _run(REFERENCE, "jax,jaxlib,flax,repro,repro_torch")


def test_the_references_name_nothing_of_the_port():
    for f in sorted((ROOT / "bench" / "reference").glob("*.py")):
        mods = set()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mods.add(node.module or "")
        roots = {m.split(".")[0] for m in mods}
        assert roots <= {"__future__", "math", "torch", "bench"}, (f, roots)
        assert all(m.startswith("bench.reference") for m in mods
                   if m.startswith("bench")), (f, mods)
