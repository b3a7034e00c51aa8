"""The harness is driven by data: it finds a cell's configuration, mix,
reference, limits and per-layer readers by name, and a later change adds
a configuration, a mix and a metric as new files and entries, with no
file that is there edited."""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

from bench import harness, program

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_every_named_file_is_found():
    spec = harness.spec()
    for w in spec["workloads"]:
        _, cfg, mix = harness.cell(w["name"])
        fam = harness.family(cfg["family"])
        assert fam.param_specs(cfg) and callable(fam.loss)
        assert set(harness.judge.limits(w["name"]))
        assert mix["pods"] >= 2
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    files = {c["file"] for c in spec["configs"]}
    assert len(files) == len(spec["configs"])
    for p in spec["paths"]:
        assert (ROOT / p).is_dir()


def test_configurations_are_the_ports_own():
    """Each configuration file holds the port's registered configuration
    of its architecture, field for field (its source aside)."""
    import dataclasses
    program.path()
    from repro_torch.configs import get_config
    for c in harness.spec()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        mine = dataclasses.asdict(program.model_config(cfg))
        theirs = dataclasses.asdict(get_config(cfg["arch_id"]))
        mine.pop("source")
        theirs.pop("source")
        assert mine == theirs, c["name"]
        assert c["source"] == cfg["source"]


ADD = textwrap.dedent("""
    import sys, json
    sys.path.insert(0, ".")
    import torch
    torch.set_num_threads(1)
    from bench import harness, smoke
    res = smoke.run("pod_topk_int8_short.qwen3-1.7b-copy", trace=True)
    print(json.dumps(res["metrics"]))
""")


def test_a_cell_and_a_metric_added_as_new_files(tmp_path):
    """A copy of the benchmark, with a new configuration file, a new mix,
    a new reader and new limits, and entries added to BENCHMARK.json: a
    traced run of the new cell reports the new metric."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    spec = harness.spec()
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "qwen3-1.7b.json").read_text())
    (b / "configs" / "qwen3-1.7b-copy.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "pod_topk_int8.json").read_text())
    (b / "traffic" / "pod_topk_int8_short.json").write_text(
        json.dumps({**mix, "checked_steps": 2}))
    (b / "metrics" / "train_calls.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx.spans['train']) / ctx.window_steps\n")
    lims = json.loads((b / "limits" / "pod_topk_int8.qwen3-1.7b.json")
                      .read_text())
    (b / "limits" / "pod_topk_int8_short.qwen3-1.7b-copy.json").write_text(
        json.dumps(lims))
    spec["configs"].append({**spec["configs"][0], "name": "qwen3-1.7b-copy",
                            "file": "bench/configs/qwen3-1.7b-copy.json"})
    spec["workloads"].append({**spec["workloads"][0],
                              "name": "pod_topk_int8_short.qwen3-1.7b-copy",
                              "config": "qwen3-1.7b-copy",
                              "traffic": "pod_topk_int8_short"})
    spec["per_layer"].append({"name": "train_calls", "unit": "count",
                              "better": "lower", "source": "program_span",
                              "layer": "round step",
                              "moves": "train_tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", ADD], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["train_calls"]["value"] == 2.0     # one a pod a step
    assert "train_ms" in metrics
