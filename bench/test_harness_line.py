"""The result line's schema, from small runs on the CPU; and a run that
finds no card fails and prints no result."""
import json
import math
import os
import subprocess
import sys

import torch

from bench import harness, smoke

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
W = "pod_topk_int8.qwen3-1.7b"


def _finite_json(obj):
    return json.loads(json.dumps(obj, allow_nan=False))


def test_untraced_line():
    res = smoke.run(W)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert "breakdown" not in res
    dev = res["device"]
    assert set(dev) == {"platform", "kind", "count", "memory_peak_bytes"}
    # on the CPU no device metric is written: no peak, no utilisation
    names = {m["name"] for m in harness.end_to_end(W)}
    assert set(res["metrics"]) <= names
    assert set(res["metrics"]) == {"setup_s", "train_tokens_per_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    _finite_json({k: v for k, v in res.items() if k != "checks"})


def test_traced_line_holds_only_per_layer_metrics():
    res = smoke.run(W, trace=True)
    names = {m["name"] for m in harness.per_layer(W)}
    assert set(res["metrics"]) <= names
    # spans are read on any device; the device trace only on a card
    assert {"train_ms", "exchange_ms"} <= set(res["metrics"])
    assert res["correct"], res["checks"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", W, "--seed",
         "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
