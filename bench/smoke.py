"""Small sizes of the benchmark's cells, for its CPU tests: each
configuration at the port's smoke widths (2 layers, d_model 64,
vocabulary 256) in float32, and each mix at 32 tokens a row. A cell's
own limits hold these to its full-size check: in float32 the program and
the reference agree to rounding."""
from __future__ import annotations

from bench import harness

WIDTHS = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256, padded_vocab=2048),
    "ssm": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                rwkv_head_size=16, d_ff=128, vocab_size=256,
                padded_vocab=2048),
}


def cell(workload: str, dtype: str = "float32"):
    """(workload entry, small configuration, small mix) of ``workload``."""
    w, cfg, mix = harness.cell(workload)
    cfg = {**cfg, **WIDTHS[cfg["family"]], "param_dtype": dtype,
           "compute_dtype": dtype}
    return w, cfg, {**mix, "seq_len": 32, "profiled_steps": 1}


def run(workload: str, seed: int = 123456789012, trace: bool = False,
        dtype: str = "float32", **kw) -> dict:
    """One run of the small cell on the CPU, the window 0.2 s."""
    _, cfg, mix = cell(workload, dtype)
    return harness.run(workload, seed, 0.2, trace, device="cpu", cfg=cfg,
                       mix=mix, **kw)
