"""Qwen3-1.7B: dense decoder LM with qk-norm and GQA.

[hf:Qwen/Qwen3-8B (family config); hf] 28L d_model=2048 16H (GQA kv=8)
d_ff=6144 vocab=151936, head_dim=128, RMSNorm on q/k per head.
"""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    mlp_act="silu",
    gated_mlp=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
