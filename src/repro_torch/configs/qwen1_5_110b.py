"""Qwen1.5-110B: large dense decoder LM with QKV bias.

[hf:Qwen/Qwen1.5-0.5B (family config, scaled per assignment); hf]
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
110B params => FSDP over the data axis is mandatory.
"""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    mlp_act="silu",
    gated_mlp=True,
    rope_theta=1e6,
    tie_embeddings=False,
    fsdp=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, fsdp=False,
    )
