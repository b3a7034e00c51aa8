"""Gemma-2B: dense decoder LM with MQA and GeGLU.

[arXiv:2403.08295; hf] 18L d_model=2048 8H (kv=1, MQA) d_ff=16384 vocab=256000,
head_dim=256, GeGLU activation, tied embeddings, embedding scaled by sqrt(d).
"""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="gelu",
    gated_mlp=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="arXiv:2403.08295",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256,
    )
