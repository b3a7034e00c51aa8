"""Mixtral-8x7B: 8-expert top-2 MoE decoder LM with sliding-window attention.

[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 (per expert)
vocab=32000, MoE 8 experts top-2, SWA window 4096. With 8 experts < 16 model
shards the baseline shards each expert's ff dim (TP); EPxTP is a hillclimb
candidate (EXPERIMENTS.md §Perf).
"""
from repro_torch.config import MoEConfig, ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attn_window=4096,  # SWA => sub-quadratic decode => long_500k runs
    mlp_act="silu",
    gated_mlp=True,
    rope_theta=1e6,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25, sharding="tp"),
    fsdp=True,  # 47B total params
    source="arXiv:2401.04088",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, attn_window=32, fsdp=False,
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.5, sharding="tp"),
    )
