"""OLMoE-1B-7B: 64-expert top-8 MoE decoder LM.

[arXiv:2409.02060; hf] 16L d_model=2048 16H (kv=16) d_ff=1024 (per expert)
vocab=50304, MoE 64 experts top-8. qk-norm per the HF config. Experts are
sharded over the model axis (EP) with sort-based dispatch.
"""
from repro_torch.config import MoEConfig, ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    mlp_act="silu",
    gated_mlp=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=8, capacity_factor=1.25, sharding="ep"),
    source="arXiv:2409.02060",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.5, sharding="ep"),
    )
