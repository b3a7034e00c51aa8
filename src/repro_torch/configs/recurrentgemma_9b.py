"""RecurrentGemma-9B (Griffin): RG-LRU recurrence + local attention, 2:1.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (kv=1, MQA) d_ff=12288
vocab=256000. Block pattern (rec, rec, attn) repeating; local attention
window 2048 => bounded decode state => long_500k runs natively.
head_dim=256 (gemma-style MQA attention blocks).
"""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attn_window=2048,  # local attention
    mlp_act="gelu",
    gated_mlp=True,
    block_pattern=("rec", "rec", "attn"),
    tie_embeddings=True,
    fsdp=True,  # 9B + 256k vocab
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, attn_window=32, fsdp=False,
    )
