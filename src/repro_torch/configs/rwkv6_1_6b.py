"""RWKV6-1.6B ("Finch"): attention-free RNN LM with data-dependent decay.

[arXiv:2404.05892; unverified] 24L d_model=2048 d_ff=7168 vocab=65536.
Head size 64 (=> 32 heads). Token-shift + low-rank data-dependent decay (w),
matrix-valued per-head state => O(1) decode state, so long_500k runs natively.
The chunked WKV6 recurrence is a Pallas kernel (kernels/rwkv6.py).
"""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / rwkv_head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_size=64,
    gated_mlp=False,       # rwkv channel-mix is ungated square relu
    tie_embeddings=False,
    source="arXiv:2404.05892",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, rwkv_head_size=16,
        d_ff=128, vocab_size=256,
    )
