"""Chameleon-34B: early-fusion mixed-modal decoder LM with VQ image tokens.

[arXiv:2405.09818; unverified] 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536. Chameleon uses qk-norm for training stability; images enter as
discrete VQ tokens sharing the text vocabulary, so the modality frontend is a
token stub (``input_specs`` feeds token ids; the VQ-GAN tokenizer is out of
scope per the assignment).
"""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    mlp_act="silu",
    gated_mlp=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    frontend="vq_tokens",
    fsdp=True,  # 34B params
    source="arXiv:2405.09818",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, fsdp=False,
    )
