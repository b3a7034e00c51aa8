"""MiniCPM-2B: llama-like dense decoder LM trained with the WSD schedule.

[arXiv:2404.06395; hf] 40L d_model=2304 36H (kv=36, MHA) d_ff=5760
vocab=122753 (padded to 124928 physical for sharding/lane alignment; loss is
masked to the logical vocab). The WSD (warmup-stable-decay) LR schedule is a
training-recipe property, implemented in repro/optim/schedules.py.
"""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    mlp_act="silu",
    gated_mlp=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="arXiv:2404.06395",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=72, n_heads=4, n_kv_heads=4, head_dim=18,
        d_ff=128, vocab_size=250,  # odd vocab on purpose: exercises padding
    )
