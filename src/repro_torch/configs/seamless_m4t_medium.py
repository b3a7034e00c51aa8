"""SeamlessM4T-medium: encoder-decoder multimodal translation backbone.

[arXiv:2308.11596; hf] 12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
We instantiate the text/unit transformer backbone: 12 encoder + 12 decoder
layers (the assignment specifies the backbone only). The speech frontend
(w2v-BERT conformer feature extractor) is a STUB: ``input_specs`` provides
precomputed frame embeddings of shape (batch, frames, d_model).
"""
from repro_torch.config import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="encdec",
    n_layers=12,           # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp_act="gelu",
    gated_mlp=False,
    tie_embeddings=True,
    frontend="audio_frames",
    frontend_dim=1024,
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, frontend_dim=64,
    )
