"""The paper's own edge workload: a ~62K-parameter CNN for CIFAR-10.

[UnifyFL Table 4] Image classification, 10 classes, lr 0.01, 2 local epochs,
batch 5. This is the model the paper trains on the edge cluster; we use it for
the faithful end-to-end reproduction (benchmarks/table1, table6, fig7).
"""
from repro_torch.config import ModelConfig, replace

# The LM fields are repurposed minimally: vocab_size = n_classes, d_model = base
# channel width. models/cnn.py interprets them.
CONFIG = ModelConfig(
    arch_id="paper-cnn",
    family="cnn",
    n_layers=2,          # conv blocks
    d_model=16,          # base channels (6/16 LeNet-style => ~62K params)
    n_heads=1,
    n_kv_heads=1,
    d_ff=120,            # dense head width
    vocab_size=10,       # classes
    gated_mlp=False,
    tie_embeddings=False,
    param_dtype="float32",
    compute_dtype="float32",
    source="UnifyFL Table 4 (LeNet-style CNN, 62K params)",
)


def smoke_config() -> ModelConfig:
    return CONFIG  # already tiny
