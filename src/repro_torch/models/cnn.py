"""The paper's edge workload: LeNet-style CNN (~62K params) for CIFAR-10.

conv(3->6,5x5) -> maxpool -> conv(6->16,5x5) -> maxpool -> fc120 -> fc84 -> fc10

Twin of ``repro.models.cnn`` with its layout at every public function:
images are NHWC and conv weights HWIO. The convolutions permute to
NCHW / OIHW around ``F.conv2d`` and back, and ``fc1`` reads the NHWC
flatten, so the reference's params load leaf for leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


def init_params(generator: torch.Generator, cfg: ModelConfig, device):
    c1, c2 = 6, cfg.d_model  # 16 by default
    fc1, fc2 = cfg.d_ff, 84  # 120, 84
    flat = c2 * 5 * 5
    pd = L.dtype_of(cfg.param_dtype)

    def dense(shape, fan_in):
        return L.dense_init(generator, shape, fan_in, pd, device)

    def zeros(n):
        return torch.zeros((n,), dtype=pd, device=device)

    return {
        "conv1": {"w": dense((5, 5, 3, c1), 75), "b": zeros(c1)},
        "conv2": {"w": dense((5, 5, c1, c2), 25 * c1), "b": zeros(c2)},
        "fc1": {"w": dense((flat, fc1), flat), "b": zeros(fc1)},
        "fc2": {"w": dense((fc1, fc2), fc1), "b": zeros(fc2)},
        "out": {"w": dense((fc2, cfg.vocab_size), fc2),
                "b": zeros(cfg.vocab_size)},
    }


def _conv_pool(x, p):
    """NCHW activations, HWIO weight -> relu(conv) then 2x2 max-pool."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)          # HWIO -> OIHW
    y = F.conv2d(x, w, p["b"].to(x.dtype))
    return F.max_pool2d(F.relu(y), 2, 2)


def forward(params, images, cfg: ModelConfig):
    """images: [B, 32, 32, 3] float -> logits [B, n_classes]."""
    x = images.to(L.dtype_of(cfg.compute_dtype)).permute(0, 3, 1, 2)
    x = _conv_pool(x, params["conv1"])
    x = _conv_pool(x, params["conv2"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
    for name in ("fc1", "fc2"):
        p = params[name]
        x = F.relu(x @ p["w"].to(x.dtype) + p["b"].to(x.dtype))
    p = params["out"]
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def loss_fn(params, batch, cfg: ModelConfig):
    logits = forward(params, batch["image"], cfg).to(torch.float32)
    labels = batch["label"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, {"loss": loss, "ce": loss, "accuracy": acc,
                  "aux": torch.zeros((), device=logits.device)}


def param_rules(cfg: ModelConfig):
    return [(r".*", (None, None, None, None))]
