"""Batched serving example on the PyTorch/CUDA port, the torch twin of
examples/serve_model.py: prefill + greedy decode at the smoke preset of
any LM family in ``configs/``: RWKV-6 (``rwkv6-1.6b``, the default), the
dense and vlm decoders (``qwen3-1.7b``, ``gemma-2b``, ...), the MoE
decoders (``olmoe-1b-7b``, ``mixtral-8x7b``), the RG-LRU hybrid
(``recurrentgemma-9b``) and the encoder-decoder (``seamless-m4t-medium``,
fed random stub frames). Runs on the GPU by default; pass ``--device cpu``
for the CPU. The published widths are served by ``python -m
repro_torch.launch.serve --arch ARCH --preset full`` on the card.

  PYTHONPATH=src python examples/serve_model_torch.py [ARCH] [--device cpu]
"""
import sys

sys.path.insert(0, "src")

from repro_torch.launch.serve import main

args = sys.argv[1:]
arch = args.pop(0) if args and not args[0].startswith("--") else "rwkv6-1.6b"
main(["--arch", arch, "--preset", "smoke", "--batch", "4",
      "--prompt-len", "64", "--gen", "24", *args])
