"""Batched serving example on the PyTorch/CUDA port: prefill + greedy
decode with the recurrent state (``rwkv6-1.6b``, the default) or the KV
cache of a dense decoder (``qwen3-1.7b``, ``gemma-2b``, ...) — the torch
twin of examples/serve_model.py. Runs on the GPU by default; pass
``--device cpu`` for the CPU.

  PYTHONPATH=src python examples/serve_model_torch.py [ARCH] [--device cpu]
"""
import sys

sys.path.insert(0, "src")

from repro_torch.launch.serve import main

args = sys.argv[1:]
arch = args.pop(0) if args and not args[0].startswith("--") else "rwkv6-1.6b"
main(["--arch", arch, "--preset", "smoke", "--batch", "4",
      "--prompt-len", "64", "--gen", "24", *args])
