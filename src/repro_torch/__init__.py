"""repro_torch — the PyTorch/CUDA port of the UnifyFL reproduction.

It mirrors ``repro``'s module names so each counterpart is easy to find, and
holds the same numbers as the JAX package on the same inputs. Parameters are
nested dicts of tensors with the reference's names and layout; every kernel
that ``repro`` writes in Pallas is a hand-written CUDA kernel for Hopper
(``kernels/csrc``), with a plain PyTorch version beside it. Entry points run
on the CUDA device unless the caller passes ``device="cpu"``.
"""
