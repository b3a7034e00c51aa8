"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain versions.

ref        -- plain PyTorch versions of every kernel (the CPU path and the
              oracle the CUDA kernels are held against)
wsum, quant, q8agg -- one wrapper per kernel: launches the CUDA kernel on a
              CUDA tensor, runs the plain version on a CPU tensor
_build     -- compiles csrc/ into one shared library at first use
ops        -- the public padding / flatten layer over the wrappers
"""
