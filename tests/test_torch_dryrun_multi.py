"""The port's multi-pod dry-run cell on the CPU. The reference aborts
compiling every multi-pod cell there (an XLA check in its SPMD
partitioner), so ``qwen3-1.7b`` ``train_4k`` on the (2, 2, 4) mesh runs in
the port alone: its argument bytes are held to the sum of the shard
shapes the reference's ``input_specs`` gives its leaves there.
"""
import math

import jax
import numpy as np
import torch
from jax.sharding import AbstractMesh

from repro.launch import specs as jspecs
from repro_torch.launch import dryrun

torch.set_num_threads(1)


def test_multi_pod_cell_argument_bytes():
    """The (2, 2, 4) train cell: argument bytes equal the reference's
    shard shapes summed, a ``pod`` all-gather and the merge's
    ``weighted_sum`` counted."""
    shape = (2, 2, 4)
    names = ("pod", "data", "model")
    ref = jspecs.input_specs("qwen3-1.7b", "train_4k", multi_pod=True,
                             mesh=AbstractMesh(shape, names))
    leaves = jax.tree_util.tree_leaves(
        [ref["kwargs"]["params"], ref["kwargs"]["batch"]])
    shards = jax.tree_util.tree_leaves(list(ref["in_shardings"]))
    size = dict(zip(names, shape))
    want = 0
    for leaf, sh in zip(leaves, shards):
        n = math.prod(leaf.shape)
        for ax in sh.spec:
            for a in (() if ax is None else
                      (ax if isinstance(ax, tuple) else (ax,))):
                n //= size[a]
        want += n * np.dtype(leaf.dtype).itemsize
    got = dryrun.run_cell("qwen3-1.7b", "train_4k", True, mesh_shape=shape,
                          device="cpu", verbose=False)
    assert got["memory_analysis"]["argument_bytes"] == want
    assert got["mesh"] == "multi_pod_2x2x4" and got["policy"] == "top_k"
    axes = {(c["kind"], c["axis"]) for c in got["hlo"]["collectives_by_axis"]}
    assert ("all-gather", "pod") in axes
    assert got["hlo"]["flops_by_op"]["repro_torch::weighted_sum"] > 0
    assert got["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
