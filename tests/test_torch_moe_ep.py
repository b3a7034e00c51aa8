"""The MoE's ``model``-axis branches (``models/moe.py``) against the
reference's, at the float32 ``olmoe-1b-7b`` smoke preset (4 experts, top
2) on shared numpy inputs:

- each EP shard body (``_moe_shard``) against the reference's
  ``_moe_local_offset`` on the same expert block, at 2 and 4 shards: the
  routing, the block's capacity slots and token buffer exactly, the
  partial output within BODY_REL (XLA's and ATen's float32 products round
  differently; the combine itself is bit for bit, ``test_torch_moe``);
  their sum in shard order against the one-device branch within SUM_REL
  (the partials are summed in another order);
- the port's ``moe_block`` on DTensors over 4 gloo ranks, a (2, 2)
  ``data`` x ``model`` mesh (EP, 2 experts a shard; and 'tp', the ff dim
  sharded), against the reference's ``moe_block`` jitted under a
  4-device mesh in a subprocess (``XLA_FLAGS`` set before jax loads)
  within MESH_REL.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jsmoke
from repro.models import moe as jmoe
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SUM_REL = 1e-6
BODY_REL = 1e-6
MESH_REL = 1e-5
B, S = 4, 8
SHARDINGS = ("ep", "tp")


def cfgs(sharding="ep"):
    from dataclasses import replace as dreplace
    t = replace(get_smoke_config("olmoe-1b-7b"), param_dtype="float32",
                compute_dtype="float32")
    j = jreplace(jsmoke("olmoe-1b-7b"), param_dtype="float32",
                 compute_dtype="float32")
    return (dreplace(t, moe=dreplace(t.moe, sharding=sharding)),
            dreplace(j, moe=dreplace(j.moe, sharding=sharding)))


def inputs():
    """numpy weights and tokens [B, S, D], seeded."""
    cfg = cfgs()[0]
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(7)
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "wi": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("n_shards", (2, 4))
def test_shard_bodies_equal_the_reference(n_shards):
    tcfg, jcfg = cfgs()
    p, x = inputs()
    x2 = x.reshape(-1, x.shape[-1])
    e_per = tcfg.moe.n_experts // n_shards
    total = None
    for mi in range(n_shards):
        blk = slice(mi * e_per, (mi + 1) * e_per)
        local = {k: (v if k == "router" else v[blk]) for k, v in p.items()}
        want, want_aux = jmoe._moe_local_offset(
            {k: jnp.asarray(v) for k, v in local.items()}, jnp.asarray(x2),
            jcfg, e_per, mi)
        tl = {k: torch.from_numpy(v) for k, v in local.items()}
        got, aux = moe._moe_shard(tl, torch.from_numpy(x2), tcfg,
                                  mi * e_per, e_per)
        # routing and this block's dispatch, exactly
        C = moe._capacity(x2.shape[0], tcfg)
        jp, ji, _ = jmoe._route(jnp.asarray(p["router"]), jnp.asarray(x2),
                                jcfg)
        jb, js = jmoe._dispatch_indices(ji, tcfg.moe.n_experts, C)
        tp, ti, _, tb, ts = moe.route_and_dispatch(tl["router"],
                                                   torch.from_numpy(x2), tcfg)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tb[blk].numpy(), np.asarray(jb)[blk])
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        want = np.asarray(want)
        gap = float(np.abs(got.numpy() - want).max())
        assert gap <= BODY_REL * float(np.abs(want).max()), (mi, gap)
        assert abs(float(aux) - float(want_aux)) <= \
            BODY_REL * abs(float(want_aux))
        total = got if total is None else total + got
    full, _ = moe._moe_local({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x2), tcfg)
    gap = float((total - full).abs().max())
    assert gap <= SUM_REL * float(full.abs().max())


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, "tests")
    import test_torch_moe_ep as T
    from repro import pshard
    from repro.models import moe
    out_dir = sys.argv[1]
    p, x = T.inputs()
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    for sharding in T.SHARDINGS:
        cfg = T.cfgs(sharding)[1]
        with pshard.use_mesh(mesh):
            out, aux = jax.jit(lambda p, x: moe.moe_block(p, x, cfg))(
                {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        np.save(f"{out_dir}/ref_{sharding}.npy", np.asarray(out))
        np.save(f"{out_dir}/ref_{sharding}_aux.npy", np.asarray(aux))
""")

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, "tests")
    import test_torch_moe_ep as T
    from repro_torch import pshard
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe

    rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
        pshard.set_batch_axes(("pod", "data"))
        p, x = T.inputs()
        for sharding in T.SHARDINGS:
            cfg = T.cfgs(sharding)[0]
            with pshard.use_mesh(mesh):
                xd = pshard.place(torch.from_numpy(x), mesh, pshard.BATCH,
                                  None, None)
                with pshard.dtensor_context([xd]):
                    out, aux = moe.moe_block(
                        {k: torch.from_numpy(v) for k, v in p.items()}, xd,
                        cfg)
            out, aux = out.full_tensor(), aux.full_tensor()   # every rank
            if rank == 0:
                np.save(f"{out_dir}/port_{sharding}.npy", out.numpy())
                np.save(f"{out_dir}/port_{sharding}_aux.npy", aux.numpy())
    finally:
        dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """The reference's subprocess and the port's 4 gloo ranks, started
    together."""
    out = tmp_path_factory.mktemp("moe_ep")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                                str(out)], cwd=ROOT, env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for r in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    return out


@pytest.mark.parametrize("sharding", SHARDINGS)
def test_four_ranks_match_the_reference_mesh(outputs, sharding):
    want = np.load(outputs / f"ref_{sharding}.npy")
    got = np.load(outputs / f"port_{sharding}.npy")
    assert got.shape == want.shape == (B, S, cfgs()[0].d_model)
    assert float(np.abs(got - want).max()) <= \
        MESH_REL * float(np.abs(want).max())
    aux_w = np.load(outputs / f"ref_{sharding}_aux.npy")
    aux = np.load(outputs / f"port_{sharding}_aux.npy")
    assert abs(float(aux) - float(aux_w)) <= MESH_REL * abs(float(aux_w))
