"""``repro_torch.launch.opstats``: FLOPs of mm, bmm, einsum and a
convolution by their shapes; an op on DTensors counted once, as its local
op (``FlopCounterMode`` counts the global op too); collective bytes by
kind, axis and factor; a kernel's fake op by its own formula."""
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.kernels import rwkv6, wsum
from repro_torch.launch import opstats

torch.set_num_threads(1)


@pytest.fixture
def mesh():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


def _count(fn, axes=None):
    with opstats.OpCounter(axes) as c:
        fn()
    return c.stats


@pytest.mark.parametrize("name,fn,flops", [
    ("mm", lambda: torch.randn(8, 16) @ torch.randn(16, 32), 2 * 8 * 16 * 32),
    ("bmm", lambda: torch.bmm(torch.randn(3, 8, 16), torch.randn(3, 16, 4)),
     2 * 3 * 8 * 16 * 4),
    ("einsum", lambda: torch.einsum("bsd,df->bsf", torch.randn(2, 5, 16),
                                    torch.randn(16, 8)), 2 * 10 * 16 * 8),
    ("conv", lambda: F.conv2d(torch.randn(1, 3, 8, 8),
                              torch.randn(4, 3, 3, 3)),
     2 * 4 * 6 * 6 * 3 * 3 * 3),
])
def test_product_flops(name, fn, flops):
    st = _count(fn)
    assert st.flops == flops
    assert st.traffic_bytes > 0


def test_dtensor_product_counted_once(mesh):
    """[64, 128] @ [128, 256] sharded rows x columns on (2, 2): a rank's
    local product only (global 4,194,304 FLOPs / 4), under fake tensors,
    also on the propagation's first (uncached) call."""
    with FakeTensorMode():
        a = distribute_tensor(torch.randn(64, 128), mesh,
                              [Shard(0), Replicate()])
        b = distribute_tensor(torch.randn(128, 256), mesh,
                              [Replicate(), Shard(1)])
        st = _count(lambda: a @ b)
    assert st.flops == 2 * 32 * 128 * 128 == 2 * 64 * 128 * 256 / 4


def test_collectives_by_kind_axis_and_factor(mesh):
    axes = opstats.group_axes(mesh)
    with FakeTensorMode():
        x = distribute_tensor(torch.randn(64, 128), mesh,
                              [Shard(0), Shard(1)])

        def run():
            x.redistribute(mesh, [Replicate(), Replicate()])
            y = x.to_local()
            dist.all_reduce(y, group=mesh.get_group("data"))
        st = _count(run, axes)
    by = {(c["kind"], c["axis"]): c for c in st.to_dict()[
        "collectives_by_axis"]}
    local = 32 * 64 * 4
    # the model axis gathers [32, 64] -> [32, 128], then data -> [64, 128]
    assert by["all-gather", "model"]["bytes"] == 2 * local
    assert by["all-gather", "data"]["bytes"] == 4 * local
    assert by["all-reduce", "data"]["bytes"] == local
    assert by["all-reduce", "data"]["cost_bytes"] == 2 * local
    assert by["all-gather", "data"]["ranks"] == [0, 2]
    assert st.collective_cost_bytes == 2 * local + 4 * local + 2 * local
    assert st.collective_count == 3
    assert opstats.nodes_spanned([0, 2]) == 1
    assert opstats.nodes_spanned(list(range(0, 256, 16))) == 16


def test_kernel_fake_ops_use_their_formulas():
    with FakeTensorMode():
        x, w = torch.empty(3, 1000), torch.empty(3)
        st = _count(lambda: wsum.weighted_sum(x, w))
        assert st.flops == st.kernel_flops == 2 * 3 * 1000
        assert st.traffic_bytes == 4 * 1000 * 4
        B, T, H, hs = 2, 64, 4, 16
        r = torch.empty(B, T, H, hs)
        u, s = torch.empty(H, hs), torch.empty(B, H, hs, hs)
        st = _count(lambda: rwkv6.wkv6(r, r, r, r, u, s))
    f, b = rwkv6.forward_cost(B, T, H, hs, 4)
    assert st.flops == f == (5 * hs + 5) * B * T * H * hs
    # f32 r, k, v, y (4 x 4 bytes) and w (4) an element, two f32 states
    assert st.traffic_bytes == b == 20 * B * T * H * hs + 2 * B * H * hs * hs * 4
