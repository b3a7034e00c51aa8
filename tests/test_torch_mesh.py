"""``repro_torch.launch.mesh.make_production_mesh`` on a fake process group:
the reference's axis names and sizes, and the refusals."""
import math

import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.launch.mesh import make_production_mesh


@pytest.fixture
def fake_group():
    """A fake default process group of ``world`` ranks, destroyed after the
    test (pytest-xdist reuses its workers)."""
    def init(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,shape,names,sizes", [
    (False, None, ("data", "model"), (16, 16)),
    (True, None, ("pod", "data", "model"), (2, 16, 16)),
    (False, (2, 4), ("data", "model"), (2, 4)),
    (True, (2, 1, 1), ("pod", "data", "model"), (2, 1, 1)),
])
@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_production_mesh_names_and_sizes(fake_group, multi_pod, shape, names,
                                         sizes, device_type):
    """The layout is the reference's (``repro/launch/mesh.py``); a
    ``cuda`` mesh builds on a fake group without a card."""
    fake_group(math.prod(sizes))
    mesh = make_production_mesh(multi_pod=multi_pod, shape=shape,
                                device_type=device_type)
    assert mesh.mesh_dim_names == names
    assert tuple(mesh.shape) == sizes
    assert mesh.device_type == device_type


@pytest.mark.parametrize("multi_pod,world", [(False, 512), (True, 256),
                                             (True, 1024), (False, 255)])
def test_production_mesh_refuses_a_wrong_world_size(fake_group, multi_pod,
                                                    world):
    fake_group(world)
    with pytest.raises(ValueError, match="ranks, the process group has"):
        make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_production_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no default process group"):
        make_production_mesh(device_type="cpu")


def test_production_mesh_refuses_a_shape_of_the_wrong_rank(fake_group):
    fake_group(8)
    with pytest.raises(ValueError, match="does not fit the axes"):
        make_production_mesh(multi_pod=True, shape=(2, 4), device_type="cpu")
