"""Production meshes (port of ``repro.launch.mesh``) over a fake world.

Functions, not module-level constants: importing this module touches no
process group. The dry-run tools trace on the host, so their meshes are
``DeviceMesh``es over torch's ``"fake"`` backend, whose collectives move
nothing: ``fake_world(n)`` sets up a world of n ranks with this process as
rank 0, and every mesh is built over the first ranks of the world, so one
512-rank world holds the 16 x 16 mesh, the 2 x 16 x 16 mesh and the
debug mesh at once.

  make_production_mesh()                16 x 16 ("data", "model")
  make_production_mesh(multi_pod=True)  2 x 16 x 16 ("pod", "data", "model")
  make_debug_mesh(2, 2)                 2 x 2 ("data", "model")
"""

from __future__ import annotations

import torch

PRODUCTION_WORLD = 512


def fake_world(world_size: int = PRODUCTION_WORLD) -> None:
    """(Re)initialise the default process group as a ``"fake"`` world of
    ``world_size`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


class fake_world_scope:
    """``fake_world`` for the length of a ``with`` block; the process group
    is destroyed on the way out."""

    def __init__(self, world_size: int = PRODUCTION_WORLD):
        self.world_size = world_size

    def __enter__(self):
        fake_world(self.world_size)

    def __exit__(self, *exc):
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh(shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks with the leading pod
    axis. Needs a world of that many ranks (``fake_world``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def layout_mesh(mesh):
    """The mesh a dry run lays its DTensors out on: ``mesh`` itself, or
    for the 2 x 16 x 16 mesh its (pod x data) x model view, 32 x 16
    ("data", "model") over the same ranks. The two hold the same shards
    (every role spec puts "pod" and "data" together, on one dim), and the
    view makes each DP group one group of 32, as XLA forms the replica
    groups of ("pod", "data"). With two mesh dims sharding one tensor dim,
    DTensor's placement search takes minutes a cell and picks layouts
    that repeat work across the pods."""
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", mesh.mesh.reshape(-1, mesh.size(
        names.index("model"))), mesh_dim_names=("data", "model"))


def make_debug_mesh(n_data: int = 2, n_model: int = 2):
    """Small mesh over the first n_data * n_model ranks."""
    return _mesh((n_data, n_model), ("data", "model"))
