"""Production mesh construction (``repro.launch.mesh``' counterpart), on
``torch.distributed.device_mesh.DeviceMesh``.

A ``DeviceMesh`` needs a process group of as many ranks as the mesh has
devices.  ``placeholder_world(n)`` gives one in a single process: a
fake process group of ``n`` ranks whose collectives move nothing, which
is what the dry run builds its 256- and 512-rank meshes on (the
reference forces that many placeholder XLA host devices instead).  The
functions here touch no device and no group until called.
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips for the multi-pod
    run.  Needs a world of that many ranks (``placeholder_world``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """1x1 mesh over a world of one rank."""
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def make_smoke_mesh(device_type: str = "cuda") -> DeviceMesh:
    """2x2 data x model mesh for the dry run's smoke sweep: small, but it
    shards BOTH axes (a 1x1 mesh would hide every partitioning bug)."""
    return init_device_mesh(device_type, (2, 2),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over (pure DP axes)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


@contextlib.contextmanager
def placeholder_world(n: int, device_type: str = "cuda"):
    """A fake process group of ``n`` ranks (this process is rank 0) for
    ``device_type``'s tensors, for the duration of the block, destroyed
    on the way out.

    Refuses to run when a process group exists already: reusing it would
    give the dry run the wrong world, and a fake group left behind would
    make every later ``dist.api.read_shard()`` in the process return
    ``(0, n)``."""
    if dist.is_initialized():
        raise RuntimeError(
            "placeholder_world: a process group is already initialised "
            f"(world size {dist.get_world_size()}); destroy it first")
    # importing fake_pg registers the "fake" backend for cpu and cuda
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(f"{device_type}:fake", store=FakeStore(),
                            rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
