"""Device meshes: the reference's production meshes and the card's own.

``make_production_mesh`` builds the reference's meshes, 16×16 chips
("data", "model") and two pods of them, 2×16×16 ("pod", "data",
"model"), in one process and without a device: a ``DeviceMesh`` over
``torch.distributed``'s fake backend (a world of 512 ranks of which this
process is rank 0, no communication). A dry run reads from it what each
device would hold (``runtime.sharding``). The process group is global:
such a process can hold no other group, so run it on its own
(``launch/dryrun.py`` does).

``make_fake_mesh`` builds any mesh that way (a test's 2×2 or 1×4 beside a
real run of the same shape).

``make_host_mesh`` is a real 1×1 mesh over a world of one: one H100 with
NCCL, or the CPU with gloo.

The reference also carries a TPU's peak rates for its roofline; nothing
here reads them, and the one hardware number the port needs, the card's
memory, comes from the card (``torch.cuda.get_device_properties``) or, in
a dry run, from ``launch.dryrun.H100_BYTES``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

WORLD = 512  # the reference forces 512 host devices: both meshes fit one world


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16×16 ("data", "model") mesh, or with ``multi_pod`` the 2×16×16
    ("pod", "data", "model") one, over the fake backend; starts the fake
    world of 512 ranks unless it is already up."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"), device_type, WORLD)
    return make_fake_mesh((16, 16), ("data", "model"), device_type, WORLD)


def make_fake_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str = "cuda",
                   world: int | None = None):
    """A mesh of ``shape`` named ``names`` over the fake backend, this process
    its rank 0; starts a fake world of ``world`` ranks (default the mesh's
    size) unless a fake world that large is already up."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for s in shape:
        n *= s
    world = world or n
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    elif dist.get_backend() != "fake" or dist.get_world_size() < n:
        raise RuntimeError(f"a {dist.get_backend()} process group of "
                           f"{dist.get_world_size()} ranks is up: a fake mesh of {n} needs "
                           f"the fake backend (run it in its own process)")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_host_mesh(device_type: str = "cuda"):
    """A 1×1 ("data", "model") mesh over a world of one, this process: NCCL
    on the card, gloo on the CPU. Starts that world unless a group is up."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))
