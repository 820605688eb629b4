"""Production meshes as ``torch.distributed`` DeviceMeshes.

The counterpart of the JAX package's ``launch/mesh.py``. The production
meshes are 16x16 (one pod, 256 devices, dims ``("data", "model")``) and
2x16x16 (two pods, 512 devices, ``("pod", "data", "model")``). They sit
on a process group of 256 or 512 ranks that exists only in this process:
torch's ``"fake"`` backend, whose collectives move nothing. This process
is rank 0, and every tensor it holds is rank 0's shard. That is the
counterpart of the reference's ``--xla_force_host_platform_device_count``.
The mesh's device type is the host's (``cpu``); what it plans is
per device.

Everything is a function: importing this module creates no group, so a
process that never asks for a production mesh never has one.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def _fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process rank 0), replacing an earlier fake one of another
    size. A real group is left alone and refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; the "
                               "production meshes need the fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_group(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The degenerate 1x1 ``("data", "model")`` mesh of one real device:
    the same launch code runs on it with plain tensors (no DTensor and
    no process group)."""
    device: torch.device
    mesh_dim_names: tuple = ("data", "model")
    shape: tuple = (1, 1)

    @property
    def device_type(self) -> str:
        return self.device.type

    def size(self) -> int:
        return 1


def make_host_mesh(device="cuda") -> HostMesh:
    """A 1x1 mesh on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``), for real runs of the same launch code."""
    from repro_torch.device import resolve_device
    return HostMesh(resolve_device(device))


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def is_distributed(mesh) -> bool:
    """Whether ``mesh`` spans more than one device (tensors on it are
    DTensors)."""
    return not isinstance(mesh, HostMesh) and mesh.size() > 1
