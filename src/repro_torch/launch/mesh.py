# Counterpart of src/repro/launch/mesh.py; nothing of it is left unported.
# The production mesh is shape-only here (axis names and sizes, no devices):
# `logical_rules` and `plan_for` price plans on it without 256 ranks.  The
# host mesh is a `DeviceMesh` over the process group's ranks, so a process
# group must exist first: `init_process_group` below starts one from a
# `file://` store (no fixed port), NCCL on the card and gloo on the CPU.
# `make_fake_mesh` is the production mesh as a `DeviceMesh` whose process
# group is torch's fake one (rank 0 of 256 or 512; collectives move nothing),
# on which the dry-run runs a cell's step on fake tensors.  A process holds
# one default group, so a fake mesh takes its process for good: the dry-run
# runs each cell in a process of its own.
"""Production mesh shapes and the host mesh of a process group."""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, touching no device (``shape`` maps a
    name to its size, as a JAX ``Mesh``'s does)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(axes, shape)


def make_fake_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """The production mesh as a ``DeviceMesh`` of the same axes, this
    process being rank 0 of a fake process group of 256 (or 512) ranks
    (``torch.testing._internal.distributed.fake_pg``): DTensor runs its
    sharding propagation and issues its collectives, which move nothing.
    On the card unless ``device="cpu"``.  Raises if a process group exists
    already (a process holds one default group)."""
    if dist.is_initialized():
        raise RuntimeError("make_fake_mesh: a process group exists already; "
                           "run each fake mesh in a process of its own")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    prod = make_production_mesh(multi_pod=multi_pod)
    dev = resolve_device(device)
    world = 1
    for n in prod.sizes:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh(dev.type, prod.sizes,
                            mesh_dim_names=prod.axis_names)


def init_process_group(init_file: str, rank: int, world_size: int, *,
                       device: DeviceLike = None,
                       timeout_s: float = 120.0) -> str:
    """Join (or start) the process group of ``world_size`` ranks that meet
    at ``file://<init_file>`` (a path no other group uses), with NCCL on the
    card and gloo on the CPU, and a timeout on every collective.  Returns the
    backend's name.  On the card each rank takes the device of its rank."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_host_mesh(model: int = 1, *, device: DeviceLike = None):
    """A ``(world // model, model)`` ``("data", "model")`` DeviceMesh over
    the ranks of the process group, on the card unless ``device="cpu"``.
    Raises if no process group is initialised (it never starts one)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_host_mesh: no process group; call "
                           "repro_torch.launch.mesh.init_process_group first")
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"make_host_mesh: world size {world} does not "
                         f"divide into model={model}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, (world // model, model),
                            mesh_dim_names=("data", "model"))
