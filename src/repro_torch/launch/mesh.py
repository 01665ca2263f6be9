"""Device meshes on ``torch.distributed`` (port of
``repro/launch/mesh.py``): the production shapes (a 16 x 16 pod, two
pods of 16 x 16) and the elastic mesh over a surviving device list.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, its dimensions named like the reference's
axes; ``mesh.get_group(axis)`` is the group a collective over that axis
takes (``optim.compression.compressed_psum``). It uses NCCL for ``cuda``
and gloo for the CPU. Where no group exists and the mesh has one device,
:func:`make_compat_mesh` starts a world of one through a
``torch.distributed.HashStore``, so no ``MASTER_ADDR`` is needed; a
larger mesh needs a group of as many ranks, which the caller starts
(``torch.distributed.init_process_group`` with its address, world size
and rank).

:class:`MetaMesh` stands for rank 0 of a mesh without a process group:
the dry run lays a cell out on the production meshes with it, on the
``meta`` device (:mod:`repro_torch.launch.collectives` reaches no group
there).

The reference's ``mesh_axis_types_kwargs``, ``compat_shard_map`` and
``compat_pvary`` are shims over JAX versions (axis types, the
``shard_map`` module's move, ``pvary``'s typing); they have no torch
counterpart and are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..runtime.fault_tolerance import plan_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_compat_mesh(shape: tuple, axes: tuple,
                     device: str | torch.device | None = None) -> DeviceMesh:
    """A mesh of ``shape`` with dimensions named ``axes`` over the ranks
    of the default group, for ``device``'s type (``cuda`` by default).
    Raises ``ValueError`` where ``prod(shape)`` is not the world size (a
    world of one where no group exists)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no mesh on {dev}")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"mesh {shape} holds {n} devices; the world has "
                         f"{world} ranks")
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[dev.type], store=dist.HashStore(),
                                rank=0, world_size=1)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


class MetaMesh:
    """Rank 0 of a mesh of ``shape`` with dimensions named ``axes``, with
    the ``DeviceMesh`` attributes the port reads (``shape``,
    ``mesh_dim_names``, ``size()``, ``get_local_rank``) and no process
    group: the collectives take ``meta`` tensors on it
    (``is_meta``)."""

    is_meta = True

    def __init__(self, shape: tuple, axes: tuple):
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axes)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in length")

    def size(self) -> int:
        return math.prod(self.shape)

    def get_local_rank(self, axis: str) -> int:
        if axis not in self.mesh_dim_names:
            raise KeyError(f"no axis {axis!r} in {self.mesh_dim_names}")
        return 0

    def __repr__(self) -> str:
        return f"MetaMesh({self.shape}, {self.mesh_dim_names})"


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """The reference's production mesh: (shape, axes)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None
                         ) -> DeviceMesh:
    """The reference's shapes: 16 x 16 ``("data", "model")``, or 2 x 16 x
    16 ``("pod", "data", "model")`` when ``multi_pod``; raises at any other
    world size."""
    return make_compat_mesh(*production_shape(multi_pod), device)


def make_mesh_for_devices(devices: list, model_axis: int = 16,
                          pod_axis: int = 1) -> DeviceMesh:
    """Elastic variant: the biggest legal mesh for a surviving device list
    (``runtime.fault_tolerance.plan_mesh``), on the first device's type;
    the world must hold exactly its devices."""
    if not devices:
        raise ValueError("no devices")
    shape = plan_mesh(len(devices), model_axis, pod_axis)
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    return make_compat_mesh(shape, axes, torch.device(devices[0]).type)
