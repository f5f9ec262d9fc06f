"""Device meshes over a torch.distributed world.

Counterpart of ``albatross_tpu.parallel.mesh``: the JAX package's
``jax.sharding.Mesh`` becomes torch's ``DeviceMesh``, one rank (process)
a device, and a ``NamedSharding`` the DTensor placements of a named mesh
dimension.  A mesh needs an initialized process group
(``torch.distributed.init_process_group``, or ``initialize_multihost``
under ``torchrun``); it spans the whole world.  The ranks fill the grid in
row-major order, as a JAX mesh's devices do.  The group of each mesh
dimension is created with the world's own backend, so gloo ranks that
share one card build a 2-D mesh as well as NCCL ranks on their own cards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .. import config


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    device=None,
) -> DeviceMesh:
    """A mesh over the world's ranks, on ``config.device(device)``'s type
    (the card unless the caller asks for the CPU).

    With one axis name the mesh is 1-D over every rank; pass ``shape`` for
    a multi-axis mesh (e.g. shape=(4, 2), axis_names=('data', 'model')).
    ``n_devices`` must be the world size: a mesh spans the whole world."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: call "
                           "torch.distributed.init_process_group (or parallel.initialize_multihost "
                           "under torchrun) first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh spans the whole world: n_devices = {n_devices}, but the process "
                         f"group has {world} ranks")
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("multi-axis mesh needs an explicit shape")
        shape = (n_devices,)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} and axis names {tuple(axis_names)} differ in length")
    count = 1
    for s in shape:
        count *= int(s)
    if count != n_devices:
        raise ValueError(f"shape {tuple(shape)} does not cover {n_devices} devices")
    device_type = config.device(device).type
    if len(shape) == 1:  # the world's own group, whatever its backend (gloo ranks may share a card)
        return DeviceMesh.from_group(dist.group.WORLD, device_type, mesh_dim_names=tuple(axis_names))
    return _mesh_of_groups(device_type, tuple(int(s) for s in shape), tuple(axis_names))


def _mesh_of_groups(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    """A multi-dimensional mesh whose dimension groups are new groups of
    the world's backend: for each dimension, every rank joins the creation
    of each line of ranks along it (``new_group`` is collective over the
    world) and keeps the line it lies on."""
    rank, backend = dist.get_rank(), dist.get_backend()
    layout = torch.arange(dist.get_world_size()).reshape(shape)
    groups = []
    for dim, size in enumerate(shape):
        mine = None
        for line in layout.movedim(dim, -1).reshape(-1, size).tolist():
            group = dist.new_group(line, backend=backend)
            if rank in line:
                mine = group
        groups.append(mine)
    return DeviceMesh.from_group(groups, device_type, mesh=layout, mesh_dim_names=names)


def _placements(mesh: DeviceMesh, axis: Optional[str]) -> tuple:
    names = mesh.mesh_dim_names or ()
    if axis is not None and axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    return tuple(Shard(0) if name == axis else Replicate() for name in names)


def replicated(mesh: DeviceMesh) -> tuple:
    """DTensor placements of a value every rank holds whole."""
    return _placements(mesh, None)


def row_sharded(mesh: DeviceMesh, axis: str = "data") -> tuple:
    """DTensor placements of a matrix whose rows are split over ``axis``."""
    return _placements(mesh, axis)


def vector_sharded(mesh: DeviceMesh, axis: str = "data") -> tuple:
    """DTensor placements of a vector split over ``axis``."""
    return _placements(mesh, axis)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
