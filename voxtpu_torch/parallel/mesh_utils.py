"""Device meshes for sharded voxelization, JFA and training.

Port of `voxtpu/parallel/mesh_utils.py` on `torch.distributed`. Axis
conventions are voxtpu's:

- ``"d"``: the triangle (data) axis; each rank owns a distinct triangle
  slice, and occupancy contributions combine with an XOR or a sum.
- ``"z"``: the grid axis; voxel grids are cut into Z slabs along it (the
  outermost, contiguous array axis), and JFA flood steps exchange halos
  along it.

Rank r sits at (d, z) = divmod(r, dz), the order of voxtpu's
``devices.reshape(dd, dz)``, so a rank's shard index is its rank. The
mesh spans the process group's whole world (one device a rank); ranks
that share a CUDA card share it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def mesh_shape(n: int, grid_axis: int | None = None) -> tuple[int, int]:
    """(dd, dz) of voxtpu's `make_mesh` over n devices: z the largest of
    8, 4, 2, 1 that divides n, unless `grid_axis` fixes it."""
    if grid_axis is None:
        grid_axis = next(c for c in (8, 4, 2, 1) if n % c == 0)
    if n % grid_axis != 0:
        raise ValueError(f"{n} devices not divisible by grid axis {grid_axis}")
    return n // grid_axis, grid_axis


def make_mesh(n_devices: int | None = None, grid_axis: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (d, z) mesh over every rank of the process group. `n_devices`,
    where given, must be the world size (a rank holds one device);
    `grid_axis` fixes the z size. `device_type` is ``"cuda"`` unless the
    caller asks for ``"cpu"``."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the world of {world} "
                         "ranks, one device each")
    return init_device_mesh(device_type, mesh_shape(world, grid_axis),
                            mesh_dim_names=("d", "z"))


def grid_sharding(mesh: DeviceMesh):
    """Voxel and SDF grids: Z slabs over the z axis, whole over d."""
    return (Replicate(), Shard(0))


def replicated(mesh: DeviceMesh):
    return (Replicate(), Replicate())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of the mesh: its CUDA card (the current
    device), or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def z_coord(mesh: DeviceMesh) -> int:
    """This rank's index along z (voxtpu's ``axis_index("z")``)."""
    return mesh.get_local_rank("z")


def local_slab(full: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's Z slab of a replicated (n, ...) array."""
    dz = mesh.size(mesh.mesh_dim_names.index("z"))
    slab = full.shape[0] // dz
    z = z_coord(mesh)
    return full[z * slab:(z + 1) * slab]


def world_group(mesh: DeviceMesh):
    """The process group of every rank of `mesh`, which spans the world
    (voxtpu's collectives over ("d", "z"))."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of the world's "
                         f"{dist.get_world_size()} ranks")
    return dist.group.WORLD
