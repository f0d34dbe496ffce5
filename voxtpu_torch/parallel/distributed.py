"""Multi-process bootstrap: the process group, global meshes, sharded
arrays.

Port of `voxtpu/parallel/distributed.py` on `torch.distributed`.
voxtpu joins JAX's multi-controller runtime; here every rank is a
process of one `torch.distributed` process group:

- `init_distributed()` calls `dist.init_process_group`, with torchrun's
  environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) when given no
  arguments, or an explicit rendezvous address (``tcp://host:port`` or
  ``file:///path``), world size and rank. The backend is the caller's:
  ``"nccl"`` for CUDA and ``"gloo"`` for the CPU by default. NCCL refuses
  two ranks on one card, so ranks that share one card ask for
  ``"gloo"`` by name (`voxtpu_torch.parallel.collectives` then stages
  their CUDA tensors through the host, and counts the bytes).
- `global_mesh()` builds a `DeviceMesh` over every rank.
- `global_from_local()` wraps this rank's block as a `DTensor`, and
  `local_from_global()` returns it with its place in the global array.
  Neither runs a collective (gloo cannot all-gather CUDA tensors).

Usage (2 hosts, one card each)::

    # host 0                                        # host 1
    init_distributed("tcp://10.0.0.1:8476", 2, 0)   init_distributed("tcp://10.0.0.1:8476", 2, 1)
    mesh = global_mesh(("d", "z"))                  # (1, 2)
    occ = global_from_local(local_slab, mesh, grid_sharding(mesh))
    sdf = jfa_sharded(local_slab, spec, mesh)       # halos by send/recv

or ``torchrun --nproc-per-node N script.py`` and `init_distributed()`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> tuple[int, int]:
    """Join (or start) the process group; idempotent: a second call
    returns the group's (rank, world size) and changes nothing.

    With no arguments, torchrun's environment names the rendezvous
    (``env://``); otherwise `coordinator_address` is an init method URL
    (``tcp://host:port``, ``file:///path``) and `num_processes`,
    `process_id` the world size and this rank. `backend` defaults to
    ``"nccl"`` where CUDA is available and ``"gloo"`` elsewhere. A CUDA
    rank's current device becomes ``LOCAL_RANK`` (0 without torchrun).
    Returns ``(rank, world_size)``."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if coordinator_address is None:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=coordinator_address,
                                    world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed() -> None:
    """Tear down the process group (tests; optional at exit)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(axis_names: tuple[str, ...], axis_shape: tuple[int, ...] | None = None,
                device_type: str = "cuda") -> DeviceMesh:
    """A device mesh over every rank. `axis_shape` defaults to every rank
    on the last axis (the "z" slab axis of `voxtpu_torch.parallel`);
    `device_type` is ``"cuda"`` unless the caller asks for ``"cpu"``."""
    n = dist.get_world_size()
    if axis_shape is None:
        axis_shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(axis_shape)) != n:
        raise ValueError(f"axis_shape {axis_shape} != world size {n}")
    return init_device_mesh(device_type, tuple(axis_shape), mesh_dim_names=tuple(axis_names))


def global_from_local(local: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """This rank's contiguous block of a global array as a DTensor over
    `mesh` (every rank passes a block of the same shape; no check, no
    collective)."""
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False)


def local_from_global(garr: DTensor):
    """This rank's block of a DTensor as [(index, ndarray)]: `index` a
    tuple of slices into the global array (the egress dual of
    `global_from_local`; one block a rank)."""
    local = garr.to_local()
    index = [slice(0, s) for s in garr.shape]
    coord = garr.device_mesh.get_coordinate()
    for mesh_dim, p in enumerate(garr.placements):
        if isinstance(p, Shard):
            size = local.shape[p.dim]
            start = coord[mesh_dim] * size
            index[p.dim] = slice(start, start + size)
    return [(tuple(index), local.detach().cpu().numpy())]
