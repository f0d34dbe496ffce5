"""Multi-process bootstrap: the process group, global meshes, sharded
arrays.

Port of `voxtpu/parallel/distributed.py` on `torch.distributed`.
voxtpu joins JAX's multi-controller runtime; here every rank is a
process of one `torch.distributed` process group:

- `init_distributed()` calls `dist.init_process_group`, with torchrun's
  environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) when given no
  arguments, or an explicit rendezvous address (``tcp://host:port`` or
  ``file:///path``), world size and rank, and optionally the rank's
  card (voxtpu's ``local_device_ids``). The backend is the caller's:
  ``"nccl"`` for CUDA and ``"gloo"`` for the CPU by default. Each rank
  takes its own card (`rank_card`: ``local_device_ids``, ``LOCAL_RANK``
  or the rank modulo the host's cards). NCCL refuses two ranks on one
  card, so ranks that share one card ask for ``"gloo"`` by name
  (`voxtpu_torch.parallel.collectives` then stages their CUDA tensors
  through the host, and counts the bytes).
- `global_mesh()` builds a `DeviceMesh` over every rank.
- `global_from_local()` wraps this rank's block as a `DTensor`, and
  `local_from_global()` returns it with its place in the global array.
  Neither runs a collective (gloo cannot all-gather CUDA tensors).

Usage (2 hosts, one card each; on one host of 4 cards, rank r of
``init_distributed("tcp://localhost:8476", 4, r)`` takes card r)::

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


def _on_this_host(address: str | None) -> bool:
    """Whether a rendezvous address names this host (a file, localhost
    or a loopback address)."""
    if address is None:
        return False
    if address.startswith("file://"):
        return True
    host = address.split("://", 1)[-1].rsplit(":", 1)[0].strip("[]")
    return host in ("localhost", "::1") or host.startswith("127.")


def rank_card(device_count: int, *, local_device_ids=None, local_rank: int | None = None,
              process_id: int | None = None, ranks_on_host: int | None = None,
              backend: str = "nccl") -> int:
    """The CUDA card a rank takes: ``local_device_ids[0]`` (one card a
    rank), else ``LOCAL_RANK`` (`local_rank`), else ``process_id %
    device_count`` where an explicit process id is given, else card 0.

    NCCL refuses two ranks on one card ("Duplicate GPU detected"), so
    where NCCL would get more ranks on this host (`ranks_on_host`, where
    known) than it has cards, this raises before any process group
    starts; ranks that share a card take ``backend="gloo"``."""
    if device_count < 1:
        raise ValueError("no CUDA card on this host")
    if local_device_ids is not None:
        ids = list(local_device_ids)
        if len(ids) != 1:
            raise ValueError(f"local_device_ids={ids}: a rank holds one card")
        card = int(ids[0])
    elif local_rank is not None:
        card = int(local_rank)
    elif process_id is not None:
        card = int(process_id) % device_count
    else:
        card = 0
    if not 0 <= card < device_count:
        raise ValueError(f"card {card} does not exist: this host has {device_count}")
    if backend == "nccl" and ranks_on_host is not None and ranks_on_host > device_count:
        raise ValueError(f"NCCL takes one card a rank: {ranks_on_host} ranks on this host "
                         f"and {device_count} cards (ranks that share a card pass "
                         "backend='gloo')")
    return card


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, *,
                     backend: str | None = None) -> tuple[int, int]:
    """Join (or start) the process group; idempotent: a second call
    returns the group's (rank, world size) and changes nothing.

    With no arguments, torchrun's environment names the rendezvous
    (``env://``); otherwise `coordinator_address` is an init method URL
    (``tcp://host:port``, ``file:///path``) and `num_processes`,
    `process_id` the world size and this rank. `backend` defaults to
    ``"nccl"`` where CUDA is available and ``"gloo"`` elsewhere. A CUDA
    rank's card is `rank_card`'s: `local_device_ids` (voxtpu's fourth
    argument, one card here), ``LOCAL_RANK``, or `process_id` modulo the
    host's cards. Returns ``(rank, world_size)``."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        device_id = None
        if torch.cuda.is_available():
            local_rank = os.environ.get("LOCAL_RANK")
            if "LOCAL_WORLD_SIZE" in os.environ:
                local_ranks = int(os.environ["LOCAL_WORLD_SIZE"])
            elif _on_this_host(coordinator_address):
                local_ranks = num_processes
            else:
                local_ranks = None
            card = rank_card(torch.cuda.device_count(), local_device_ids=local_device_ids,
                             local_rank=None if local_rank is None else int(local_rank),
                             process_id=process_id, ranks_on_host=local_ranks, backend=backend)
            torch.cuda.set_device(card)
            if backend == "nccl":
                device_id = torch.device("cuda", card)
        if coordinator_address is None:
            dist.init_process_group(backend, device_id=device_id)
        else:
            dist.init_process_group(backend, init_method=coordinator_address,
                                    world_size=num_processes, rank=process_id,
                                    device_id=device_id)
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
