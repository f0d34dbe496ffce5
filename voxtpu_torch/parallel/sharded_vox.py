"""Sharded solid voxelization: triangle-sharded fragments, Z-slab
resolve.

Port of `voxtpu/parallel/sharded_vox.py` (XLA code in voxtpu, torch ops
here; no kernel). Every rank runs what voxtpu's `shard_map` body runs:

1. The plan's triangle buckets are split on the host into one equal
   padded slice a rank (`_split_buckets`; pad rows are inert).
2. A rank emits the fragments of its slice (`ops/vox.py::
   emit_fragments`) and sorts its list by (cell, x).
3. ``exchange="ring"``: the sorted lists are all-gathered over "d"
   (usually one rank), then rotate dz - 1 times around the z ring; each
   rank XORs every visiting list's contribution to its own Z slab
   (`_resolve_slab`, the word-event resolve of one slab). XOR is
   associative, so the order of the visits does not matter.
   ``exchange="gather"``: every rank all-gathers every list, sorts it
   whole and resolves its slab.

A rank's result is its Z slab of packed words.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from voxtpu_torch.grids.voxel_grid import WORD_BITS, GridSpec, VoxelGrid
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox import FragmentPlan, _cumxor, emit_fragments, suffix_masks
from voxtpu_torch.parallel import collectives as C
from voxtpu_torch.parallel.mesh_utils import mesh_device, world_group, z_coord

EXCHANGES = ("ring", "gather")


def _split_buckets(plan: FragmentPlan, n_shards: int):
    """Every bucket's triangle rows in n_shards equal slices, as NumPy
    arrays (`sharded_vox.py:33-52`): [shard][bucket] = (window, v0, v1,
    v2, start_y, start_z), rows padded with zero vertices starting at n
    (inert)."""
    shards = [[] for _ in range(n_shards)]
    n = plan.spec.n
    for window, *arrays in plan.buckets:
        v0, v1, v2, sy, sz = (a.cpu().numpy() for a in arrays)
        per = -(-v0.shape[0] // n_shards)
        pad_to = per * n_shards

        def padarr(a, fill):
            if a.shape[0] == pad_to:
                return a
            extra = np.full((pad_to - a.shape[0],) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, extra], axis=0)

        v0p, v1p, v2p = (padarr(a, 0) for a in (v0, v1, v2))
        syp, szp = padarr(sy, n), padarr(sz, n)
        for s in range(n_shards):
            sl = slice(s * per, (s + 1) * per)
            shards[s].append((window, v0p[sl], v1p[sl], v2p[sl], syp[sl], szp[sl]))
    return shards


def slab_key_limit(n: int, slab: int) -> None:
    """voxtpu's refusal (`sharded_vox.py:79-83`): the slab's composite
    (cell, word) keys must stay below 2^31."""
    num_words = n // WORD_BITS
    if slab * n * num_words + num_words > 2**31 - 1:
        raise ValueError(
            f"slab cell keys exceed int32 at N={n} with this z-axis size; shard over "
            f"more devices (slab*N*N/32 must stay below 2^31)")


def _resolve_slab(cells: torch.Tensor, x_entry: torch.Tensor, *, n: int, slab: int,
                  z: int) -> torch.Tensor:
    """(cell, x)-sorted fragments -> the (slab, n, n/32) int32 words of
    Z slab `z` (`sharded_vox.py:55-100`): the composite key (cell -
    slab base, clipped to [-1, slab*n]) * words + word is sorted, so a
    searchsorted of every (cell, word) probe bounds its fragments; an
    XOR scan of their suffix masks and the parity of the fragments in
    earlier words give each word. Fragments outside the slab fall
    before the first probe or past the last and contribute nothing."""
    num_words = n // WORD_BITS
    slab_key_limit(n, slab)
    x = x_entry.to(torch.int64)
    cw = ((cells.to(torch.int64) - z * slab * n).clamp(-1, slab * n) * num_words
          + torch.clamp(x // WORD_BITS, max=num_words - 1))
    probes = torch.arange(slab * n * num_words + 1, dtype=torch.int64, device=cw.device)
    bounds = torch.searchsorted(cw, probes)
    scan0 = torch.cat([cw.new_zeros(1, dtype=torch.int32), _cumxor(suffix_masks(x))])
    inword = (scan0[bounds[1:]] ^ scan0[bounds[:-1]]).view(-1, num_words)
    b2 = bounds[:-1].view(-1, num_words)
    carry_odd = ((b2 - b2[:, :1]) & 1).to(torch.int32)
    return (inword ^ -carry_odd).view(slab, n, num_words)


def _sort_fragments(cells: torch.Tensor, xs: torch.Tensor, n: int):
    """Sort by (cell, x): one sort of the int64 key cell * n + x."""
    key, _ = torch.sort(cells.to(torch.int64) * n + xs.to(torch.int64))
    return (key // n).to(torch.int32), (key % n).to(torch.int32)


def local_fragments(shard, spec: GridSpec, device):
    """This shard's fragments (cell, x) int32, with voxtpu's sentinel
    first (cell n*n, x 0) so that a shard of no bucket still has one."""
    n = spec.n
    origin, vs = spec.origin_tensor(device), spec.voxel_size_tensor(device)
    cells = [torch.full((1,), n * n, dtype=torch.int32, device=device)]
    xs = [torch.zeros((1,), dtype=torch.int32, device=device)]
    for window, *arrays in shard:
        v0, v1, v2, sy, sz = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                              for a in arrays)
        c, x = emit_fragments(v0, v1, v2, sy, sz, window=window, n=n, origin=origin,
                              vs=vs)
        cells.append(c)
        xs.append(x)
    return torch.cat(cells), torch.cat(xs)


def voxelize_sharded(mesh: Mesh, spec: GridSpec, device_mesh: DeviceMesh,
                     plan: FragmentPlan | None = None,
                     exchange: str = "ring") -> VoxelGrid:
    """Voxelize with the triangles sharded over every rank of
    `device_mesh` and the grid over its "z" axis
    (`sharded_vox.py:103-190`). Returns this rank's Z slab: a VoxelGrid
    whose words are (n / dz, n, n / 32), planes [z * n / dz, (z + 1) *
    n / dz) of the whole grid (`global_from_local(grid.words,
    device_mesh, grid_sharding(device_mesh))` is the sharded grid).

    exchange: ``"ring"`` (each rank sorts its own fragments; the sorted
    lists rotate around the z ring) or ``"gather"`` (every rank gathers
    and sorts every list)."""
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r} (expected one of {EXCHANGES})")
    device = mesh_device(device_mesh)
    if plan is None:
        plan = FragmentPlan(mesh, spec, device)
    n = spec.n
    dd, dz = device_mesh.shape
    if n % dz != 0:
        raise ValueError(f"N={n} must divide by z-axis size {dz}")
    slab = n // dz
    z = z_coord(device_mesh)
    rank = device_mesh.get_rank()
    shard = _split_buckets(plan, dd * dz)[rank]
    cells, xs = local_fragments(shard, spec, device)
    if exchange == "gather":
        group = world_group(device_mesh)
        cells, xs = _sort_fragments(C.all_gather(cells, group), C.all_gather(xs, group), n)
        return _slab_grid(_resolve_slab(cells, xs, n=n, slab=slab, z=z), spec, device)
    dgroup, zgroup = device_mesh.get_group("d"), device_mesh.get_group("z")
    frags = torch.stack(_sort_fragments(C.all_gather(cells, dgroup),
                                        C.all_gather(xs, dgroup), n))
    words = _resolve_slab(*frags, n=n, slab=slab, z=z)
    for _ in range(dz - 1):
        frags = C.permute(frags, zgroup, (z + 1) % dz, (z - 1) % dz)
        words ^= _resolve_slab(*frags, n=n, slab=slab, z=z)
    return _slab_grid(words, spec, device)


def _slab_grid(words: torch.Tensor, spec: GridSpec, device) -> VoxelGrid:
    return VoxelGrid(words=words, origin=spec.origin_tensor(device),
                     voxel_size=spec.voxel_size_tensor(device))
