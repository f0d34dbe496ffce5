"""Plain Jump-Flooding signed squared distance field.

The semantics of the sequential reference (cuda-mesh-voxelization,
`vplib/src/jfa/sequential.cpp:24-125`, with the CLI's init): the seeds
are the occupied voxels with an empty or out-of-grid 26-neighbour; a
position is a voxel's corner, origin + index * voxel size. At each
stride k = N/2, ..., 1 every voxel keeps its best seed and then takes,
in (dz, dy, dx) order over the 26 neighbours at that stride, each
neighbour's seed whose squared distance ((px - sx)^2 + (py - sy)^2) +
(pz - sz)^2 is strictly smaller, all in the working precision and read
from the previous step's seeds. The field is that distance, + where
occupied and - elsewhere, +/-inf where no seed arrived.

Plain torch operations; imports nothing of the program under test.
`sdf` also returns, for each step, the seeds and candidates that the
step's function reads, which `perfbench/harness/peaks.py::flood_ops`
turns into the least time of the flood.
"""

from __future__ import annotations

import torch

OFFSETS = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                if (dz, dy, dx) != (0, 0, 0))


def boundary(occ: torch.Tensor) -> torch.Tensor:
    """Occupied voxels with at least one empty or out-of-grid 26-neighbour."""
    n0, n1, n2 = occ.shape
    padded = torch.zeros((n0 + 2, n1 + 2, n2 + 2), dtype=torch.bool, device=occ.device)
    padded[1:-1, 1:-1, 1:-1] = occ
    inner = torch.ones_like(occ)
    for dz, dy, dx in OFFSETS:
        inner &= padded[1 + dz:n0 + 1 + dz, 1 + dy:n1 + 1 + dy, 1 + dx:n2 + 1 + dx]
    return occ & ~inner


def _boxes(n: int, k: int, d: tuple):
    """(voxel box, neighbour box) slices of the voxels whose neighbour at
    offset d * k lies in the grid; None where there are none."""
    vox, src = [], []
    for di in d:
        s = di * k
        a, b = max(0, -s), min(n, n - s)
        if a >= b:
            return None
        vox.append(slice(a, b))
        src.append(slice(a + s, b + s))
    return tuple(vox), tuple(src)


def sdf(occ: torch.Tensor, origin, voxel: float, dtype: torch.dtype = torch.float32):
    """(field (n, n, n) float32, [(seeded, pairs, candidates)] a step).

    `occ` is a dense (n, n, n) bool grid in [z, y, x] order; `origin`
    (ox, oy, oz) and `voxel` give the world positions."""
    n = occ.shape[0]
    dev = occ.device
    idx = torch.arange(n, device=dev, dtype=dtype)
    corner = [torch.tensor(float(o), dtype=dtype, device=dev) + idx * torch.tensor(
        float(voxel), dtype=dtype, device=dev) for o in origin]
    px, py, pz = corner[0].view(1, 1, n), corner[1].view(1, n, 1), corner[2].view(n, 1, 1)
    seeds = boundary(occ)
    lin = torch.arange(n * n * n, dtype=torch.int32, device=dev).view(n, n, n)
    state = torch.where(seeds, lin, torch.full_like(lin, -1))
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    best_d2 = torch.where(seeds, torch.zeros((), dtype=dtype, device=dev), inf)
    del lin, seeds
    work = []
    k = n // 2
    while k >= 1:
        valid_all = state >= 0
        seeded = int(valid_all.sum())
        pairs = candidates = seeded
        sx = corner[0][state % n]
        sy = corner[1][(state // n) % n]
        sz = corner[2][(state // (n * n)) % n]
        new_state = state.clone()
        for d in OFFSETS:
            boxes = _boxes(n, k, d)
            if boxes is None:
                continue
            vox, src = boxes
            valid = valid_all[src]
            count = int(valid.sum())
            candidates += count
            pairs += count if d[0] == 0 else 0
            ex = px[..., vox[2]] - sx[src]
            ey = py[:, vox[1], :] - sy[src]
            ez = pz[vox[0]] - sz[src]
            d2 = ex * ex + ey * ey + ez * ez
            del ex, ey, ez
            cur = best_d2[vox]
            better = valid & (d2 < cur)
            best_d2[vox] = torch.where(better, d2, cur)
            new_state[vox] = torch.where(better, state[src], new_state[vox])
            del d2, better, cur, valid
        state = new_state
        del sx, sy, sz, valid_all
        work.append((seeded, pairs, candidates))
        k //= 2
    one = torch.ones((), dtype=torch.float32, device=dev)
    field = torch.where(occ, one, -one) * best_d2.float()
    return field, work


def differing_values(a: torch.Tensor, b: torch.Tensor) -> int:
    """Voxels where two float fields of one shape differ (inf equals inf)."""
    if a.shape != b.shape:
        raise ValueError(f"fields of shapes {tuple(a.shape)} and {tuple(b.shape)}")
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())
