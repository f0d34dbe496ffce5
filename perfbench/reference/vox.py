"""Plain solid voxelization: a mesh to its packed occupancy grid.

The semantics of the sequential reference voxelizer
(cuda-mesh-voxelization, `vplib/src/vox/sequential.cpp:18-61`): per
triangle, the YZ bounding box of cell centres is rastered with three
inclusive edge functions oriented by sign(normal.x); each covered
centre's ray along +x toggles every voxel from the plane intersection's
cell (truncated toward zero, clamped to [0, N]) to the +x edge. Every
operation rounds on its own in the working precision, in the reference's
order. Raster rows outside [0, N) are skipped.

Written with plain torch operations over all triangles at once (the
toggles as counts, their parity as a prefix sum along x), so that a
512^3 grid of a million faces takes well under a second on a card. It
imports nothing of the program under test.

`dtype` is the working precision: float32 is the configuration's;
a lower one is the control (`perfbench/controls.py`).
"""

from __future__ import annotations

import torch

WORD_BITS = 32
CHUNK = 1 << 22  # candidate cells a chunk


def _edge(py, pz, qy, qz, y, z):
    """(z - p.z) * (q.y - p.y) - (y - p.y) * (q.z - p.z)."""
    return (z - pz) * (qy - py) - (y - py) * (qz - pz)


def _toggles(coords: torch.Tensor, faces: torch.Tensor, n: int, origin, voxel: float,
             dtype: torch.dtype):
    """(yz cell, start x) of every toggle, int64 each."""
    dev = coords.device
    c = coords.to(dtype)
    v0, v1, v2 = c[faces[:, 0]], c[faces[:, 1]], c[faces[:, 2]]
    ox, oy, oz = (torch.tensor(float(o), dtype=dtype, device=dev) for o in origin)
    vs = torch.tensor(float(voxel), dtype=dtype, device=dev)
    half = vs / 2

    def window(axis, o):
        lo = torch.minimum(torch.minimum(v0[:, axis], v1[:, axis]), v2[:, axis])
        hi = torch.maximum(torch.maximum(v0[:, axis], v1[:, axis]), v2[:, axis])
        start = torch.floor((lo - o) / vs).clamp(-1, n + 1).long().clamp(0, n)
        end = torch.ceil((hi - o) / vs).clamp(-1, n + 1).long().clamp(0, n)
        return start, end

    sy, ey = window(1, oy)
    sz, ez = window(2, oz)
    wy, wz = (ey - sy).clamp(min=0), (ez - sz).clamp(min=0)
    live = torch.nonzero((wy > 0) & (wz > 0)).squeeze(1)
    # normal = cross(v1 - v0, v2 - v1); only sign(normal.x) is used.
    a, b = v1 - v0, v2 - v1
    normal_x = a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1]
    one = torch.ones((), dtype=dtype, device=dev)
    sign = torch.where(normal_x >= 0, one, -one)
    e0, e1 = v1 - v0, v2 - v0
    A = e0[:, 1] * e1[:, 2] - e0[:, 2] * e1[:, 1]
    B = e0[:, 2] * e1[:, 0] - e0[:, 0] * e1[:, 2]
    C = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    D = A * v0[:, 0] + B * v0[:, 1] + C * v0[:, 2]

    cells, starts = [], []
    # Triangles in order of window width, so that each chunk's boxes are
    # about as wide as its widest.
    wmax = torch.maximum(wy, wz)[live]
    order = torch.argsort(wmax)
    live, wmax = live[order], wmax[order].tolist()
    i = 0
    while i < len(wmax):
        j = min(i + max(1, CHUNK // wmax[i] ** 2), len(wmax))
        j = min(i + max(1, CHUNK // wmax[j - 1] ** 2), j)
        f, w = live[i:j], wmax[j - 1]
        i = j
        d = torch.arange(w, device=dev)
        ys = sy[f, None, None] + d[None, None, :]
        zs = sz[f, None, None] + d[None, :, None]
        inwin = (ys < ey[f, None, None]) & (zs < ez[f, None, None])
        cy = oy + (ys.to(dtype) * vs + half)
        cz = oz + (zs.to(dtype) * vs + half)

        def col(t):
            return t[f][:, None, None]

        s = col(sign)
        p0, p1, p2 = v0[f], v1[f], v2[f]
        k0 = _edge(p0[:, 1, None, None], p0[:, 2, None, None], p1[:, 1, None, None],
                   p1[:, 2, None, None], cy, cz) * s
        k1 = _edge(p1[:, 1, None, None], p1[:, 2, None, None], p2[:, 1, None, None],
                   p2[:, 2, None, None], cy, cz) * s
        k2 = _edge(p2[:, 1, None, None], p2[:, 2, None, None], p0[:, 1, None, None],
                   p0[:, 2, None, None], cy, cz) * s
        inside = inwin & (k0 >= 0) & (k1 >= 0) & (k2 >= 0)
        xf = ((col(D) - col(B) * cy - col(C) * cz) / col(A) - ox) / vs
        valid = inside & torch.isfinite(xf) & (xf < n)
        xs = torch.trunc(torch.where(valid, xf, torch.zeros((), dtype=dtype, device=dev)))
        xs = xs.clamp(min=-1).long().clamp(0, n)
        cells.append((zs * n + ys)[valid])
        starts.append(xs[valid])
    if not cells:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    return torch.cat(cells), torch.cat(starts)


def pack(occ: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., N/32) int32 words; bit b of word w is x = 32 w + b."""
    n = occ.shape[-1]
    bits = occ.reshape(*occ.shape[:-1], n // WORD_BITS, WORD_BITS).to(torch.int64)
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=occ.device) << torch.arange(
        WORD_BITS, device=occ.device)
    words = (bits * weights).sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)  # two's complement


def voxelize_dense(coords: torch.Tensor, faces: torch.Tensor, n: int, origin, voxel: float,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The solid (n, n, n) bool grid in [z, y, x] order. `coords` (V, 3)
    float32 and `faces` (F, 3) integer tensors on one device."""
    cells, starts = _toggles(coords, faces.long(), n, origin, voxel, dtype)
    flips = torch.zeros(n * n * (n + 1), dtype=torch.int32, device=coords.device)
    flips.index_put_((cells * (n + 1) + starts,), torch.ones_like(cells, dtype=torch.int32),
                     accumulate=True)
    flips = flips.view(n * n, n + 1)[:, :n]
    occ = (torch.cumsum(flips, dim=1, dtype=torch.int32) & 1).bool()
    return occ.view(n, n, n)


def voxelize(coords: torch.Tensor, faces: torch.Tensor, n: int, origin, voxel: float,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The packed (n, n, n/32) int32 grid of `voxelize_dense`."""
    return pack(voxelize_dense(coords, faces, n, origin, voxel, dtype))


def popcount(words: torch.Tensor) -> int:
    """Set bits of an int32 word tensor."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def differing_voxels(a: torch.Tensor, b: torch.Tensor) -> int:
    """Voxels where two packed grids of one shape differ."""
    if a.shape != b.shape:
        raise ValueError(f"grids of shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return popcount(a ^ b)
