"""NumPy oracle implementations — the correctness specification.

Port of `voxtpu/ops/reference.py`, unchanged: the port carries its own
copy because importing voxtpu imports jax. These reproduce the reference's *sequential* backends exactly (same float32
arithmetic, same inclusive edge tests, same truncation and sign
conventions), and every accelerated backend (xla / pallas / native) is
unit-tested against them:

- :func:`voxelize_ref`  — solid voxelization, `vplib/src/vox/sequential.cpp:18-61`
  (:func:`voxelize_ref_planes`: the same, on chosen z-planes only)
- :func:`jfa_ref`       — Jump-Flooding SDF,   `vplib/src/jfa/sequential.cpp:24-125`
- :func:`csg_ref`       — CSG word fold,       `vplib/src/csg/sequential.cpp:18-28`

Grids are dense boolean / float32 arrays in ``[z, y, x]`` order
(== the reference's x-fastest linear index, `grid/grid.h:88-92`).

Deliberate divergences from reference UB (SURVEY.md §7 "quirks"):
- Raster rows/columns outside [0, N) are skipped (the reference would
  write out of bounds in release builds).
- Fill start ``x`` is clamped to 0 when the plane intersection falls left
  of the grid (the reference would toggle negative indices).
"""

from __future__ import annotations

import numpy as np

from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh.mesh import Mesh


# ---------------------------------------------------------------------------
# Solid voxelization (Schwarz-Seidel YZ raster + XOR column fill along +X)
# ---------------------------------------------------------------------------

def _edge_zy(v0, v1, y, z):
    """Edge function in the ZY plane, `vplib/src/vox/vox.h:22-24`.

    E = (z - V0.z)*(V1.y - V0.y) - (y - V0.y)*(V1.z - V0.z), float32.
    """
    return (z - v0[2]) * np.float32(v1[1] - v0[1]) - (y - v0[1]) * np.float32(
        v1[2] - v0[2]
    )


def voxelize_ref(mesh: Mesh, spec: GridSpec) -> np.ndarray:
    """Solid-voxelize a mesh into a dense bool grid [z, y, x].

    Per triangle: rasterize the YZ bounding box with three inclusive edge
    functions oriented by sign(normal.X); where covered, XOR-toggle the
    X column from the plane-intersection voxel to the +X grid edge
    (`vox/sequential.cpp:40-60`).
    """
    n = spec.n
    ox, oy, oz = (np.float32(v) for v in spec.origin)
    vs = np.float32(spec.voxel_size)
    occ = np.zeros((n, n, n), dtype=bool)

    coords = mesh.coords.astype(np.float32)
    for f in range(mesh.num_faces):
        v0, v1, v2 = coords[mesh.faces[f]]
        normal = np.cross(v1 - v0, v2 - v1)
        sign = np.float32(1.0 if normal[0] >= 0 else -1.0)

        mins = np.minimum(np.minimum(v0, v1), v2)
        maxs = np.maximum(np.maximum(v0, v1), v2)
        start_y = int(np.floor((mins[1] - oy) / vs))
        end_y = int(np.ceil((maxs[1] - oy) / vs))
        start_z = int(np.floor((mins[2] - oz) / vs))
        end_z = int(np.ceil((maxs[2] - oz) / vs))
        # Divergence: clip the raster window to the grid.
        start_y, end_y = max(start_y, 0), min(end_y, n)
        start_z, end_z = max(start_z, 0), min(end_z, n)
        if start_y >= end_y or start_z >= end_z:
            continue

        edge0 = v1 - v0
        edge1 = v2 - v0
        A, B, C = np.cross(edge0, edge1).astype(np.float32)
        D = np.float32(A * v0[0] + B * v0[1] + C * v0[2])

        ys = np.arange(start_y, end_y, dtype=np.int64)
        zs = np.arange(start_z, end_z, dtype=np.int64)
        cy = (oy + (ys.astype(np.float32) * vs + vs / np.float32(2)))[None, :]  # (1, Y)
        cz = (oz + (zs.astype(np.float32) * vs + vs / np.float32(2)))[:, None]  # (Z, 1)

        e0 = _edge_zy(v0, v1, cy, cz) * sign
        e1 = _edge_zy(v1, v2, cy, cz) * sign
        e2 = _edge_zy(v2, v0, cy, cz) * sign
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)  # (Z, Y)
        if not inside.any():
            continue

        with np.errstate(divide="ignore", invalid="ignore"):
            intersection = (D - B * cy - C * cz) / A  # (Z, Y) float32
            xf = (intersection - ox) / vs
        # static_cast<int> truncates toward zero (`vox/sequential.cpp:55`).
        valid = inside & np.isfinite(xf) & (xf < n)
        start_x = np.where(valid, np.trunc(np.nan_to_num(xf)).astype(np.int64), n)
        start_x = np.clip(start_x, 0, n)  # divergence: clamp left-of-grid to 0

        zz, yy = np.nonzero(valid)
        for z_i, y_i in zip(zz, yy):
            occ[zs[z_i], ys[y_i], start_x[z_i, y_i]:] ^= True

    return occ


def voxelize_ref_planes(mesh: Mesh, spec: GridSpec, planes) -> np.ndarray:
    """Planes z of `voxelize_ref`'s grid, (len(planes), N, N) bool [p, y,
    x], for a grid too large to voxelize whole (4096^3 is 64 GiB dense).

    `voxelize_ref`'s arithmetic term for term, with each face's raster
    rows z restricted to the given planes (strictly increasing, in [0,
    N)). The faces whose z window [start_z, end_z) holds none of them
    are dropped first, with the windows computed for all faces at once
    in the same float32 operations; only the others take a Python
    iteration."""
    n = spec.n
    planes = np.asarray(planes, dtype=np.int64)
    if planes.ndim != 1 or (planes.size and (planes[0] < 0 or planes[-1] >= n
                                             or (np.diff(planes) <= 0).any())):
        raise ValueError(f"planes must be strictly increasing in [0, {n})")
    ox, oy, oz = (np.float32(v) for v in spec.origin)
    vs = np.float32(spec.voxel_size)
    out = np.zeros((planes.size, n, n), dtype=bool)

    coords = mesh.coords.astype(np.float32)
    tri = coords[mesh.faces]  # (F, 3, 3)
    mins = np.minimum(np.minimum(tri[:, 0], tri[:, 1]), tri[:, 2])
    maxs = np.maximum(np.maximum(tri[:, 0], tri[:, 1]), tri[:, 2])
    start_y = np.maximum(np.floor((mins[:, 1] - oy) / vs).astype(np.int64), 0)
    end_y = np.minimum(np.ceil((maxs[:, 1] - oy) / vs).astype(np.int64), n)
    start_z = np.maximum(np.floor((mins[:, 2] - oz) / vs).astype(np.int64), 0)
    end_z = np.minimum(np.ceil((maxs[:, 2] - oz) / vs).astype(np.int64), n)
    first = np.searchsorted(planes, start_z)
    last = np.searchsorted(planes, end_z)  # planes [first, last) lie in the window
    keep = np.nonzero((last > first) & (start_y < end_y))[0]

    for f in keep:
        v0, v1, v2 = tri[f]
        normal = np.cross(v1 - v0, v2 - v1)
        sign = np.float32(1.0 if normal[0] >= 0 else -1.0)
        edge0 = v1 - v0
        edge1 = v2 - v0
        A, B, C = np.cross(edge0, edge1).astype(np.float32)
        D = np.float32(A * v0[0] + B * v0[1] + C * v0[2])

        ys = np.arange(start_y[f], end_y[f], dtype=np.int64)
        rows = np.arange(first[f], last[f])
        zs = planes[rows]
        cy = (oy + (ys.astype(np.float32) * vs + vs / np.float32(2)))[None, :]  # (1, Y)
        cz = (oz + (zs.astype(np.float32) * vs + vs / np.float32(2)))[:, None]  # (Z, 1)

        e0 = _edge_zy(v0, v1, cy, cz) * sign
        e1 = _edge_zy(v1, v2, cy, cz) * sign
        e2 = _edge_zy(v2, v0, cy, cz) * sign
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)  # (Z, Y)
        if not inside.any():
            continue

        with np.errstate(divide="ignore", invalid="ignore"):
            intersection = (D - B * cy - C * cz) / A  # (Z, Y) float32
            xf = (intersection - ox) / vs
        valid = inside & np.isfinite(xf) & (xf < n)
        start_x = np.where(valid, np.trunc(np.nan_to_num(xf)).astype(np.int64), n)
        start_x = np.clip(start_x, 0, n)

        zz, yy = np.nonzero(valid)
        for z_i, y_i in zip(zz, yy):
            out[rows[z_i], ys[y_i], start_x[z_i, y_i]:] ^= True

    return out


# ---------------------------------------------------------------------------
# Jump Flooding Algorithm — signed *squared* distance field
# ---------------------------------------------------------------------------

def jfa_ref(occ: np.ndarray, spec: GridSpec, return_positions: bool = False):
    """JFA SDF matching `jfa/sequential.cpp:24-125` + caller init.

    Input: dense bool occupancy [z, y, x].  Output: float32 [z, y, x] signed
    *squared* distances: seeds (surface voxels) are 0, inside is positive,
    outside negative; voxels never reached keep +/-inf. The caller init
    of -inf everywhere is `apps/cli/main.cpp:200`; seed positions are voxel
    *corners* (origin + idx*voxel_size, `jfa/sequential.cpp:31-33`).
    """
    n = spec.n
    ox, oy, oz = (np.float32(v) for v in spec.origin)
    vs = np.float32(spec.voxel_size)
    occ = np.asarray(occ, bool)

    # --- init: occupied voxel with any empty / out-of-grid 26-neighbor -> seed
    padded = np.zeros((n + 2, n + 2, n + 2), dtype=bool)
    padded[1:-1, 1:-1, 1:-1] = occ
    all_neighbors = np.ones_like(occ)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                all_neighbors &= padded[
                    1 + dz : n + 1 + dz, 1 + dy : n + 1 + dy, 1 + dx : n + 1 + dx
                ]
    boundary = occ & ~all_neighbors
    interior = occ & all_neighbors

    sdf = np.full((n, n, n), -np.inf, np.float32)
    sdf[interior] = np.inf
    sdf[boundary] = 0.0

    zz, yy, xx = np.meshgrid(
        np.arange(n, dtype=np.float32),
        np.arange(n, dtype=np.float32),
        np.arange(n, dtype=np.float32),
        indexing="ij",
    )
    px = (ox + xx * vs).astype(np.float32)
    py = (oy + yy * vs).astype(np.float32)
    pz = (oz + zz * vs).astype(np.float32)
    pos = np.zeros((n, n, n, 3), np.float32)
    pos[boundary, 0] = px[boundary]
    pos[boundary, 1] = py[boundary]
    pos[boundary, 2] = pz[boundary]

    # --- flood: k = N/2 ... 1, 26 neighbors at stride k, min squared distance
    def shifted(a, dz, dy, dx, fill):
        out = np.full_like(a, fill)
        src = [slice(None)] * a.ndim
        dst = [slice(None)] * a.ndim
        for ax, d in zip((0, 1, 2), (dz, dy, dx)):
            if d > 0:
                src[ax], dst[ax] = slice(0, a.shape[ax] - d), slice(d, a.shape[ax])
            elif d < 0:
                src[ax], dst[ax] = slice(-d, a.shape[ax]), slice(0, a.shape[ax] + d)
        out[tuple(dst)] = a[tuple(src)]
        return out

    k = n // 2
    while k >= 1:
        best = sdf.copy()
        best_abs = np.abs(sdf)
        best_pos = pos.copy()
        center_sign = np.where(np.signbit(sdf), np.float32(-1.0), np.float32(1.0))
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dz == 0 and dy == 0 and dx == 0:
                        continue
                    nsdf = shifted(sdf, -dz * k, -dy * k, -dx * k, np.inf)
                    npos = shifted(pos, -dz * k, -dy * k, -dx * k, 0.0)
                    valid = np.isfinite(nsdf)
                    d2 = (
                        (px - npos[..., 0]) ** 2
                        + (py - npos[..., 1]) ** 2
                        + (pz - npos[..., 2]) ** 2
                    ).astype(np.float32)
                    better = valid & (d2 < best_abs)
                    best = np.where(better, center_sign * d2, best)
                    best_abs = np.where(better, d2, best_abs)
                    best_pos = np.where(better[..., None], npos, best_pos)
        sdf, pos = best, best_pos
        k //= 2

    if return_positions:
        return sdf, pos
    return sdf


# ---------------------------------------------------------------------------
# CSG booleans (word-wise fold of grid2 into grid1)
# ---------------------------------------------------------------------------

def csg_ref(occ1: np.ndarray, occ2: np.ndarray, op: str) -> np.ndarray:
    """CSG on dense bool grids: `csg/csg.h:14-30` functors.

    union: a|b, intersection: a&b, difference: a & ~b.
    """
    a = np.asarray(occ1, bool)
    b = np.asarray(occ2, bool)
    if op == "union":
        return a | b
    if op == "intersection":
        return a & b
    if op == "difference":
        return a & ~b
    raise ValueError(f"unknown CSG op {op!r}")
