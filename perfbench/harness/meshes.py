"""The benchmark's meshes, made from numbers and the seed alone.

Copies of the port's procedural generators (`revolve`, `washer`,
`torus`, `subdivide`, `subdivide_to`) and of the smoke run's fixed
rotation, so that the inputs are the benchmark's own: a later change to
the program's generators cannot change what is measured. Each mesh is
`(coords (V, 3) float32, faces (F, 3) int32)`.

A configuration names its mesh as a dict (`make_mesh`):
``{"shape": "washer" | "torus", ...the generator's sizes..., "faces":
F, "rotate": [ax, ay, az] (optional), "shift": [dx, dy, dz]
(optional)}``.
"""

from __future__ import annotations

import numpy as np


def revolve(rho, z, nu: int, center=(0.0, 0.0, 0.0)):
    """Surface of revolution of a closed (rho, z) profile, counter-clockwise,
    around the z axis: `nu` segments, 2 * nu * len(rho) outward faces."""
    nv = len(rho)
    u = 2.0 * np.pi * np.arange(nu) / nu
    r = np.asarray(rho, np.float64)[None, :]
    coords = np.stack([
        r * np.cos(u)[:, None],
        r * np.sin(u)[:, None],
        np.broadcast_to(np.asarray(z, np.float64)[None, :], (nu, nv)),
    ], axis=-1).reshape(-1, 3) + np.asarray(center)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    i1, j1 = (i + 1) % nu, (j + 1) % nv
    p00, p10 = i * nv + j, i1 * nv + j
    p11, p01 = i1 * nv + j1, i * nv + j1
    faces = np.concatenate([
        np.stack([p00, p10, p11], -1).reshape(-1, 3),
        np.stack([p00, p11, p01], -1).reshape(-1, 3),
    ])
    return coords.astype(np.float32), faces.astype(np.int32)


def washer(inner: float, outer: float, height: float, nu: int):
    """A flat ring around the z axis: 8 * nu faces; its caps lie in
    planes z = const (x-parallel faces)."""
    h = height / 2.0
    return revolve(np.array([outer, outer, inner, inner]), np.array([-h, h, h, -h]), nu)


def torus(major: float, minor: float, nu: int, nv: int):
    """A torus around the z axis: 2 * nu * nv faces."""
    v = 2.0 * np.pi * np.arange(nv) / nv
    return revolve(major + minor * np.cos(v), minor * np.sin(v), nu)


def subdivide(coords, faces, times: int):
    """Midpoint 1:4 subdivision, `times` times (no vertex sharing)."""
    for _ in range(times):
        v0, v1, v2 = coords[faces[:, 0]], coords[faces[:, 1]], coords[faces[:, 2]]
        base, f = coords.shape[0], faces.shape[0]
        coords = np.concatenate([coords, (v0 + v1) / 2, (v1 + v2) / 2,
                                 (v2 + v0) / 2]).astype(np.float32)
        i01 = base + np.arange(f)
        i12 = base + f + np.arange(f)
        i20 = base + 2 * f + np.arange(f)
        faces = np.concatenate([
            np.stack([faces[:, 0], i01, i20], 1),
            np.stack([i01, faces[:, 1], i12], 1),
            np.stack([i20, i12, faces[:, 2]], 1),
            np.stack([i01, i12, i20], 1),
        ]).astype(np.int32)
    return coords, faces


def subdivide_to(coords, faces, target: int):
    """Exactly `target` faces: 1:4 subdivisions while they fit, then
    centroid trisection and longest-edge bisection of the first faces."""
    while faces.shape[0] * 4 <= target:
        coords, faces = subdivide(coords, faces, 1)
    extra = target - faces.shape[0]
    if extra < 0 or extra > 2 * faces.shape[0]:
        raise ValueError(f"cannot reach {target} faces from {faces.shape[0]}")
    nf = faces.shape[0]
    if extra > nf:
        s = extra - nf
        cen = coords[faces[:s]].mean(axis=1).astype(np.float32)
        m = coords.shape[0] + np.arange(s)
        coords = np.concatenate([coords, cen]).astype(np.float32)
        a, b, c = faces[:s, 0], faces[:s, 1], faces[:s, 2]
        faces = np.concatenate([np.stack([a, b, m], 1), np.stack([b, c, m], 1),
                                np.stack([c, a, m], 1), faces[s:]]).astype(np.int32)
        extra = target - faces.shape[0]
    if extra:
        tri = coords[faces[:extra]]
        e = np.stack([((tri[:, 0] - tri[:, 1]) ** 2).sum(1),
                      ((tri[:, 1] - tri[:, 2]) ** 2).sum(1),
                      ((tri[:, 2] - tri[:, 0]) ** 2).sum(1)], 1)
        i0 = e.argmax(1)
        rows = np.arange(extra)
        a = faces[rows, i0]
        b = faces[rows, (i0 + 1) % 3]
        c = faces[rows, (i0 + 2) % 3]
        m = coords.shape[0] + rows
        coords = np.concatenate([coords, (coords[a] + coords[b]) / 2]).astype(np.float32)
        faces = np.concatenate([np.stack([a, m, c], 1), np.stack([m, b, c], 1),
                                faces[extra:]]).astype(np.int32)
    if faces.shape[0] != target:
        raise AssertionError(f"reached {faces.shape[0]} faces, not {target}")
    return coords, faces


def rotation(ax: float, ay: float, az: float) -> np.ndarray:
    """Rz(az) @ Ry(ay) @ Rx(ax), float64."""
    cx, sx, cy, sy, cz, sz = (np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay),
                              np.cos(az), np.sin(az))
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def axis_rotation(axis, angle: float) -> np.ndarray:
    """The rotation by `angle` radians about the unit vector `axis`
    (Rodrigues), float64."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def make_mesh(spec: dict):
    """The configuration's mesh: (coords float32, faces int32)."""
    shape = spec["shape"]
    if shape == "washer":
        c, f = washer(spec["inner"], spec["outer"], spec["height"], spec["nu"])
    elif shape == "torus":
        c, f = torus(spec["major"], spec["minor"], spec["nu"], spec["nv"])
    else:
        raise ValueError(f"unknown mesh shape {shape!r}")
    c, f = subdivide_to(c, f, int(spec["faces"]))
    if "rotate" in spec:
        c = (c.astype(np.float64) @ rotation(*spec["rotate"]).T).astype(np.float32)
    if "shift" in spec:
        c = (c + np.asarray(spec["shift"], np.float64)).astype(np.float32)
    return c, f


def rigid_motion(coords: np.ndarray, rng: np.random.Generator, max_deg: float,
                 max_shift: float) -> np.ndarray:
    """`coords` turned by at most `max_deg` degrees about a random axis
    through their centroid and moved by at most `max_shift` (world units)
    along each axis, float32; the draws come from `rng`."""
    axis = rng.normal(size=3)
    angle = np.deg2rad(rng.uniform(-max_deg, max_deg))
    shift = rng.uniform(-max_shift, max_shift, size=3)
    c64 = coords.astype(np.float64)
    mid = c64.mean(axis=0)
    return ((c64 - mid) @ axis_rotation(axis, angle).T + mid + shift).astype(np.float32)


def seeded_start(coords: np.ndarray, rng: np.random.Generator, voxel: float,
                 shift_vox, jitter_vox: float) -> np.ndarray:
    """A fit's start: `coords` moved by `shift_vox` voxels plus
    N(0, `jitter_vox` voxels) on each coordinate, float32."""
    return (coords + np.float32(voxel) * np.asarray(shift_vox, np.float32)
            + rng.normal(0.0, jitter_vox * voxel, coords.shape)).astype(np.float32)
