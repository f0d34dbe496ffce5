"""Solid voxelization — host windows, the edge function, and dispatch.

Port of the parts of `voxtpu/ops/vox.py` that the port's voxelizer
uses: `_triangle_windows` (per-triangle YZ raster windows, NumPy),
`_edge_zy` (the reference edge function, any array type) and the
`voxelize()` entry point. Semantics are the reference's parity
voxelizer (`vox/sequential.cpp:18-61`): per covered YZ cell, XOR-toggle
the x row from the plane intersection to the +x edge.

Backends:

- ``"reference"``: the NumPy oracle (`ops/reference.py`), packed on
  the requested device.
- ``"cuda"``: the banded slot pipeline (`ops/vox_slots_banded.py`),
  the pipeline voxtpu's benchmark headlines. On CUDA tensors it runs
  the hand-written kernels; on the CPU their plain torch versions.
  (voxtpu's own ``-t 2`` routes to its word-event kernel instead; both
  pipelines produce the same grid bit for bit.)
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid
from voxtpu_torch.mesh.mesh import Mesh

BACKENDS = ("reference", "cuda")


def _triangle_windows(mesh: Mesh, spec: GridSpec):
    """Per-triangle raster window (start_y, start_z, w) in voxel units."""
    v0, v1, v2 = mesh.triangle_vertices()
    oy, oz = np.float32(spec.origin[1]), np.float32(spec.origin[2])
    vs = np.float32(spec.voxel_size)
    min_y = np.minimum(np.minimum(v0[:, 1], v1[:, 1]), v2[:, 1])
    max_y = np.maximum(np.maximum(v0[:, 1], v1[:, 1]), v2[:, 1])
    min_z = np.minimum(np.minimum(v0[:, 2], v1[:, 2]), v2[:, 2])
    max_z = np.maximum(np.maximum(v0[:, 2], v1[:, 2]), v2[:, 2])
    start_y = np.floor((min_y - oy) / vs).astype(np.int32)
    end_y = np.ceil((max_y - oy) / vs).astype(np.int32)
    start_z = np.floor((min_z - oz) / vs).astype(np.int32)
    end_z = np.ceil((max_z - oz) / vs).astype(np.int32)
    start_y = np.clip(start_y, 0, spec.n)
    end_y = np.clip(end_y, 0, spec.n)
    start_z = np.clip(start_z, 0, spec.n)
    end_z = np.clip(end_z, 0, spec.n)
    w = np.maximum(end_y - start_y, end_z - start_z)
    return v0, v1, v2, start_y, start_z, w


def _window_classes(wmax: int) -> list[int]:
    """Window-class ladder 1,2,3,4,6,8,12,16,24,... (pow2 + 1.5*pow2),
    covering [1, wmax] (`voxtpu/ops/vox.py:71-81`)."""
    classes = [1, 2, 3]
    c = 4
    while classes[-1] < wmax:
        classes += [c, c + c // 2]
        c *= 2
    return classes


class FragmentPlan:
    """Triangle buckets of one (mesh, grid) pair, host NumPy.

    The container of voxtpu's `FragmentPlan` (`voxtpu/ops/vox.py:84`):
    `spec`, `buckets` and `num_fragments`. `make_soft_plan` fills it;
    each bucket is ``(W, None, None, None, start_y, start_z,
    face_index)`` with int32 rows padded by `_pad_granular`, so that the
    tests compare it with voxtpu's bucket for bucket."""

    spec: GridSpec
    buckets: list
    num_fragments: int


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pad_granular(count: int) -> int:
    """Row padding at 1/8-octave granularity: <= 12.5% waste, few
    distinct shapes (`voxtpu/ops/vox.py:130-135`)."""
    gran = max(256, _next_pow2(count) // 8)
    return -(-count // gran) * gran


def _pad_rows(a: np.ndarray, rows: int, fill=0):
    if a.shape[0] == rows:
        return a
    pad = np.full((rows - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _edge_zy(py, pz, qy, qz, y, z):
    """Reference edge function `vplib/src/vox/vox.h:22-24` (float32).

    Component form of ``(z - p[2]) * (q[1] - p[1]) - (y - p[1]) *
    (q[2] - p[2])``, same evaluation order as the reference: each
    operation rounds on its own (the oracle's bit-parity contract)."""
    return (z - pz) * (qy - py) - (y - py) * (qz - pz)


def voxelize(mesh: Mesh, spec: GridSpec, backend: str = "cuda", *,
             device, plan=None) -> VoxelGrid:
    """Solid-voxelize `mesh` into a packed VoxelGrid on `device`.

    `plan` is a prebuilt `BandedSlotVoxPipeline` for the ``"cuda"``
    backend (its device and spec must match)."""
    spec.num_words  # packed output: raises early unless N % 32 == 0
    device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
    if plan is not None:
        if plan.spec != spec:
            raise ValueError(
                f"plan was built for {plan.spec}, not the requested {spec}")
        if plan.device != device:
            raise ValueError(
                f"plan lives on {plan.device}, not the requested {device}")
    if backend == "reference":
        from voxtpu_torch.ops.reference import voxelize_ref

        occ = torch.from_numpy(voxelize_ref(mesh, spec)).to(device)
        return VoxelGrid.from_dense(occ, spec)
    if backend == "cuda":
        from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

        if plan is None:
            plan = BandedSlotVoxPipeline(mesh, spec, device)
        return plan()
    raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
