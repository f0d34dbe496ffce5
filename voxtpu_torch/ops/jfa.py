"""Jump Flooding SDF — seed init and dispatch.

Port of the packed-seed parts of `voxtpu/ops/jfa.py`: `_boundary_mask`,
`jfa_init_seed` (torch ops) and the `jfa()` entry point.

Output contract (== the reference, `jfa/sequential.cpp:24-125`):
float32 signed **squared** world distance in [z, y, x] order; surface
seeds 0, interior positive, exterior negative; unreached voxels keep
+/-inf. Seeds are one int32 grid of 10-bit (z, y, x) fields, -1 where
no seed is known, so N <= 1024. voxtpu's wide (hi, lo) encoding for
larger grids is not ported yet.

Backends: ``"reference"`` (the NumPy oracle), ``"cuda"`` (the flood
of `ops/jfa_cuda.py`: kernels on CUDA tensors, their plain torch
versions on the CPU; `pipe` or `JFA_PIPE=1` selects voxtpu's
pipelined step B6) and ``"plain"`` (voxtpu's ``"xla"``: the same
flood through the plain versions on the grid's device).
"""

from __future__ import annotations

import torch

from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid

BACKENDS = ("reference", "plain", "cuda")

_OFFSETS = tuple(
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if not (dz == 0 and dy == 0 and dx == 0)
)

_NO_SEED = -1
_MAX_PACKED_N = 1024  # 10-bit seed fields


def _boundary_mask(occ: torch.Tensor) -> torch.Tensor:
    """Occupied voxels with >= 1 empty or out-of-grid 26-neighbor
    (reference seed rule, `jfa/sequential.cpp:24-64`)."""
    n0, n1, n2 = occ.shape
    padded = torch.zeros((n0 + 2, n1 + 2, n2 + 2), dtype=torch.bool,
                         device=occ.device)
    padded[1:-1, 1:-1, 1:-1] = occ
    all_n = torch.ones_like(occ)
    for dz, dy, dx in _OFFSETS:
        all_n &= padded[1 + dz:n0 + 1 + dz, 1 + dy:n1 + 1 + dy,
                        1 + dx:n2 + 1 + dx]
    return occ & ~all_n


def jfa_init_seed(occ: torch.Tensor) -> torch.Tensor:
    """The flood state: one packed int32 seed grid, (z << 20 | y << 10 |
    x) at boundary voxels, -1 elsewhere."""
    n = occ.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=occ.device)
    packed = ((idx.view(n, 1, 1) << 20) | (idx.view(1, n, 1) << 10)
              | idx.view(1, 1, n))
    return torch.where(_boundary_mask(occ), packed,
                       torch.full_like(packed, _NO_SEED))


def jfa(grid: VoxelGrid | torch.Tensor, spec: GridSpec | None = None,
        backend: str = "cuda", pipe: bool | None = None) -> torch.Tensor:
    """Signed squared distance field of an occupancy grid, on the grid's
    device. Accepts a packed VoxelGrid or a dense bool tensor (+ spec).

    `pipe` (``"cuda"`` only) takes voxtpu's pipelined flood step B6
    where it applies (`ops/jfa_cuda.py`); None reads `JFA_PIPE` there,
    as voxtpu's `jfa_pallas` does."""
    if pipe and backend != "cuda":
        raise ValueError(f"pipe=True needs backend 'cuda', not {backend!r}")
    if isinstance(grid, VoxelGrid):
        occ = grid.to_dense()
        spec = grid.spec() if spec is None else spec
    else:
        occ = grid.bool()
        if spec is None:
            raise ValueError("spec required for dense input")
    if backend == "reference":
        from voxtpu_torch.ops.reference import jfa_ref

        return torch.from_numpy(jfa_ref(occ.cpu().numpy(), spec)).to(occ.device)
    if backend == "cuda":
        from voxtpu_torch.ops.jfa_cuda import jfa_cuda

        return jfa_cuda(occ, spec, pipe=pipe)
    if backend == "plain":
        from voxtpu_torch.ops.jfa_cuda import jfa_plain

        return jfa_plain(occ, spec)
    raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
