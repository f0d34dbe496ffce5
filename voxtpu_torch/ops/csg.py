"""CSG booleans on voxel grids.

Port of `voxtpu/ops/csg.py`. Hard: word-wise ``a | b``, ``a & b``,
``a & ~b`` on packed int32 words (the reference functors,
`csg/csg.h:14-30`), one memory-bound elementwise pass, on one of
voxtpu's four backends: ``"plain"`` (voxtpu's xla: torch ops on the
grids' device), ``"cuda"`` (voxtpu's pallas, which aliases to xla: the
same torch ops, as voxtpu has nothing for a hand-written kernel to
improve on one fused word-wise op), ``"reference"`` (NumPy on the host,
the oracle) or ``"native"`` (voxtpu's C++/OpenMP fold on the host,
`voxtpu_torch/native`); the last two put the words back on the grids'
device. Soft
(differentiable, on float occupancy in [0, 1]): max / min, whose
gradient splits a tie 0.5 / 0.5, as jnp.maximum / jnp.minimum do.
Torch ops on any device.
"""

from __future__ import annotations

import torch

from voxtpu_torch.grids.voxel_grid import VoxelGrid

_WORD_OPS = {
    "union": lambda a, b: a | b,
    "intersection": lambda a, b: a & b,
    "difference": lambda a, b: a & ~b,
}


BACKENDS = ("plain", "cuda", "reference", "native")


def csg(grid1: VoxelGrid, grid2: VoxelGrid, op: str, backend: str = "plain") -> VoxelGrid:
    """Fold grid2 into grid1 (returns a new grid; shapes and devices must
    match, as the reference asserts at `csg/naive.cu:30-33`)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    if op == "void":
        return grid1
    if op not in _WORD_OPS:
        raise ValueError(f"unknown CSG op {op!r}")
    if grid1.words.shape != grid2.words.shape:
        raise ValueError(
            f"CSG grids must have equal shape: {tuple(grid1.words.shape)} vs "
            f"{tuple(grid2.words.shape)}")
    if backend == "native":
        from voxtpu_torch.native import native_csg

        host = native_csg(grid1.words.cpu().numpy(), grid2.words.cpu().numpy(), op)
        words = torch.from_numpy(host).to(grid1.words.device)
    elif backend == "reference":
        host = _WORD_OPS[op](grid1.words.cpu().numpy(), grid2.words.cpu().numpy())
        words = torch.from_numpy(host).to(grid1.words.device)
    else:
        words = _WORD_OPS[op](grid1.words, grid2.words)
    return VoxelGrid(words=words, origin=grid1.origin,
                     voxel_size=grid1.voxel_size)


def soft_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def soft_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, b)


def soft_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, 1.0 - b)


SOFT_OPS = {
    "union": soft_union,
    "intersection": soft_intersection,
    "difference": soft_difference,
}


def soft_csg(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """Differentiable CSG on float occupancy grids in [0, 1]."""
    if op == "void":
        return a
    if op not in SOFT_OPS:
        raise ValueError(f"unknown CSG op {op!r}")
    return SOFT_OPS[op](a, b)
