"""CSG booleans on voxel grids.

Port of `voxtpu/ops/csg.py`. Hard: word-wise ``a | b``, ``a & b``,
``a & ~b`` on packed int32 words (the reference functors,
`csg/csg.h:14-30`), one memory-bound elementwise pass. Soft
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


def csg(grid1: VoxelGrid, grid2: VoxelGrid, op: str) -> VoxelGrid:
    """Fold grid2 into grid1 (returns a new grid; shapes and devices must
    match, as the reference asserts at `csg/naive.cu:30-33`)."""
    if op == "void":
        return grid1
    if op not in _WORD_OPS:
        raise ValueError(f"unknown CSG op {op!r}")
    if grid1.words.shape != grid2.words.shape:
        raise ValueError(
            f"CSG grids must have equal shape: {tuple(grid1.words.shape)} vs "
            f"{tuple(grid2.words.shape)}")
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
