"""Bit-packed voxel occupancy grid on a torch device.

Port of `voxtpu/grids/voxel_grid.py`. Layout is the same: ``words[z,
y, xw]`` where bit ``b`` of word ``xw`` is voxel ``x = 32*xw + b``,
N % 32 == 0 for the packed form.

Words are stored as ``torch.int32``, bit-identical to voxtpu's
``uint32`` (``np.ndarray.view``): torch on the CPU has no ``~``,
``<<`` or ``>>`` for uint32, and int32 ``>>`` is arithmetic, so every
right shift here is masked (``(w >> b) & 1``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from voxtpu_torch.utils.trace import span

WORD_BITS = 32


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry: N voxels/side, world origin, voxel size.

    ``voxel_size = longest_bbox_side / N``, origin = bbox min corner
    (the reference CLI's grid fit, `apps/cli/main.cpp:77-87`); `fit`
    runs in the host span ``grid.fit`` (count ``points``)."""

    n: int
    origin: Tuple[float, float, float]
    voxel_size: float

    @staticmethod
    def fit(coords: np.ndarray, n: int) -> "GridSpec":
        from voxtpu_torch.mesh.bounding_box import calculate_bounding_box

        with span("grid.fit") as sp:
            side, (mins, _) = calculate_bounding_box(coords)
            sp.count("points", np.size(coords) // 3)
        return GridSpec(n=int(n), origin=tuple(float(v) for v in mins),
                        voxel_size=side / n)

    @property
    def num_words(self) -> int:
        if self.n % WORD_BITS != 0:
            raise ValueError(f"packed grids require N % {WORD_BITS} == 0, got {self.n}")
        return self.n // WORD_BITS

    def origin_tensor(self, device) -> torch.Tensor:
        """(ox, oy, oz) as float32 on `device`."""
        return torch.tensor(self.origin, dtype=torch.float32, device=device)

    def voxel_size_tensor(self, device) -> torch.Tensor:
        """voxel_size as a float32 scalar on `device`."""
        return torch.tensor(self.voxel_size, dtype=torch.float32, device=device)


@dataclasses.dataclass
class VoxelGrid:
    """words: (N, N, N/32) int32 in [z, y, x-word] order + geometry."""

    words: torch.Tensor
    origin: torch.Tensor      # (3,) float32  (ox, oy, oz)
    voxel_size: torch.Tensor  # () float32

    @classmethod
    def zeros(cls, spec: GridSpec, device) -> "VoxelGrid":
        return cls(
            words=torch.zeros((spec.n, spec.n, spec.num_words), dtype=torch.int32,
                              device=device),
            origin=spec.origin_tensor(device),
            voxel_size=spec.voxel_size_tensor(device),
        )

    @classmethod
    def from_dense(cls, occ: torch.Tensor, spec: GridSpec) -> "VoxelGrid":
        return cls(words=pack_bits(occ), origin=spec.origin_tensor(occ.device),
                   voxel_size=spec.voxel_size_tensor(occ.device))

    @property
    def n(self) -> int:
        return self.words.shape[0]

    def to_dense(self) -> torch.Tensor:
        """Unpack to a boolean (N, N, N) grid in [z, y, x] order."""
        return unpack_bits(self.words)

    def count(self) -> int:
        """Number of set voxels (popcount over all words, in chunks:
        `packed_popcount`)."""
        return packed_popcount(self.words)

    def spec(self) -> GridSpec:
        return GridSpec(n=self.n,
                        origin=tuple(float(v) for v in self.origin.tolist()),
                        voxel_size=float(self.voxel_size))


def pack_bits(occ: torch.Tensor) -> torch.Tensor:
    """(..., N) bool [z, y, x] -> (..., N/32) int32 words."""
    n = occ.shape[-1]
    if n % WORD_BITS != 0:
        raise ValueError(f"packed grids require N % {WORD_BITS} == 0, got {n}")
    bits = occ.reshape(*occ.shape[:-1], n // WORD_BITS, WORD_BITS)
    words = torch.zeros(bits.shape[:-1], dtype=torch.int32, device=occ.device)
    for b in range(WORD_BITS):
        # int32 << 31 sets the sign bit: the uint32 word's bit 31.
        words |= bits[..., b].to(torch.int32) << b
    return words


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., Nw) int32 words -> (..., Nw*32) bool."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1   # masked: >> is arithmetic
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS).bool()


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts (int64), SWAR on the unsigned value."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


# ---------------------------------------------------------------------------
# Checks that stay packed: a 4096^3 grid is 2^31 words (8 GiB); unpacked
# it would take 64 GiB, and one int64 temporary of its size 16 GiB. These
# walk the words in chunks of CHECK_CHUNK.
# ---------------------------------------------------------------------------

CHECK_CHUNK = 1 << 24  # words a chunk of the packed checks (64 MiB of int32)
_MASK32 = 0xFFFFFFFF


def _chunks(words: torch.Tensor):
    flat = words.reshape(-1)
    for i in range(0, flat.shape[0], CHECK_CHUNK):
        yield i, flat[i:i + CHECK_CHUNK]


def packed_popcount(words: torch.Tensor) -> int:
    """Set bits of an int32 word tensor, summed a chunk at a time."""
    total = torch.zeros((), dtype=torch.int64, device=words.device)
    for _, w in _chunks(words):
        total += popcount32(w).sum()
    return int(total)


def xor_popcount(a: torch.Tensor, b: torch.Tensor) -> int:
    """Set bits of a ^ b over two int32 word tensors of one shape (the
    voxels where two packed grids differ), a chunk at a time."""
    if a.shape != b.shape:
        raise ValueError(f"grids of shapes {tuple(a.shape)} and {tuple(b.shape)}")
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    for (_, w), (_, v) in zip(_chunks(a), _chunks(b)):
        total += popcount32(w ^ v).sum()
    return int(total)


def grid_digest(words: torch.Tensor) -> tuple[int, int, int]:
    """voxtpu's order-robust packed-grid digest (`bench.py:395-419`):
    (total popcount, sum of w * m1, sum of w * m2), each mod 2^32, over
    the (n, n, nw) words w as uint32 at flat position pos = row * nw +
    word, with m1 = pos * 2654435761 | 1 and m2 = (pos ^ 0x9E3779B9) *
    0x85EBCA6B | 1 (mod 2^32). Any one differing word changes h1 and h2
    (odd multipliers are units mod 2^32), so two grids that cannot be
    held at once are compared by their digests.

    In int64, a chunk at a time: products and sums wrap mod 2^64, which
    keeps their low 32 bits."""
    pop = h1 = h2 = torch.zeros((), dtype=torch.int64, device=words.device)
    for i, w in _chunks(words):
        pos = torch.arange(i, i + w.shape[0], dtype=torch.int64, device=words.device)
        u = w.to(torch.int64) & _MASK32
        m1 = ((pos * 2654435761) & _MASK32) | 1
        m2 = (((pos ^ 0x9E3779B9) * 0x85EBCA6B) & _MASK32) | 1
        pop = pop + popcount32(w).sum()
        h1 = (h1 + ((u * m1) & _MASK32).sum()) & _MASK32
        h2 = (h2 + ((u * m2) & _MASK32).sum()) & _MASK32
    return int(pop) & _MASK32, int(h1), int(h2)
