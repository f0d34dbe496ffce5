"""Whole-axis suffix-fill kernel (B2) and the shared slot/tile layout.

Port of the parts of `voxtpu/ops/vox_pallas.py` that the banded and
word-event pipelines use: the tile geometry constants, the batch
layout (`tile_batches`, `tile_flags`, `_gather_batches`), the
supertile size `_group_factor`, and kernel B2, which replaces the Pallas `_pallas_kernel` (`_run_pallas` with
`seg=None`). The banded pipeline routes its x-degenerate candidates
(whose x window does not fit a band) through B2 into a compact
per-touched-tile buffer.

B2 computes, per batch of slots of one tile, the XOR of the suffix
fill masks of the live slots over the whole x axis, packed into
words. The CUDA kernel is `csrc/vox_fill.cu::vt_wide_fill` (one block
per batch, shared-memory atomicXor; see that file for what bounds it
on an H100). Its plain torch version, `wide_fill_plain`, computes the
same words by counting: an `index_add_` of 1 at [cell, x], a
cumulative sum along x, `& 1`, then packing.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import WORD_BITS, pack_bits

TILE_CELLS = 128          # cells (YZ columns) per output tile
TB_SUB, TB_LANE = 4, 128  # slot batch = TB_SUB x 128 panel
FLAG_FIRST = 1            # voxtpu's batch flags: a tile's first batch
FLAG_LAST = 2             # and its last
_LANE_MIN = 128           # voxtpu's output panel width in words
_SMEM_MAX = 232448        # shared memory a block may use on an H100


def tile_batches(bounds: np.ndarray, tb: int):
    """Per-tile batch layout (`vox_pallas.py:209-242`).

    Given per-tile slot ranges `bounds` (num_tiles + 1, from a
    searchsorted over tile-sorted cells) and batch size `tb`, cut each
    active tile's run into ceil(count / tb) batches. Returns
    (batch_tiles, batch_starts, ends); one empty batch on tile 0 for an
    empty slot set. voxtpu's version also returns the FIRST/LAST flags
    and tile mask of its sequential TPU grid, which the CUDA kernel
    does not need."""
    counts = np.diff(bounds)
    active = np.nonzero(counts)[0]
    nb = -(-counts[active] // tb)
    batch_tiles = np.repeat(active, nb).astype(np.int64)
    first = np.repeat(np.cumsum(nb) - nb, nb)
    batch_starts = (bounds[batch_tiles]
                    + (np.arange(len(batch_tiles)) - first) * tb).astype(np.int64)
    if not len(batch_tiles):
        batch_tiles = np.zeros(1, np.int64)
        batch_starts = np.zeros(1, np.int64)
    ends = np.minimum(batch_starts + tb, bounds[batch_tiles + 1])
    return batch_tiles, batch_starts, ends


def tile_flags(bounds: np.ndarray, batch_tiles: np.ndarray):
    """voxtpu's FIRST/LAST flags and tile mask of `tile_batches`' layout
    (`vox_pallas.py:209-242`): a tile's batches are consecutive, the
    first flagged FLAG_FIRST, the last FLAG_LAST (the one batch of an
    empty layout both); the mask marks tiles that hold work. The CUDA
    kernels do not read them: they drive voxtpu's sequential TPU grid,
    and the word-event plan keeps them so that its arrays equal
    voxtpu's."""
    bt = np.asarray(batch_tiles)
    first = np.concatenate([[True], bt[1:] != bt[:-1]])
    last = np.concatenate([bt[:-1] != bt[1:], [True]])
    flags = (first * FLAG_FIRST + last * FLAG_LAST).astype(np.int32)
    return flags, np.diff(bounds) > 0


def _group_factor(num_words: int, num_tiles: int) -> int:
    """Sub-tiles packed side by side in one 128-word output panel, a
    supertile (`vox_pallas_we.py:139-151`): 128 // num_words, rounded
    down to a divisor of num_tiles (N = 96: 72 tiles, 42 lanes allow
    36), 1 from N = 4096."""
    g = max(1, min(_LANE_MIN // num_words, num_tiles))
    while num_tiles % g:
        g -= 1
    return g


def _gather_batches(values: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor, *, tb: int, fill: int) -> torch.Tensor:
    """(B, tb) panels of a sorted per-item array on its device
    (`vox_pallas.py:196-206`): batch b holds items [starts[b], ends[b]),
    `fill` in the lanes past its end. voxtpu gathers two arrays per
    call; the port one, with its own fill."""
    idx = starts.view(-1, 1).long() + torch.arange(tb, device=starts.device)
    in_range = idx < ends.view(-1, 1)
    idx = idx.clamp(0, max(values.shape[0] - 1, 0))
    got = values[idx] if values.shape[0] else torch.zeros_like(idx, dtype=values.dtype)
    return torch.where(in_range, got, torch.full_like(got, fill))


def suffix_parity_words(cells: torch.Tensor, xs: torch.Tensor,
                        num_cells: int, n: int) -> torch.Tensor:
    """Plain form of the suffix fill: (num_cells, n/32) int32 words whose
    bit x of cell c is the parity of the fragments (c, x') with x' <= x.
    `cells` and `xs` list the live fragments only."""
    count = torch.zeros((num_cells, n), dtype=torch.int32, device=cells.device)
    count.view(-1).index_add_(0, cells.long() * n + xs.long(),
                              torch.ones_like(cells, dtype=torch.int32))
    parity = torch.cumsum(count, dim=1, dtype=torch.int32) & 1
    return pack_bits(parity.bool())


def _check_slots(local, xs, batch_tile) -> tuple[int, int]:
    _build.expect(local, "local", torch.int32, (None, None, TB_LANE))
    _build.expect(xs, "xs", torch.int32, tuple(local.shape))
    _build.expect(batch_tile, "batch_tile", torch.int32, (local.shape[0],))
    num_batches, tb = local.shape[0], local.shape[1] * local.shape[2]
    if tb > 1024:
        raise ValueError(f"batch of {tb} slots exceeds one block (1024)")
    return num_batches, tb


def _check_window(tc: int, bwords: int) -> None:
    """The kernel keeps two (tc, bwords + 1) word arrays in shared
    memory, at most 227 KB a block on an H100."""
    if 2 * tc * (bwords + 1) * 4 > _SMEM_MAX:
        raise ValueError(f"tc={tc} x {bwords} words exceeds one block's "
                         f"shared memory ({_SMEM_MAX} bytes)")


def _check_range(a: np.ndarray, name: str, lo: int, hi: int) -> None:
    """Check a host plan array once, when the plan is built: every value
    must lie in [lo, hi). The wrappers do not check the tensors they are
    given (that would wait for the card on every call); the kernels skip
    a batch whose tile or band lies outside the output."""
    if a.size and (a.min() < lo or a.max() >= hi):
        raise ValueError(f"{name} values [{a.min()}, {a.max()}] outside [{lo}, {hi})")


def wide_fill_plain(local: torch.Tensor, xs: torch.Tensor,
                    batch_tile: torch.Tensor, *, n: int, tc: int,
                    num_tiles: int) -> torch.Tensor:
    """Plain torch version of B2 (any device)."""
    live = (local >= 0) & (local < tc) & (xs >= 0) & (xs < n)
    cells = batch_tile[:, None, None] * tc + local
    words = suffix_parity_words(cells[live], xs[live], num_tiles * tc, n)
    return words.view(num_tiles, tc, n // WORD_BITS)


def wide_fill(local: torch.Tensor, xs: torch.Tensor, batch_tile: torch.Tensor,
              *, n: int, tc: int, num_tiles: int) -> torch.Tensor:
    """B2: whole-axis suffix fill of (B, tb_sub, 128) slots (local cell,
    x entry; local -1 = inert) of batches on compact tiles
    `batch_tile` -> (num_tiles, tc, n/32) int32 words.

    `batch_tile` must lie in [0, num_tiles); it is not checked here. The
    kernel skips a batch outside that range.

    Replaces voxtpu/ops/vox_pallas.py::_pallas_kernel. A CPU tensor
    takes the plain version, a CUDA tensor launches the kernel."""
    num_batches, tb = _check_slots(local, xs, batch_tile)
    if n % WORD_BITS:
        raise ValueError(f"N % {WORD_BITS} != 0 (n={n})")
    if not _build.on_cuda(local, xs, batch_tile):
        return wide_fill_plain(local, xs, batch_tile, n=n, tc=tc,
                               num_tiles=num_tiles)
    nw = n // WORD_BITS
    _check_window(tc, nw)
    out = torch.zeros((num_tiles, tc, nw), dtype=torch.int32, device=local.device)
    if num_batches:
        _build.launch("vt_wide_fill", local.data_ptr(), xs.data_ptr(),
                      batch_tile.data_ptr(), num_batches, tb, tc, nw,
                      num_tiles, out.data_ptr(), _build.stream_of(out))
        wide_fill.launches += 1
    return out


wide_fill.launches = 0
