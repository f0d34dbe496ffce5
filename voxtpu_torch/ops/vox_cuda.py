"""Whole-axis suffix-fill kernel (B2), the shared slot/tile layout and
voxtpu's suffix-kernel route.

Port of `voxtpu/ops/vox_pallas.py`: the tile geometry constants, the
batch layout (`tile_batches`, `tile_flags`, `_gather_batches`), the
supertile size `_group_factor`, kernel B2, which replaces the Pallas
`_pallas_kernel` (`_run_pallas` with `seg=None`), and `PallasVoxPlan`,
the sorted-fragment layout with which voxtpu forces its suffix kernel
(`suffix_words`, on B2). The banded pipeline routes its x-degenerate
candidates (whose x window does not fit a band) through B2 into the
grid's touched tiles; `vox_slots.SlotVoxPipeline` fills every tile with
it.

B2 computes, per batch of slots of one tile, the XOR of the suffix
fill masks of the live slots over the whole x axis, packed into
words. The CUDA kernel is `csrc/vox_fill.cu::vt_wide_fill`, B1's kernel
over whole rows: a thread-block cluster a tile, whose blocks share the
tile's batches and XOR-reduce their rows through distributed shared
memory (see that file). `wide_fill` writes a compact buffer;
`wide_fill_into` XORs the same words into a grid through the compact ->
grid tile map, which is how the banded pipeline runs it. Its plain
torch version, `wide_fill_plain`, computes the same words by counting:
an `index_add_` of 1 at [cell, x], a cumulative sum along x, `& 1`,
then packing.

Both fill kernels need each tile's batches to be consecutive:
`batch_tile` must be non-decreasing. A plan checks that once, when it
is built, and keeps a `FillLayout` (each tile's batch range and the
cluster size); a wrapper called without one builds it the same way from
a host copy of `batch_tile`, which waits for the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import WORD_BITS, GridSpec, pack_bits
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox import FragmentPlan, fragments_from_plan

TILE_CELLS = 128          # cells (YZ columns) per output tile
TB_SUB, TB_LANE = 4, 128  # slot batch = TB_SUB x 128 panel
FLAG_FIRST = 1            # voxtpu's batch flags: a tile's first batch
FLAG_LAST = 2             # and its last
_LANE_MIN = 128           # voxtpu's output panel width in words
_SMEM_MAX = 232448        # shared memory a block may use on an H100
_SMEM_SM = 233472         # an H100 multiprocessor's shared memory
_SMEM_RESERVED = 1024     # of which each resident block reserves this much
CLUSTER_MAX = 16          # blocks a fill kernel's cluster may hold (H100)
BATCHES_PER_BLOCK = 16    # a fill cluster's blocks: about this many batches of a busy tile each
REGISTER_BLOCKS = 2       # fill blocks an SM's registers hold (512 threads, 64 registers)
H100_SMS = 132


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
    return local.shape[0], local.shape[1] * local.shape[2]


def fill_rows(nw: int, tc: int) -> tuple[int, int]:
    """How a fill kernel keeps a tile's whole rows in shared memory (a
    cell's nw words and its ceil(nw / 32) marker words, in 16-byte
    units), as `csrc/vox_fill.cu::launch_fill` works it out: the tile's
    cells in `groups` groups, each a cluster's, and the bytes a block
    takes -> (groups, bytes). Raises where one row does not fit a block
    (at most 227 KB on an H100)."""
    row = nw + -(-nw // WORD_BITS)
    cells = tc
    while cells > 1 and (cells * row + 3) // 4 * 16 > _SMEM_MAX:
        cells = (cells + 1) // 2
    if (cells * row + 3) // 4 * 16 > _SMEM_MAX:
        raise ValueError(f"a row of {nw} words exceeds one block's shared memory "
                         f"({_SMEM_MAX} bytes)")
    groups = -(-tc // cells)
    return groups, (-(-tc // groups) * row + 3) // 4 * 16


def _check_sorted(a: np.ndarray, name: str) -> None:
    """Check a host plan array once, when the plan is built: the fill
    kernels find a tile's batches as one consecutive range."""
    a = np.asarray(a)
    if a.size > 1 and bool((a[1:] < a[:-1]).any()):
        raise ValueError(f"{name} must be non-decreasing (each tile's batches "
                         "consecutive)")


@dataclasses.dataclass(frozen=True)
class FillLayout:
    """Where B1's or B2's kernel finds each tile's batches, in the order
    it takes the tiles: `order` (num_tiles,) int32 lists the `nbusy`
    tiles that hold a batch, ascending, then the empty ones, which the
    kernel writes as zeros without a cluster; busy tile i's batches are
    [start[i], start[i + 1]) of the non-decreasing batch_tile (`start`
    (nbusy + 1,) int32). `cluster` blocks share each busy tile
    (`cluster_size`). Tensors on the batches' device. It changes where
    the work runs, never the words."""

    start: torch.Tensor
    order: torch.Tensor
    nbusy: int
    cluster: int


def cluster_size(batches: int, busy: int, device, *, nw: int, tc: int) -> int:
    """Blocks a busy tile's cluster takes, for `batches` batches on each
    of `busy` busy tiles on average, at nw words a row and tc cells a
    tile: about BATCHES_PER_BLOCK a block, 1 to CLUSTER_MAX, and no more
    than lets every busy tile's clusters (one a cell group, `fill_rows`)
    be resident at once (one wave: the blocks a multiprocessor holds by
    its registers and by the shared memory a block takes, times the
    card's count, an H100's off the card). A block's fixed work (its
    copy of the tile's rows, their reduction) grows with the cluster, so
    the mean tile, not the busiest, sets it (a cluster sweep on the
    washers at 512^3 and 1024^3, tools/time_fill.py --sweep)."""
    dev = torch.device(device)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    groups, smem = fill_rows(nw, tc)
    per_sm = max(1, min(REGISTER_BLOCKS, _SMEM_SM // (smem + _SMEM_RESERVED)))
    wave = max(1, per_sm * sms // max(busy * groups, 1))
    return max(1, min(CLUSTER_MAX, wave, -(-batches // BATCHES_PER_BLOCK)))


def fill_layout(batch_tile: np.ndarray, num_tiles: int, device, *, nw: int, tc: int,
                name: str = "batch_tile") -> FillLayout:
    """A layout built on the host, once for a plan: checks that
    `batch_tile` is non-decreasing (`_check_sorted`)."""
    bt = np.asarray(batch_tile, np.int64)
    _check_sorted(bt, name)
    tile_start = np.searchsorted(bt, np.arange(num_tiles + 1), side="left")
    counts = np.diff(tile_start)
    busy = np.nonzero(counts)[0]
    order = np.concatenate([busy, np.nonzero(counts == 0)[0]])
    # Busy tiles' ranges are consecutive: the empty tiles between them hold none.
    start = np.append(tile_start[busy], tile_start[busy[-1] + 1] if len(busy) else 0)

    def dev32(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    mean = -(-int(counts.sum()) // max(len(busy), 1))
    return FillLayout(dev32(start), dev32(order), len(busy),
                      cluster_size(mean, len(busy), device, nw=nw, tc=tc))


def _layout(layout, batch_tile: torch.Tensor, num_tiles: int, *, nw: int,
            tc: int) -> FillLayout:
    """`layout`, checked, or, for a caller without a plan, the plan's
    layout built from a host copy of `batch_tile` (which waits for the
    card)."""
    if layout is None:
        return fill_layout(batch_tile.cpu().numpy(), num_tiles, batch_tile.device,
                           nw=nw, tc=tc)
    if not 1 <= layout.cluster <= CLUSTER_MAX or not 0 <= layout.nbusy <= num_tiles:
        raise ValueError(f"cluster={layout.cluster} outside [1, {CLUSTER_MAX}] or "
                         f"nbusy={layout.nbusy} outside [0, {num_tiles}]")
    _build.expect(layout.start, "start", torch.int32, (layout.nbusy + 1,))
    _build.expect(layout.order, "order", torch.int32, (num_tiles,))
    _build.on_cuda(batch_tile, layout.start, layout.order)  # raises on another device
    return layout


def _launch_wide(local, xs, batch_tile, layout, tile_map, out, *, tc: int, nw: int,
                 num_tiles: int, out_tiles: int) -> None:
    """B2's kernel into `out`: a compact buffer (no tile map) or a grid."""
    layout = _layout(layout, batch_tile, num_tiles, nw=nw, tc=tc)
    _build.launch("vt_wide_fill", local.data_ptr(), xs.data_ptr(), layout.start.data_ptr(),
                  layout.order.data_ptr(),
                  None if tile_map is None else tile_map.data_ptr(), local.shape[0],
                  local.shape[1] * local.shape[2], tc, nw, num_tiles, layout.nbusy,
                  out_tiles, layout.cluster, out.data_ptr(), _build.stream_of(out))
    wide_fill.launches += 1


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
              *, n: int, tc: int, num_tiles: int,
              layout: FillLayout | None = None) -> torch.Tensor:
    """B2: whole-axis suffix fill of (B, tb_sub, 128) slots (local cell,
    x entry; local -1 = inert) of batches on compact tiles
    `batch_tile` -> (num_tiles, tc, n/32) int32 words.

    `batch_tile` must be non-decreasing and lie in [0, num_tiles); it is
    not checked here (a plan checks its layout once, `fill_layout`). The
    kernel skips a batch outside that range. `layout` is the plan's
    `FillLayout`; without one it is built from a host copy of
    `batch_tile` (`fill_layout`, which also checks the order).

    Replaces voxtpu/ops/vox_pallas.py::_pallas_kernel. A CPU tensor
    takes the plain version, a CUDA tensor launches the kernel."""
    _check_slots(local, xs, batch_tile)
    if n % WORD_BITS:
        raise ValueError(f"N % {WORD_BITS} != 0 (n={n})")
    if not _build.on_cuda(local, xs, batch_tile):
        return wide_fill_plain(local, xs, batch_tile, n=n, tc=tc,
                               num_tiles=num_tiles)
    nw = n // WORD_BITS
    fill_rows(nw, tc)  # raises where one row does not fit a block
    out = torch.empty((num_tiles, tc, nw), dtype=torch.int32, device=local.device)
    if num_tiles:
        _launch_wide(local, xs, batch_tile, layout, None, out, tc=tc, nw=nw,
                     num_tiles=num_tiles, out_tiles=num_tiles)
    return out


def wide_fill_into(words: torch.Tensor, local: torch.Tensor, xs: torch.Tensor,
                   batch_tile: torch.Tensor, tile_map: torch.Tensor, *, n: int,
                   tc: int, layout: FillLayout | None = None) -> torch.Tensor:
    """B2 in place: XOR `wide_fill`'s words of compact tile t into the
    rows of grid tile `tile_map[t]` of `words` ((n, n, n/32) int32) and
    return `words`. `tile_map` ((k,) int32, k compact tiles) must hold
    distinct tiles of [0, N^2/tc): a plan checks it once. The same
    kernel as `wide_fill` (its launches count there), reading and
    writing the mapped rows once: no compact buffer and no merge."""
    _check_slots(local, xs, batch_tile)
    if n % WORD_BITS or (n * n) % tc:
        raise ValueError(f"need N % {WORD_BITS} == 0 and tc dividing N^2 (n={n}, tc={tc})")
    nw = n // WORD_BITS
    _build.expect(words, "words", torch.int32, (n, n, nw))
    _build.expect(tile_map, "tile_map", torch.int32, (None,))
    num_tiles = tile_map.shape[0]
    if not _build.on_cuda(words, local, xs, batch_tile, tile_map):
        words.view(-1, tc, nw)[tile_map.long()] ^= wide_fill_plain(
            local, xs, batch_tile, n=n, tc=tc, num_tiles=num_tiles)
        return words
    fill_rows(nw, tc)  # raises where one row does not fit a block
    if num_tiles:
        _launch_wide(local, xs, batch_tile, layout, tile_map, words, tc=tc, nw=nw,
                     num_tiles=num_tiles, out_tiles=(n * n) // tc)
    return words


wide_fill.launches = 0


class PallasVoxPlan:
    """Sorted-fragment batch layout of one (mesh, grid) pair on `device`
    (`vox_pallas.py:245-330`), the plan that forces voxtpu's suffix
    kernel. Fragments (of `fragments`, or `frag_plan`'s, or a new
    `FragmentPlan`'s) are keyed by (YZ tile, X segment of width `seg`,
    which must divide N; N by default) with a stable sort, as voxtpu's
    `lax.sort`, and cut into batches of tb = tb_sub * 128 per group; the
    FIRST / LAST flags are set at tile granularity. Only the group
    bounds come back to the host. The arrays equal voxtpu's:
    `local_cells`, `xs` (B, tb_sub, 128) int32 (local -1 in pad lanes),
    `batch_tile`, `flags`, `batch_xseg` (B,) int32, `tile_mask`
    (num_tiles,) bool; `layout` is B2's `FillLayout`.

    The x entries stay absolute, so B2's whole-axis fill of each batch,
    XORed over a tile's batches, gives voxtpu's segmented words (each
    segment's suffix fill plus its carry): `suffix_words` needs no
    segment id and no kernel of its own."""

    def __init__(self, mesh: Mesh, spec: GridSpec, device,
                 frag_plan: FragmentPlan | None = None, fragments=None,
                 tc: int = TILE_CELLS, tb_sub: int = TB_SUB, seg: int | None = None):
        n = spec.n
        if n % WORD_BITS != 0:
            raise ValueError("the suffix route requires N % 32 == 0")
        if tc <= 0 or (n * n) % tc != 0:
            raise ValueError(f"tc={tc} must be positive and divide N^2={n * n} "
                             "(tiles are TC consecutive YZ cells)")
        seg = n if seg is None else min(seg, n)
        if seg < 1 or n % seg != 0:
            raise ValueError(f"seg={seg} must divide N={n}")
        n_seg = n // seg
        tb = tb_sub * TB_LANE
        self._geometry(spec, device, tc, tb_sub, seg)
        num_tiles = self.num_tiles
        if fragments is None:
            if frag_plan is None:
                frag_plan = FragmentPlan(mesh, spec, self.device)
            fragments = fragments_from_plan(frag_plan)
        cells, xs = (a.to(self.device) for a in fragments)
        # Composite key (tile, xseg); the n*n cell sentinel maps to key
        # num_tiles * n_seg (xs = 0 there), past every probe.
        key = (cells // tc) * n_seg + torch.where(cells < n * n, xs // seg,
                                                  torch.zeros_like(xs))
        key, order = torch.sort(key, stable=True)
        local, xs = (cells % tc)[order], xs[order]
        probes = torch.arange(num_tiles * n_seg + 1, dtype=key.dtype, device=self.device)
        bounds = torch.searchsorted(key, probes).cpu().numpy()
        valid = int(bounds[-1])

        batch_group, starts_h, ends_h = tile_batches(bounds, tb)
        batch_tiles = batch_group // n_seg
        flags, _ = tile_flags(bounds, batch_tiles)  # FIRST / LAST by tile, not group
        starts, ends = (torch.from_numpy(a).to(self.device)
                        for a in (starts_h, np.minimum(ends_h, valid)))
        panel = (-1, tb_sub, TB_LANE)
        self._set_layout(
            _gather_batches(local[:valid], starts, ends, tb=tb, fill=-1).view(panel),
            _gather_batches(xs[:valid], starts, ends, tb=tb, fill=0).view(panel),
            batch_tiles, flags, batch_group % n_seg,
            (np.diff(bounds) > 0).reshape(num_tiles, n_seg).any(axis=1), valid)

    def _geometry(self, spec, device, tc, tb_sub, seg) -> None:
        self.spec, self.tc, self.tb_sub, self.seg = spec, tc, tb_sub, seg
        self.device = torch.empty(0, device=device).device
        self.num_tiles = spec.n * spec.n // tc

    def _set_layout(self, local_cells, xs, batch_tile, flags, batch_xseg, tile_mask,
                    num_fragments) -> None:
        def dev(a, dtype):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a))  # a copy: the source may be read-only
            return a.to(device=self.device, dtype=dtype).contiguous()

        self.local_cells, self.xs, self.batch_tile, self.flags, self.batch_xseg = (
            dev(a, torch.int32) for a in (local_cells, xs, batch_tile, flags, batch_xseg))
        self.tile_mask = dev(tile_mask, torch.bool)
        self.num_fragments = int(num_fragments)
        self.num_batches = self.batch_tile.shape[0]
        self.layout = fill_layout(np.asarray(batch_tile), self.num_tiles, self.device,
                                  nw=self.spec.n // WORD_BITS, tc=self.tc)

    @classmethod
    def from_layout(cls, spec: GridSpec, device, local_cells, xs, batch_tile, flags,
                    batch_xseg, tile_mask, *, tc: int, seg: int,
                    num_fragments: int) -> "PallasVoxPlan":
        """A plan on a given layout (see `interop.pallas_plan_from_voxtpu`);
        `batch_tile` must be non-decreasing (`fill_layout` checks it)."""
        plan = cls.__new__(cls)
        plan._geometry(spec, device, tc, np.shape(local_cells)[1], seg)
        plan._set_layout(local_cells, xs, batch_tile, flags, batch_xseg, tile_mask,
                         num_fragments)
        return plan


def suffix_words(plan: PallasVoxPlan) -> torch.Tensor:
    """voxtpu's suffix-kernel route on `plan` (`vox_pallas.py:333-368`):
    B2 over every batch -> (n, n, n/32) int32 words."""
    n = plan.spec.n
    words = wide_fill(plan.local_cells, plan.xs, plan.batch_tile, n=n, tc=plan.tc,
                      num_tiles=plan.num_tiles, layout=plan.layout)
    return words.view(n, n, n // WORD_BITS)
