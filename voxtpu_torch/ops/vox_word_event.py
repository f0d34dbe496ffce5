"""Word-event voxelizer (kernel B12) — voxtpu's default voxelize route.

Port of `voxtpu/ops/vox_pallas_we.py`. For a fragment with entry
x = 32*w + b, the suffix mask over word q is all ones for q > w (the
carry), ``0xFFFFFFFF << b`` for q == w (the in-word mask), 0 below. So
the packed grid is

    words[c, q] = (XOR of the in-word masks of c's fragments at word q)
                  XOR (~0 if c has an odd number of fragments before q)

Fragments are reduced on the device (one sort by (cell, word), an XOR
scan, segment starts) into at most one *word event* per touched (cell,
word): local cell, packed lane, lane bound, mask and count parity. G =
128 // (N/32) consecutive YZ tiles form a *supertile* whose 128-word
panel holds their word columns side by side: an event of sub-tile g at
word w sits at lane g*nw + w and carries up to its bound (g+1)*nw.

- `WordEventVoxPlan` (the plan, built once: bounds and batch layout on
  the host, event panels on the device) and `voxelize_word_event`.
- `DeviceVoxPipeline`: the whole per-call path from the triangle
  buckets to the packed grid on the device (emit, compaction, sort,
  events, batch layout, B12), reading back one scalar, its overflow.
- B12 `word_event_fill` replaces `_we_kernel`
  (`csrc/vox_we.cu::vt_word_event_fill`); its plain torch version
  `word_event_fill_plain` is defined by XOR. Both return the grid in
  (n, n, n/32) order: voxtpu's lane-panel unpack (`_we_words`) is the
  kernel's output indexing, and `_unpack_lanes` in the plain version.

Keys are int64 ``cell * n + x`` where voxtpu packs uint32 keys (torch's
uint32 is thin); the order is the same and an invalid fragment's key
`_SENT` sorts after every valid one up to N = 4096. voxtpu compacts
the valid fragments by 64-byte row gathers, which its TPU needs; the
port compacts by a cumulative-sum scatter into the same capacity
`cap_f`, reports voxtpu's overflow in 16-slot rows, and gives the same
sorted keys whenever the overflow is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import WORD_BITS, GridSpec, VoxelGrid, pack_bits
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox import (FragmentPlan, _cumxor, _pad_granular,
                                  fragments_from_plan, suffix_masks)
from voxtpu_torch.ops.vox_cuda import (FLAG_FIRST, FLAG_LAST, TB_LANE, TB_SUB,
                                       TILE_CELLS, _LANE_MIN, _SMEM_MAX,
                                       _gather_batches, _group_factor,
                                       tile_batches, tile_flags)

MAX_N = 4096     # voxtpu's cap: its uint32 key cell*num_words + word
_SENT = 1 << 40  # key of an invalid fragment, past every cell*n + x < 4096^3
_BLOCK = 512     # voxtpu's compaction block (fragments) ...
_ROW = 16        # ... and row (slots): its overflow unit and cap_f sizing


def _check_geometry(n: int, tc: int) -> None:
    """voxtpu's refusals (`vox_pallas_we.py:418-426`)."""
    if n % WORD_BITS != 0:
        raise ValueError("word-event vox requires N % 32 == 0")
    if n > MAX_N:
        raise ValueError(f"word-event path caps at N = {MAX_N} (got {n})")
    if tc <= 0 or (n * n) % tc != 0:
        raise ValueError(f"tc={tc} must divide N^2={n * n}")


def _panel_geometry(n: int, tc: int):
    """(num_words, num_tiles, group, num_super, wpad) of one grid."""
    nw = n // WORD_BITS
    num_tiles = n * n // tc
    g = _group_factor(nw, num_tiles)
    return nw, num_tiles, g, num_tiles // g, max(g * nw, _LANE_MIN)


def _block_rows(valid: torch.Tensor):
    """Valid fragments per 512-fragment block, and voxtpu's compaction
    row count: the sum over blocks of ceil(count / 16)."""
    f = valid.shape[0]
    pad = valid.new_zeros(-f % _BLOCK)
    counts = torch.cat([valid, pad]).view(-1, _BLOCK).sum(1)
    return counts, ((counts + _ROW - 1) // _ROW).sum()


def _compact(key: torch.Tensor, valid: torch.Tensor, cap: int):
    """The valid keys, in order, at the front of a `cap`-long array
    padded with `_SENT`, by a cumulative-sum scatter (no data-dependent
    shapes). Returns (keys, overflow): overflow is voxtpu's
    (`_block_compact`), the 16-slot rows past cap / 16; when it is 0
    every valid key is kept."""
    _, rows = _block_rows(valid)
    overflow = (rows - cap // _ROW).clamp(min=0)
    pos = torch.cumsum(valid, 0) - 1
    dst = torch.where(valid & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), _SENT, dtype=torch.int64, device=key.device)
    out.scatter_(0, dst, key)  # every dropped key lands in the spare slot
    return out[:cap], overflow


def _sorted_keys_from_fragments(cells, xs, *, n: int, cap_f: int | None):
    """(cell, x) fragments -> ascending (ckey, mask): ckey = cell *
    num_words + word (>= n^2 * num_words for invalid), mask the int32
    bits of the in-word suffix mask (0 for invalid). With `cap_f` the
    valid fragments are first compacted to that capacity (the per-call
    path); None sorts them all (the plan build). Returns (ckey_s,
    mask_s, overflow)."""
    valid = cells < n * n
    key = torch.where(valid, cells.long() * n + xs.long(),
                      torch.full_like(cells, _SENT, dtype=torch.int64))
    overflow = torch.zeros((), dtype=torch.int64, device=cells.device)
    if cap_f is not None:
        key, overflow = _compact(key, valid, cap_f)
    key_s, _ = torch.sort(key)
    ckey_s = key_s >> 5  # cell*n + x >> 5 == cell*num_words + word
    mask_s = torch.where(key_s != _SENT, suffix_masks(key_s), 0)
    return ckey_s, mask_s, overflow


def _events_core(ckey_s, mask_s, *, n: int, tc: int, cap_e: int):
    """Sorted (ckey, mask) fragments -> word events + supertile bounds
    (`vox_pallas_we.py:310-372`).

    One event per (cell, word) segment: its XOR mask from the XOR scan
    (inclusive at the last member against exclusive at the first), its
    count parity from the segment length. Segment starts are listed in
    order by a cumulative-sum scatter (voxtpu sorts them; the array is
    the same). Returns (local_e, w_e, hi_e, mask_e, cnt_e, bounds,
    num_events, overflow): cap_e-long int32 event arrays whose pads
    hold local -1, lane -1, bound 0, mask 0, count 0; `bounds` the
    (num_super + 1) event ranges of the supertiles; overflow > 0 when
    cap_e cut real events."""
    f = ckey_s.shape[0]
    dev = ckey_s.device
    nw, _, g, num_super, _ = _panel_geometry(n, tc)
    valid_s = ckey_s < n * n * nw
    nvalid = valid_s.sum()
    scan = _cumxor(mask_s)

    prev = torch.cat([ckey_s.new_full((1,), -1), ckey_s[:-1]])
    start = (ckey_s != prev) & valid_s
    num_events = start.sum()
    spos_p = torch.full((f + 2,), f, dtype=torch.int64, device=dev)
    spos_p.scatter_(0, torch.where(start, torch.cumsum(start, 0) - 1, f + 1),
                    torch.arange(f, device=dev))
    ce = min(cap_e, f)
    spos_e = spos_p[:ce]
    pad_e = spos_e >= f
    # Segment i ends where segment i+1 begins; the last real segment
    # ends at nvalid (the valid keys are the sorted prefix).
    nxt = spos_p[1:ce + 1]
    nxt = torch.where(nxt >= f, nvalid, nxt)

    k0 = ckey_s[spos_e.clamp(0, f - 1)]
    pexcl = torch.where(spos_e > 0, scan[(spos_e - 1).clamp(0, f - 1)], 0)
    pincl = scan[(nxt - 1).clamp(0, f - 1)]
    mask_e = torch.where(pad_e, 0, pincl ^ pexcl)
    cnt_e = torch.where(pad_e, 0, (nxt - spos_e) & 1)
    cell_e = torch.where(pad_e, n * n, k0 // nw)
    overflow = (num_events - ce).clamp(min=0)

    super_key = (cell_e // (tc * g)).clamp(max=num_super)
    bounds = torch.searchsorted(super_key, torch.arange(num_super + 1, device=dev))
    ok = ~pad_e
    sub_e = (cell_e // tc) % g  # sub-tile within the supertile
    local_e = torch.where(ok, cell_e % tc, -1)
    w_e = torch.where(ok, sub_e * nw + k0 % nw, -1)
    hi_e = torch.where(ok, (sub_e + 1) * nw, 0)
    events = tuple(a.to(torch.int32) for a in (local_e, w_e, hi_e, mask_e, cnt_e))
    return (*events, bounds, num_events, overflow)


def _build_events(cells, xs, *, n: int, tc: int):
    """The plan build's fragment -> word-event reduction, full size (no
    capacity): (local_e, w_e, hi_e, mask_e, cnt_e, bounds, num_events)."""
    ckey_s, mask_s, _ = _sorted_keys_from_fragments(cells, xs, n=n, cap_f=None)
    return _events_core(ckey_s, mask_s, n=n, tc=tc, cap_e=cells.shape[0])[:7]


def _gather_event_batches(local_e, w_e, hi_e, mask_e, cnt_e, starts, ends, *,
                          tb: int):
    """The five (B, tb) event panels; lanes past a batch's end hold
    voxtpu's fills: local -1, and 0 in the other four."""
    return tuple(_gather_batches(a, starts, ends, tb=tb, fill=fill)
                 for a, fill in ((local_e, -1), (w_e, 0), (hi_e, 0), (mask_e, 0),
                                 (cnt_e, 0)))


class WordEventVoxPlan:
    """Word-event batch layout for one (mesh, grid) pair on `device`
    (`vox_pallas_we.py:406-469`): the events of `fragments` (or of
    `frag_plan`'s, or of a new `FragmentPlan`'s), cut into batches of
    tb = tb_sub * 128 per supertile. Only the (num_super + 1) bounds
    come back to the host. The arrays equal voxtpu's: `cells`, `ws`,
    `his`, `masks` (int32 bits), `cnts` (B, tb_sub, 128), `batch_tile`,
    `flags` (B,), `tile_mask` (num_super,)."""

    def __init__(self, mesh: Mesh, spec: GridSpec, device,
                 frag_plan: FragmentPlan | None = None, fragments=None,
                 tc: int = TILE_CELLS, tb_sub: int = TB_SUB):
        n = spec.n
        _check_geometry(n, tc)
        self._geometry(spec, device, tc, tb_sub)
        tb = tb_sub * TB_LANE
        if fragments is None:
            if frag_plan is None:
                frag_plan = FragmentPlan(mesh, spec, self.device)
            fragments = fragments_from_plan(frag_plan)
        cells, xs = (a.to(self.device) for a in fragments)
        *events, bounds_d, num_events = _build_events(cells, xs, n=n, tc=tc)
        bounds = bounds_d.cpu().numpy()
        self.num_events = int(num_events)
        self.num_fragments = int(cells.shape[0])

        batch_tiles, starts_h, ends_h = tile_batches(bounds, tb)
        flags, tile_mask = tile_flags(bounds, batch_tiles)
        starts, ends = (torch.from_numpy(a).to(self.device) for a in (starts_h, ends_h))
        panels = _gather_event_batches(*events, starts, ends, tb=tb)
        self._set_layout(*(p.view(-1, tb_sub, TB_LANE) for p in panels),
                         batch_tiles, flags, tile_mask)

    def _geometry(self, spec, device, tc, tb_sub) -> None:
        self.spec = spec
        self.device = torch.empty(0, device=device).device
        self.tc, self.tb_sub = tc, tb_sub
        (self.num_words, self.num_tiles, self.group, self.num_super,
         _) = _panel_geometry(spec.n, tc)

    def _set_layout(self, cells, ws, his, masks, cnts, batch_tile, flags,
                    tile_mask) -> None:
        def dev(a, dtype):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a))  # a copy: the source may be read-only
            return a.to(device=self.device, dtype=dtype).contiguous()

        self.cells, self.ws, self.his, self.masks, self.cnts = (
            dev(a, torch.int32) for a in (cells, ws, his, masks, cnts))
        self.batch_tile = dev(batch_tile, torch.int32)
        self.flags = dev(flags, torch.int32)
        self.tile_mask = dev(tile_mask, torch.bool)
        self.num_batches = self.batch_tile.shape[0]

    @classmethod
    def from_layout(cls, spec: GridSpec, device, cells, ws, his, masks, cnts,
                    batch_tile, flags, tile_mask, *, tc: int, num_events: int,
                    num_fragments: int) -> "WordEventVoxPlan":
        """A plan on a given layout (int32 event panels; see
        `interop.word_event_plan_from_voxtpu`)."""
        _check_geometry(spec.n, tc)
        plan = cls.__new__(cls)
        plan._geometry(spec, device, tc, np.shape(cells)[1])
        plan._set_layout(cells, ws, his, masks, cnts, batch_tile, flags, tile_mask)
        plan.num_events, plan.num_fragments = int(num_events), int(num_fragments)
        return plan


def _unpack_lanes(panel: torch.Tensor, *, n: int, tc: int) -> torch.Tensor:
    """(num_super, tc, wpad) supertile panels -> (n, n, n/32) words: the
    G sub-tiles of a panel are consecutive runs of tc cells
    (`vox_pallas_we.py:481-486`)."""
    nw, _, g, num_super, _ = _panel_geometry(n, tc)
    words = panel[:, :, :g * nw].reshape(num_super, tc, g, nw).transpose(1, 2)
    return words.reshape(n, n, nw)


def word_event_fill_plain(cells, ws, his, masks, cnts, batch_tile, *, n: int,
                          tc: int) -> torch.Tensor:
    """Plain torch version of B12 (any device), by its definition: word
    q of local cell c in supertile s is the XOR over the events e of s
    at c of (mask_e if q == w_e) and (~0 if cnt_e is odd and w_e < q <
    hi_e). The in-word XOR is a per-bit count mod 2; the carry a
    cumulative count of toggles at w_e + 1 and at hi_e, mod 2."""
    nw, _, g, num_super, wpad = _panel_geometry(n, tc)
    rows = num_super * tc
    bt = batch_tile.long().view(-1, 1, 1)
    live = ((cells >= 0) & (cells < tc) & (ws >= 0) & (ws < wpad)
            & (bt >= 0) & (bt < num_super))
    row = bt * tc + cells.long()

    slot = torch.where(live, row * wpad + ws.long(), rows * wpad).reshape(-1)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=cells.device)
    bits = ((masks.reshape(-1, 1) >> shifts) & 1)
    count = torch.zeros((rows * wpad + 1, WORD_BITS), dtype=torch.int32,
                        device=cells.device)
    count.index_add_(0, slot, bits)
    inword = pack_bits((count[:-1] & 1).bool()).view(rows, wpad)

    lo = ws.long() + 1
    hi = his.long().clamp(max=wpad)
    on = live & ((cnts & 1) == 1) & (lo < hi)
    spare = rows * (wpad + 1)
    toggles = torch.zeros(spare + 1, dtype=torch.int32, device=cells.device)
    ones = torch.ones(on.numel(), dtype=torch.int32, device=cells.device)
    for edge in (lo, hi):
        toggles.index_add_(0, torch.where(on, row * (wpad + 1) + edge, spare).reshape(-1),
                           ones)
    carry = torch.cumsum(toggles[:-1].view(rows, wpad + 1), 1, dtype=torch.int32)
    words = inword ^ -(carry[:, :wpad] & 1)
    return _unpack_lanes(words.view(num_super, tc, wpad), n=n, tc=tc)


def word_event_fill(cells, ws, his, masks, cnts, batch_tile, *, n: int,
                    tc: int) -> torch.Tensor:
    """B12: the packed (n, n, n/32) int32 grid of word-event panels
    (`cells`, `ws`, `his`, `masks`, `cnts`: (B, tb_sub, 128) int32;
    local cell -1 = inert) of batches on supertiles `batch_tile` (B,).

    `batch_tile` must be non-decreasing, as the plans make it: the
    kernel finds a supertile's batches by binary search, and skips a
    batch outside [0, num_super).

    Replaces voxtpu/ops/vox_pallas_we.py::_we_kernel. A CPU tensor takes
    the plain version, a CUDA tensor launches the kernel."""
    _build.expect(cells, "cells", torch.int32, (None, None, TB_LANE))
    for name, a in (("ws", ws), ("his", his), ("masks", masks), ("cnts", cnts)):
        _build.expect(a, name, torch.int32, tuple(cells.shape))
    _build.expect(batch_tile, "batch_tile", torch.int32, (cells.shape[0],))
    _check_geometry(n, tc)
    nw, _, g, num_super, wpad = _panel_geometry(n, tc)
    if not _build.on_cuda(cells, ws, his, masks, cnts, batch_tile):
        return word_event_fill_plain(cells, ws, his, masks, cnts, batch_tile, n=n, tc=tc)
    if 2 * tc * (wpad + 1) * 4 > _SMEM_MAX:
        raise ValueError(f"tc={tc} x {wpad} lanes exceeds one block's shared "
                         f"memory ({_SMEM_MAX} bytes)")
    out = torch.empty((n, n, nw), dtype=torch.int32, device=cells.device)
    num_batches, tb = cells.shape[0], cells.shape[1] * cells.shape[2]
    _build.launch("vt_word_event_fill", cells.data_ptr(), ws.data_ptr(),
                  his.data_ptr(), masks.data_ptr(), cnts.data_ptr(),
                  batch_tile.data_ptr(), num_batches, tb, tc, nw, g, num_super,
                  wpad, out.data_ptr(), _build.stream_of(out))
    word_event_fill.launches += 1
    return out


word_event_fill.launches = 0


def voxelize_word_event(mesh: Mesh, spec: GridSpec, device,
                        plan: WordEventVoxPlan | FragmentPlan | None = None
                        ) -> VoxelGrid:
    """Solid voxelization through B12 (`vox_pallas_we.py:704-719`)."""
    if plan is None or isinstance(plan, FragmentPlan):
        plan = WordEventVoxPlan(mesh, spec, device, frag_plan=plan)
    words = word_event_fill(plan.cells, plan.ws, plan.his, plan.masks, plan.cnts,
                            plan.batch_tile, n=spec.n, tc=plan.tc)
    return VoxelGrid(words, spec.origin_tensor(plan.device),
                     spec.voxel_size_tensor(plan.device))


# ---------------------------------------------------------------------------
# The per-call path on the device
# ---------------------------------------------------------------------------


def _device_batches(bounds, *, num_super: int, tb: int, b_max: int):
    """The batch layout on the device with a static capacity b_max
    (`vox_pallas_we.py:494-532`): batch i belongs to the supertile whose
    cumulative batch range holds it. Spares past the true count revisit
    the last real batch's supertile with flags 0 and no events. Returns
    (batch_tile, flags, starts, ends, overflow); overflow > 0 means
    b_max was too small by that many batches."""
    dev = bounds.device
    counts = torch.diff(bounds)
    nb = (counts + tb - 1) // tb  # 0 for an empty supertile
    cum = torch.cat([nb.new_zeros(1), torch.cumsum(nb, 0)])
    total = cum[-1]
    bi = torch.arange(b_max, device=dev)
    t = (torch.searchsorted(cum, bi, right=True) - 1).clamp(0, num_super - 1)
    j = bi - cum[t]
    valid = bi < total
    starts = torch.where(valid, bounds[t] + j * tb, 0)
    ends = torch.where(valid, torch.minimum(starts + tb, bounds[t + 1]), 0)
    flags = (torch.where(j == 0, FLAG_FIRST, 0)
             | torch.where(j == nb[t] - 1, FLAG_LAST, 0))
    flags = torch.where(valid, flags, 0)
    # total == 0 (empty mesh): every batch is an inert spare on supertile 0.
    last_tile = t[(total - 1).clamp(0, b_max - 1).view(1)]  # a tensor index: no sync
    batch_tile = torch.where(valid, t, last_tile)
    overflow = (total - b_max).clamp(min=0)
    return (batch_tile.to(torch.int32), flags.to(torch.int32), starts, ends,
            overflow)


def _device_words_from_fragments(cells, xs, *, n: int, tc: int, tb_sub: int,
                                 b_max: int, cap_f: int):
    """Fragments -> packed words on the device, with static capacities
    (`vox_pallas_we.py:537-570`): `cap_f` valid fragments, b_max * tb
    events, b_max batches. Returns (words, overflow): overflow, a device
    scalar, is nonzero if any capacity cut real work."""
    _, _, _, num_super, _ = _panel_geometry(n, tc)
    tb = tb_sub * TB_LANE
    ckey_s, mask_s, ovf_f = _sorted_keys_from_fragments(cells, xs, n=n, cap_f=cap_f)
    *events, bounds, _, ovf_e = _events_core(ckey_s, mask_s, n=n, tc=tc,
                                             cap_e=min(b_max * tb, cap_f))
    batch_tile, _, starts, ends, ovf_b = _device_batches(
        bounds, num_super=num_super, tb=tb, b_max=b_max)
    panels = _gather_event_batches(*events, starts, ends, tb=tb)
    words = word_event_fill(*(p.view(b_max, tb_sub, TB_LANE) for p in panels),
                            batch_tile, n=n, tc=tc)
    return words, ovf_f + ovf_e + ovf_b


def _total(frag_plan: FragmentPlan, *, tc: int, tb_sub: int, b_max: int,
           cap_f: int):
    """The whole per-call path (`vox_pallas_we.py:573-591`): emit every
    bucket's fragments, then `_device_words_from_fragments`."""
    cells, xs = fragments_from_plan(frag_plan)
    return _device_words_from_fragments(cells, xs, n=frag_plan.spec.n, tc=tc,
                                        tb_sub=tb_sub, b_max=b_max, cap_f=cap_f)


def _compact_stats(cells, *, n: int):
    """(valid fragment count, voxtpu's compaction rows), device scalars,
    for sizing cap_f (`vox_pallas_we.py:594-604`)."""
    counts, rows = _block_rows(cells < n * n)
    return counts.sum(), rows


class DeviceVoxPipeline:
    """Whole-pipeline voxelizer (`vox_pallas_we.py:613-701`): triangle
    buckets to the packed grid on `device`, nothing on the host per
    call but the overflow check.

    The call reads nothing back and copies nothing to the device before
    its overflow: no data-dependent shapes (the static capacities below)
    and no host scalars moved.

    Built once: the buckets (`FragmentPlan`), and the static capacities
    from one probe emission: the batch capacity `b_max` (the probe
    plan's batch count times `slack`) and the compacted fragment
    capacity `cap_f` (voxtpu's row count times `slack`, 1/8-octave
    granular, at least 256). `words()` returns (words, overflow);
    `__call__` reads the overflow back and raises when it is nonzero
    (the result would be incomplete: rebuild, or raise `slack`)."""

    def __init__(self, mesh: Mesh, spec: GridSpec, device, tc: int = TILE_CELLS,
                 tb_sub: int = TB_SUB, slack: float = 1.0):
        _check_geometry(spec.n, tc)
        self.spec = spec
        self.device = torch.empty(0, device=device).device
        self.tc, self.tb_sub = tc, tb_sub
        self.frag_plan = FragmentPlan(mesh, spec, self.device)
        frags = fragments_from_plan(self.frag_plan)
        probe = WordEventVoxPlan(mesh, spec, self.device, fragments=frags, tc=tc,
                                 tb_sub=tb_sub)
        self.b_max = max(int(np.ceil(probe.num_batches * slack)), 1)
        self.num_events = probe.num_events
        self.num_fragments = probe.num_fragments
        self.num_batches = probe.num_batches
        nvalid, rows = _compact_stats(frags[0], n=spec.n)
        self.num_valid = int(nvalid)
        self.cap_f = max(_pad_granular(int(np.ceil(int(rows) * slack)) * _ROW), 256)

    def words(self):
        """(packed words, overflow), both on the device."""
        return _total(self.frag_plan, tc=self.tc, tb_sub=self.tb_sub,
                      b_max=self.b_max, cap_f=self.cap_f)

    def __call__(self) -> VoxelGrid:
        words, overflow = self.words()
        overflow = int(overflow)  # the call's one read-back
        if overflow:
            raise RuntimeError(f"batch capacity exceeded by {overflow}; rebuild the "
                               "pipeline (coords drifted) or raise slack")
        return VoxelGrid(words, self.frag_plan.origin, self.frag_plan.voxel_size)
