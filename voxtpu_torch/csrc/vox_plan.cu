// The serving plan's greedy band cut, for Hopper (sm_90a).
//
// Replaces no TPU kernel: voxtpu cuts its banded batches on the host
// (voxtpu/ops/vox_slots_banded.py:389-448, a Python loop over the slots
// of each YZ tile). BandedSlotVoxPipeline builds the rest of its plan on
// the card in torch ops (ops/vox_slots_banded.py); this file is the one
// step of it that is sequential.
//
// The slots of one tile are sorted by their x window's start. A batch
// starts at slot i with the band base = min(32 * floor(xlo[i] / 32),
// n - band) and takes the slots after it up to the first one whose window
// ends at or past base + band, and at most tb slots; the next batch
// starts there. Slot i itself always fits (a narrow candidate is one
// whose window fits the band from its own base), so the search starts at
// i + 1 and every batch holds at least one slot.
//
// Bound: the cut within a tile is a chain (a batch's base depends on
// where the one before ended), so the busiest tile's batches, one after
// another, set the time, each at least one round trip to memory; the
// bytes are each slot's window read about once a pass (8 bytes a slot,
// ~23 MB at 512^3: a few microseconds at 3.35 TB/s). The design pays one
// round trip a batch and runs every tile at once: a warp a tile, whose
// lanes load the next tb (512) slots' windows in 16 independent coalesced
// loads each, then vote on each run of 32 (__ballot_sync); the first set
// bit ends the batch, and the next batch's first window is already in a
// register (a shuffle). 8 warps a block, so every tile of a 512^3 plan
// (2048) is resident in one wave.
//
// Two passes, both the same walk: vt_band_cut_counts writes each tile's
// batch count; the caller pads every group of tiles to its PACK multiple
// and scans the counts into each tile's first batch and pad batches
// after it (torch ops); vt_band_cut writes each batch's tile, base, first
// and end slot at the tile's offset, then its pads (the tile and its
// last base again, no slots). Nothing is allocated here.
//
// tests/test_torch_cut_emulated.py runs this file on the host through
// tests/cuda_emulation.h against the plain version
// (ops/vox_slots_banded.py::band_cut_counts_plain, band_cut_plain).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;             // tiles a block: a warp a tile
constexpr int kChunks = 16;           // runs of 32 slots a warp loads at once
constexpr int kSpan = 32 * kChunks;   // slots a load round covers (the plan's tb)

struct Cut {
  const int* xlo;      // (C,) the sorted slots' window starts
  const int* xhi;      // (C,) and ends (inclusive)
  const int* tbounds;  // (num_tiles + 1,) tile t's slots are [tbounds[t], tbounds[t + 1])
  const int* off;      // (num_tiles,) tile t's first batch (write pass)
  const int* pads;     // (num_tiles,) pad batches after tile t's last (write pass)
  int* counts;         // (num_tiles,) batches a tile (count pass)
  int* batch_tile;     // (B,) the write pass's outputs
  int* batch_base;
  int* start;
  int* end;
  int num_tiles, n, band, tb;
};

// Tile t's batches in order: the count pass counts them, the write pass
// writes each at off[t] + its index, then the tile's pads.
template <bool kWrite>
__global__ void __launch_bounds__(32 * kWarps) band_cut_kernel(Cut c) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= c.num_tiles) return;  // the whole warp
  const int b1 = c.tbounds[t + 1];
  int i = c.tbounds[t];
  int xlo_i = i < b1 ? c.xlo[i] : 0;
  int k = kWrite ? c.off[t] : 0;
  int base = 0;
  while (i < b1) {
    base = min((xlo_i >> 5) << 5, c.n - c.band);
    const int limit = base + c.band;
    const int w_end = min(i + c.tb, b1);
    // The batch's end e: the first slot after i whose window ends at or
    // past the band, else w_end. A span of kSpan slots' ends and starts is
    // loaded at once (kChunks independent loads a lane), so a batch costs
    // one round trip to memory, and the next batch's first start comes
    // with it (a shuffle from the lane that holds it).
    int e = -1, j0 = i + 1, lo[kChunks];
    while (e < 0) {
      int hi[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int s = j0 + 32 * q + lane;
        hi[q] = s < w_end ? c.xhi[s] : -1;  // -1 < limit: never ends a batch
        lo[q] = s < b1 ? c.xlo[s] : 0;
      }
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const unsigned viol = __ballot_sync(0xffffffffu, hi[q] >= limit);
        if (e < 0 && viol) e = j0 + 32 * q + __ffs(viol) - 1;
      }
      if (e < 0 && w_end < j0 + kSpan) e = w_end;
      if (e < 0) j0 += kSpan;
    }
    const int r = e - j0;  // in [0, kSpan): lane r % 32 of run r / 32
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int v = __shfl_sync(0xffffffffu, lo[q], r & 31);
      if (q == r >> 5) xlo_i = v;
    }
    if (kWrite && lane == 0) {
      c.batch_tile[k] = t;
      c.batch_base[k] = base;
      c.start[k] = i;
      c.end[k] = e;
    }
    ++k;
    i = e;
  }
  if (lane != 0) return;
  if (!kWrite) {
    c.counts[t] = k;
    return;
  }
  for (int p = 0; p < c.pads[t]; ++p) {
    c.batch_tile[k + p] = t;
    c.batch_base[k + p] = base;
    c.start[k + p] = 0;
    c.end[k + p] = 0;
  }
}

int launch_cut(const Cut& c, bool write, void* stream) {
  if (c.num_tiles < 0 || c.tb < 1 || c.band < 32 || c.band > c.n)
    return (int)cudaErrorInvalidValue;
  if (c.num_tiles == 0) return (int)cudaSuccess;
  const dim3 grid((c.num_tiles + kWarps - 1) / kWarps), block(32 * kWarps);
  if (write)
    band_cut_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(c);
  else
    band_cut_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1: counts[t] = the number of batches of tile t.
extern "C" int vt_band_cut_counts(const void* xlo, const void* xhi, const void* tbounds,
                                  void* counts, int num_tiles, int n, int band, int tb,
                                  void* stream) {
  Cut c = {};
  c.xlo = (const int*)xlo;
  c.xhi = (const int*)xhi;
  c.tbounds = (const int*)tbounds;
  c.counts = (int*)counts;
  c.num_tiles = num_tiles;
  c.n = n;
  c.band = band;
  c.tb = tb;
  return launch_cut(c, false, stream);
}

// Pass 2: each batch's (tile, base, start, end) at its tile's offset,
// then the tile's pad batches (tile, its last base, 0, 0).
extern "C" int vt_band_cut(const void* xlo, const void* xhi, const void* tbounds,
                           const void* off, const void* pads, void* batch_tile,
                           void* batch_base, void* start, void* end, int num_tiles, int n,
                           int band, int tb, void* stream) {
  Cut c = {};
  c.xlo = (const int*)xlo;
  c.xhi = (const int*)xhi;
  c.tbounds = (const int*)tbounds;
  c.off = (const int*)off;
  c.pads = (const int*)pads;
  c.batch_tile = (int*)batch_tile;
  c.batch_base = (int*)batch_base;
  c.start = (int*)start;
  c.end = (int*)end;
  c.num_tiles = num_tiles;
  c.n = n;
  c.band = band;
  c.tb = tb;
  return launch_cut(c, true, stream);
}
