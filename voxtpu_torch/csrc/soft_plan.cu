// The fused engine's greedy pair cut, for Hopper (sm_90a).
//
// Replaces no TPU kernel: voxtpu cuts the fused engine's batches on the
// host (voxtpu/ops/soft_vox_fused.py:596-696, a loop of searchsorted
// rounds over every tile). FusedSoftPlan builds the rest of its plan on
// the card in torch ops (ops/soft_vox_fused.py); this file is the one
// step of it that is sequential.
//
// The slots are sorted by (run, face, cell): a pair is one (run, face)
// run of slots, csum[p] the first slot of pair p, csum[P] the slot total.
// Within a run (a YZ tile of the fused plan), a batch starting at pair p
// takes the pairs after it up to the first whose end csum[q + 1] lies
// more than tb slots past csum[p], at most tbl pairs and no pair of the
// next run; the next batch starts there. A pair of more than tb slots
// fits no batch: the count pass writes -1 for its run, and the caller
// raises.
//
// Bound: the cut within a run is a chain (a batch's limit depends on
// where the one before ended), so the busiest run's batches, one after
// another, set the time, each at least one round trip to memory; the
// bytes are each pair's prefix read about once a pass (4 bytes a pair).
// The design is the serving plan's band cut (csrc/vox_plan.cu): a warp a
// run, whose lanes load the next 128 pairs' starts and ends (tbl's
// default) in 4 independent coalesced loads each, then vote on each run
// of 32 (__ballot_sync); the first set bit ends the batch, and the next
// batch's first slot is already in a register (a shuffle). 8 warps a
// block, so every tile of a 512^3 plan (2048) is resident in one wave.
//
// Two passes, both the same walk: vt_pair_cut_counts writes each run's
// batch count (-1 where a pair exceeds tb); the caller scans the counts
// into each run's first batch (torch ops); vt_pair_cut writes each
// batch's run, first pair and end pair at the run's offset, which puts
// the batches in the order of their first pair. Nothing is allocated
// here.
//
// tests/test_torch_pair_cut_emulated.py runs this file on the host
// through tests/cuda_emulation.h against the plain version
// (ops/soft_vox_fused.py::pair_cut_counts_plain, pair_cut_plain).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;             // runs a block: a warp a run
constexpr int kChunks = 4;            // groups of 32 pairs a warp loads at once
constexpr int kSpan = 32 * kChunks;   // pairs a load round covers (the plan's tbl)

struct PairCut {
  const int* csum;     // (P + 1,) each sorted pair's first slot, then the slot total
  const int* pbounds;  // (num_runs + 1,) run t's pairs are [pbounds[t], pbounds[t + 1])
  const int* off;      // (num_runs,) run t's first batch (write pass)
  int* counts;         // (num_runs,) batches a run, -1 where a pair exceeds tb (count pass)
  int* batch_run;      // (B,) the write pass's outputs
  int* p0;
  int* p1;
  int num_runs, tb, tbl;
};

// Run t's batches in order: the count pass counts them, the write pass
// writes each at off[t] + its index.
template <bool kWrite>
__global__ void __launch_bounds__(32 * kWarps) pair_cut_kernel(PairCut c) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= c.num_runs) return;  // the whole warp
  const int pe = c.pbounds[t + 1];
  int p = c.pbounds[t];
  int first = p < pe ? c.csum[p] : 0;  // the batch's first slot
  int k = kWrite ? c.off[t] : 0;
  while (p < pe) {
    const int limit = first + c.tb;
    const int w_end = min(p, pe - c.tbl) + c.tbl;  // min(p + tbl, pe), without overflow
    // The batch's end e: the first pair from p on whose end lies past the
    // limit, else w_end. A span of kSpan pairs' starts and ends is loaded
    // at once (kChunks independent loads a lane), so a batch costs one
    // round trip to memory, and the next batch's first slot comes with it
    // (a shuffle from the lane that holds it: pair e's start, or, where e
    // closes the span, the last pair's end).
    int e = -1, j0 = p, lo[kChunks], top = 0;
    while (e < 0) {
      int hi[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int s = j0 + 32 * q + lane;
        hi[q] = s < w_end ? c.csum[s + 1] : -1;  // -1 <= limit: never ends a batch
        lo[q] = s < pe ? c.csum[s] : 0;
      }
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const unsigned viol = __ballot_sync(0xffffffffu, hi[q] > limit);
        if (e < 0 && viol) e = j0 + 32 * q + __ffs(viol) - 1;
      }
      top = hi[kChunks - 1];
      if (e < 0 && w_end <= j0 + kSpan) e = w_end;
      if (e < 0) j0 += kSpan;
    }
    if (e == p) {  // pair p alone exceeds tb slots
      if (!kWrite && lane == 0) c.counts[t] = -1;
      return;
    }
    const int r = e - j0;  // in [0, kSpan]: lane r % 32 of group r / 32, or the span's end
    int next = __shfl_sync(0xffffffffu, top, 31);
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int v = __shfl_sync(0xffffffffu, lo[q], r & 31);
      if (q == r >> 5) next = v;
    }
    if (kWrite && lane == 0) {
      c.batch_run[k] = t;
      c.p0[k] = p;
      c.p1[k] = e;
    }
    ++k;
    p = e;
    first = next;
  }
  if (!kWrite && lane == 0) c.counts[t] = k;
}

int launch_cut(const PairCut& c, bool write, void* stream) {
  if (c.num_runs < 0 || c.tb < 1 || c.tbl < 1) return (int)cudaErrorInvalidValue;
  if (c.num_runs == 0) return (int)cudaSuccess;
  const dim3 grid((c.num_runs + kWarps - 1) / kWarps), block(32 * kWarps);
  if (write)
    pair_cut_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(c);
  else
    pair_cut_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1: counts[t] = the number of batches of run t, -1 where one of its
// pairs exceeds tb slots.
extern "C" int vt_pair_cut_counts(const void* csum, const void* pbounds, void* counts,
                                  int num_runs, int tb, int tbl, void* stream) {
  PairCut c = {};
  c.csum = (const int*)csum;
  c.pbounds = (const int*)pbounds;
  c.counts = (int*)counts;
  c.num_runs = num_runs;
  c.tb = tb;
  c.tbl = tbl;
  return launch_cut(c, false, stream);
}

// Pass 2: each batch's (run, first pair, end pair) at its run's offset.
extern "C" int vt_pair_cut(const void* csum, const void* pbounds, const void* off,
                           void* batch_run, void* p0, void* p1, int num_runs, int tb, int tbl,
                           void* stream) {
  PairCut c = {};
  c.csum = (const int*)csum;
  c.pbounds = (const int*)pbounds;
  c.off = (const int*)off;
  c.batch_run = (int*)batch_run;
  c.p0 = (int*)p0;
  c.p1 = (int*)p1;
  c.num_runs = num_runs;
  c.tb = tb;
  c.tbl = tbl;
  return launch_cut(c, true, stream);
}
