// Soft (differentiable) voxelization kernels, for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of voxtpu:
//   B7      voxtpu/ops/soft_vox_fused.py::_fused_fwd_kernel   (vt_fused_fwd)
//   B8      voxtpu/ops/soft_vox_fused.py::_fused_bwd_kernel   (vt_fused_bwd)
//   B13 fwd voxtpu/ops/soft_vox_pallas.py::_fwd_kernel        (vt_fragment_fwd)
//   B13 bwd voxtpu/ops/soft_vox_pallas.py::_bwd_kernel        (vt_fragment_bwd)
//
// All four work on one slot layout: batches of tb slots, each slot a
// candidate cell (local cell of the batch's YZ tile, -1 = pad). A slot
// is one fragment: a weight w and an x-hit xh whose profile over the
// cell's x row is w * sigmoid((xh - cx) / tau_x). The fused kernels
// rebuild (w, xh) in the kernel from the slot's cell and its
// triangle's 16-coefficient table row (edge planes, x-hit plane,
// facing sign); the fragment kernels read (w, xh) from device memory.
//
// Forward (B7, B13 fwd): occ[cell, x] = sum over slots of the profile.
// The TPU kernels contract a one-hot (cells x slots) matrix with the
// (slots x N) profile on the MXU and carry a tile's sum in VMEM across
// the batches of its run (FIRST/LAST flags of a sequential grid). Here
// one block owns one tile run and one chunk of kXC columns, and its
// (tc x kXC) accumulator sits in shared memory (a whole 512-column tile
// would not fit in the 227 KB a block may use). A cell's ~200 terms
// have partial sums far larger than the result (each slot's coverage
// leaks over the pad window with both facing signs), so a float32
// running sum loses ~1e-4 at 512^3. Each term is therefore rounded to
// a multiple of 2^-40 and added as a 64-bit integer: exact and
// associative, so threads add with shared-memory atomics in any order
// and the sum stays deterministic; it is rounded to float once.
//
// Backward (B8, B13 bwd): per slot, dw = sum_x g[cell, x] * sig and
// dxh = (w / tau_x) * sum_x g[cell, x] * sig * (1 - sig). B13 writes
// (dw, dxh) per slot. B8 chain-rules them to the 13 coefficient
// cotangents and sums those per table row: one block per batch, so no
// two blocks write one row, and each row's sum runs over the batch's
// slots in slot order.
//
// All four compute a slot's sigmoid only inside its transition window
// [a, b) of columns (`slot_window` in soft_common.cuh, which says why
// left of a the sigmoid is exactly 1.0f and from b on a forward term
// rounds to 0). At the default tau_x of half a voxel a window is ~23
// columns of 512.
//
// Forward: a record pass writes each live slot's (cell, w, xh, a | b <<
// 16) as an int4 (`slot_record`; B7's `fused_window_kernel` rebuilds the
// fragment, B13's `fragment_window_kernel` reads it), and one
// accumulation, `window_accumulate_kernel`, serves both. It adds the
// saturated columns' integer __float2ll_rn(w * 2^40), the very integer
// the full row adds there, through a per-cell difference along the
// chunk and one scan, gives each slot whose window meets the chunk
// kGroup lanes, and drops the zero columns: its 64-bit sums, and so its
// output, are bitwise those of the full row. A slot whose w or xh is not
// finite, or |w| > 1, takes the whole row, so that its NaN marks fall
// where the full row puts them.
//
// Backward: `row_prefix_kernel` writes g's row prefix in float64 (one
// pass a call), from which a slot takes the saturated columns' sum of
// g; kGroup lanes a slot sum its window in float32 (`window_sums`, a
// fixed shuffle tree) and drop the terms right of b (each below 2^-41
// |g[x]|). A row whose total is not finite, or a slot whose xh is not
// finite, takes the whole row. B8 (`fused_grad_kernel`) is a block a
// batch that rebuilds each fragment and chain-rules it; B13
// (`fragment_grad_kernel`) has neither, and lays its grid over the
// slots, a lane a slot and a warp 32 of them.
//
// What bounds them on this card: the sigmoid of every (slot, column)
// pair in the window (kGroup lanes a slot, ~23 columns), each with a
// 64-bit shared add (two native 32-bit atomics) in the forward and a
// read of the cotangent in the backward; the record pass (16 bytes a
// slot) and each chunk block's two reads of its run's records; the
// prefix (4 bytes read and 8 written a grid cell); B8's per-slot
// rebuild and chain rule. The library is
// built with -fmad=false and the coefficient, x-hit and chain-rule
// arithmetic is spelled in voxtpu's order, so every operation rounds on
// its own.
//
// tests/test_torch_soft_emulated.py runs this file on the host by
// rewriting the cuda_runtime.h include, each `extern __shared__` array
// (spelled `extern __shared__ <one-word type> <name>[];`) and each
// `<<<...>>>` launch. A change to those lines' text changes the test
// with it. No kernel here declares a static __shared__ variable: the
// host rewrite would make it a thread's own.

#include "soft_common.cuh"

namespace {

constexpr int kXC = kScanCols;  // columns per forward block
constexpr int kThreads = 256;
constexpr int kFwdThreads = 512;  // the accumulation: 16 warps at 3 blocks an SM

// Lift a kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// A fused slot's fragment from its global cell (z * n + y).
__device__ __forceinline__ Frag fused_frag(const float* __restrict__ at,
                                           int gcell, const Geom& g) {
  return frag_at(at, center(g.oy, gcell % g.n, g.vs),
                 center(g.oz, gcell / g.n, g.vs), g);
}

// ---------------------------------------------------------------------
// Forward: a record pass (B7 or B13), then the windowed accumulation.
// ---------------------------------------------------------------------

// B7's record pass: one thread a slot, its fragment rebuilt
// (`slot_record` over the row).
__global__ void fused_window_kernel(const float* __restrict__ tables,
                                    const int* __restrict__ tblidx,
                                    const int* __restrict__ cells,
                                    const int* __restrict__ batch_tile,
                                    long long num_slots, int tb, int tbl,
                                    int num_tiles, Geom g, int4* __restrict__ rec) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= num_slots) return;
  const int b = (int)(k / tb);
  const int tile = batch_tile[b];
  const int c = cells[k];
  const float* at = tile >= 0 && tile < num_tiles && c >= 0 && c < g.tc
                        ? table_row(tables, tblidx, k, b, tbl)
                        : nullptr;
  int4 r = make_int4(-1, 0, 0, 0);
  if (at) {
    const Frag f = fused_frag(at, tile * g.tc + c, g);
    r = slot_record(c, f.w, f.xh, 0, g.n, g);
  }
  rec[k] = r;
}

// B13 fwd's record pass: one thread a slot, its (w, xh) read.
__global__ void fragment_window_kernel(const float* __restrict__ wb,
                                       const float* __restrict__ xb,
                                       const int* __restrict__ cells,
                                       const int* __restrict__ batch_tile,
                                       long long num_slots, int tb, int num_tiles, Geom g,
                                       int4* __restrict__ rec) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= num_slots) return;
  const int tile = batch_tile[k / tb];
  const int c = cells[k];
  rec[k] = tile >= 0 && tile < num_tiles && c >= 0 && c < g.tc
               ? slot_record(c, wb[k], xb[k], 0, g.n, g)
               : make_int4(-1, 0, 0, 0);
}

// Grid (num_runs * chunks), kFwdThreads threads: block (run, chunk) sums
// columns [x0, x1) of the run's tile (`accumulate_windows`).
__global__ void window_accumulate_kernel(const int4* __restrict__ rec,
                                         const int* __restrict__ batch_tile,
                                         const int* __restrict__ run_start, int tb,
                                         int num_tiles, int chunks, Geom g,
                                         float* __restrict__ out) {
  extern __shared__ u64 smem_acc[];
  const int run = blockIdx.x / chunks;
  const int x0 = (blockIdx.x % chunks) * kXC;
  const int x1 = min(x0 + kXC, g.n);
  const int b0 = run_start[run];
  const int b1 = run_start[run + 1];
  if (b1 <= b0) return;
  const int tile = batch_tile[b0];
  if (tile < 0 || tile >= num_tiles) return;  // uniform per block
  const AccSmem s = acc_smem(smem_acc, g.tc, tb);
  accumulate_windows(s, rec, b0, b1, tb, x0, x1, false, g);
  store_windows(s, g.tc, x1 - x0, out + (long long)tile * g.tc * g.n + x0, g.n);
}

// The accumulation of B7 and B13 fwd over slot records `rec`.
int accumulate(const int4* rec, const int* batch_tile, const int* run_start, int num_runs,
               int tb, int num_tiles, const Geom& g, float* out, cudaStream_t st) {
  const size_t smem = acc_smem_bytes(g.tc, tb);
  const int e = allow_smem(window_accumulate_kernel, smem);
  if (e) return e;
  const int chunks = (g.n + kXC - 1) / kXC;
  window_accumulate_kernel<<<(unsigned)((long long)num_runs * chunks), kFwdThreads, smem,
                             st>>>(rec, batch_tile, run_start, tb, num_tiles, chunks, g, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// Backward: a row prefix pass, then the windowed slot gradients (B8 or
// B13).
// ---------------------------------------------------------------------

// pre[r, x] = sum of g[r, 0..x] in float64, one warp a row.
__global__ void row_prefix_kernel(const float* __restrict__ g, long long rows, int n,
                                  double* __restrict__ pre) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= rows) return;  // uniform per warp
  const int lane = threadIdx.x & 31;
  const float* row = g + r * n;
  double* out = pre + r * n;
  double carry = 0.0;
  for (int x0 = 0; x0 < n; x0 += 32) {
    const int x = x0 + lane;
    double v = x < n ? (double)row[x] : 0.0;
    for (int off = 1; off < 32; off <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    v += carry;
    if (x < n) out[x] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// g's row prefix into `pre` (B8, B13 bwd).
int row_prefix(const float* gocc, long long rows, int n, double* pre, cudaStream_t st) {
  row_prefix_kernel<<<(unsigned)((rows * 32 + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      gocc, rows, n, pre);
  return (int)cudaGetLastError();
}

// B8. Grid (num_batches), kThreads threads. A thread a slot rebuilds its
// fragment and window; kGroup lanes a slot sum its window's columns; a
// thread a slot adds the saturated prefix and applies the chain rule.
__global__ void fused_grad_kernel(const float* __restrict__ tables,
                                  const int* __restrict__ tblidx,
                                  const int* __restrict__ cells,
                                  const int* __restrict__ batch_tile,
                                  const float* __restrict__ gocc,
                                  const double* __restrict__ pre, int tb, int tbl,
                                  int num_tiles, Geom g, float* __restrict__ dtab) {
  extern __shared__ float smem[];
  float* s_d = smem;                       // [tb][kNgrad]
  int* s_row = (int*)(s_d + tb * kNgrad);  // [tb] table row, -1 = none
  int* s_first = s_row + tb;               // [tbl]
  int* s_last = s_first + tbl;             // [tbl]
  const int b = blockIdx.x;
  const int tile = batch_tile[b];
  const bool tile_ok = tile >= 0 && tile < num_tiles;
  const int groups = blockDim.x / kGroup;

  for (int r = threadIdx.x; r < tbl; r += blockDim.x) {
    s_first[r] = tb;
    s_last[r] = -1;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < tb; s += blockDim.x) {
    const long long k = (long long)b * tb + s;
    const int c = cells[k];
    const float* at = tile_ok && c >= 0 && c < g.tc ? table_row(tables, tblidx, k, b, tbl)
                                                    : nullptr;
    s_row[s] = at ? tblidx[k] : -1;
    if (!at) continue;
    atomicMin(&s_first[s_row[s]], s);
    atomicMax(&s_last[s_row[s]], s);
    const int row = tile * g.tc + c;
    const Frag f = fused_frag(at, row, g);
    const Window win = grad_window(f.xh, row, pre, g);
    float* d = s_d + s * kNgrad;
    d[kCy] = f.cy;
    d[kCz] = f.cz;
    d[kS0] = f.s0;
    d[kS1] = f.s1;
    d[kS2] = f.s2;
    d[kCov] = f.cov;
    d[kW] = f.w;
    d[kXh] = f.xh;
    d[kWin] = __int_as_float(win.a | (win.b << 16));
    d[kRow] = __int_as_float(row);
  }
  __syncthreads();
  for (int s0 = 0; s0 < tb; s0 += groups) {  // one trip count for every lane
    const int s = s0 + threadIdx.x / kGroup;
    const bool live = s < tb && s_row[s] >= 0;
    float* d = s_d + (live ? s : 0) * kNgrad;
    const int win = live ? __float_as_int(d[kWin]) : 0;
    const long long row = live ? __float_as_int(d[kRow]) : 0;
    float sa, sb;
    window_sums(gocc + row * g.n, live ? d[kXh] : 0.0f, win & 0xffff, win >> 16, g, &sa,
                &sb);
    __syncwarp();  // every lane has read d before its group's first lane writes it
    if (live && threadIdx.x % kGroup == 0) {
      d[kSa] = sa;
      d[kSb] = sb;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < tb; s += blockDim.x) {
    if (s_row[s] < 0) continue;
    float* d = s_d + s * kNgrad;
    const Frag f = {d[kCy], d[kCz], d[kS0], d[kS1], d[kS2], d[kCov], d[kW], d[kXh]};
    const int a = __float_as_int(d[kWin]) & 0xffff;
    const float dw = grad_dw(pre, __float_as_int(d[kRow]), a, d[kSa], g.n);
    const float dxh = (f.w / g.tau_x) * d[kSb];
    chain_rule(d, tables + ((long long)b * tbl + s_row[s]) * kNattr, f, dw, dxh, g);
  }
  __syncthreads();
  row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab + (long long)b * tbl * kNattr);
}

// B13 bwd. A grid over the slots, kThreads threads, a warp 32 slots. A
// lane a slot reads it and finds its window as B8 does; then, in kGroup
// rounds, kGroup lanes a slot sum the windows of 32 / kGroup slots
// (their values shuffled from the slots' lanes), and each slot's lane
// takes its sums back, adds the saturated columns from the prefix and
// writes (dw, dxh). A pad, or a slot of a batch whose tile lies outside
// the grid, writes zeros. No lane returns before the rounds, whose
// shuffles take the whole warp.
__global__ void fragment_grad_kernel(const float* __restrict__ wb,
                                     const float* __restrict__ xb,
                                     const int* __restrict__ cells,
                                     const int* __restrict__ batch_tile,
                                     const float* __restrict__ gocc,
                                     const double* __restrict__ pre, long long num_slots,
                                     int tb, int num_tiles, Geom g,
                                     float* __restrict__ dw_out,
                                     float* __restrict__ dx_out) {
  constexpr int kSlots = 32 / kGroup;  // slots a round
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int tile = k < num_slots ? batch_tile[k / tb] : -1;
  const int c = k < num_slots ? cells[k] : -1;
  const bool live = tile >= 0 && tile < num_tiles && c >= 0 && c < g.tc;
  const long long row = live ? (long long)tile * g.tc + c : 0;
  const float xh = live ? xb[k] : 0.0f;
  const Window win = live ? grad_window(xh, row, pre, g) : Window{0, 0};
  float sa = 0.0f, sb = 0.0f;
  for (int r = 0; r < kGroup; ++r) {
    const int src = r * kSlots + lane / kGroup;  // the slot this lane's group sums
    const long long row_s = __shfl_sync(0xffffffffu, row, src);
    const float xh_s = __shfl_sync(0xffffffffu, xh, src);
    const int a_s = __shfl_sync(0xffffffffu, win.a, src);
    const int b_s = __shfl_sync(0xffffffffu, win.b, src);
    float ra, rb;
    window_sums(gocc + row_s * g.n, xh_s, a_s, b_s, g, &ra, &rb);
    const int from = (lane % kSlots) * kGroup;  // the group that summed this lane's slot
    ra = __shfl_sync(0xffffffffu, ra, from);
    rb = __shfl_sync(0xffffffffu, rb, from);
    if (lane / kSlots == r) {
      sa = ra;
      sb = rb;
    }
  }
  if (k >= num_slots) return;
  dw_out[k] = live ? grad_dw(pre, row, win.a, sa, g.n) : 0.0f;
  dx_out[k] = live ? (wb[k] / g.tau_x) * sb : 0.0f;
}

}  // namespace

// B7: (B, tbl, 16) tables -> out (num_tiles * tc, n) floats, zeroed;
// only the tiles of the runs are written. `work` holds B * tb int4
// slot records.
extern "C" int vt_fused_fwd(const void* tables, const void* cells,
                            const void* tblidx, const void* batch_tile,
                            const void* run_start, int num_batches, int num_runs,
                            int tb, int tbl, int n, int tc, int num_tiles, float ox,
                            float oy, float oz, float vs, float tau_e, float tau_x,
                            void* work, void* out, void* stream) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc, 0};
  if (n >= (1 << 15)) return (int)cudaErrorInvalidValue;  // a | b << 16 in an int
  const long long slots = (long long)num_batches * tb;
  const cudaStream_t st = (cudaStream_t)stream;
  fused_window_kernel<<<(unsigned)((slots + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const float*)tables, (const int*)tblidx, (const int*)cells, (const int*)batch_tile,
      slots, tb, tbl, num_tiles, g, (int4*)work);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return accumulate((const int4*)work, (const int*)batch_tile, (const int*)run_start,
                    num_runs, tb, num_tiles, g, (float*)out, st);
}

// B8: cotangent g (num_tiles * tc, n) -> dtab (B, tbl, 16). `pre` holds
// (num_tiles * tc, n) doubles, g's row prefix.
extern "C" int vt_fused_bwd(const void* tables, const void* cells,
                            const void* tblidx, const void* batch_tile,
                            const void* gocc, int num_batches, int tb,
                            int tbl, int n, int tc, int num_tiles, float ox,
                            float oy, float oz, float vs, float tau_e,
                            float tau_x, void* pre, void* dtab, void* stream) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc, 0};
  if (n >= (1 << 15)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int e = row_prefix((const float*)gocc, (long long)num_tiles * tc, n, (double*)pre, st);
  if (e) return e;
  const size_t smem = (size_t)tb * (kNgrad + 1) * sizeof(float) + 2 * (size_t)tbl * sizeof(int);
  e = allow_smem(fused_grad_kernel, smem);
  if (e) return e;
  fused_grad_kernel<<<num_batches, kThreads, smem, st>>>(
      (const float*)tables, (const int*)tblidx, (const int*)cells, (const int*)batch_tile,
      (const float*)gocc, (const double*)pre, tb, tbl, num_tiles, g, (float*)dtab);
  return (int)cudaGetLastError();
}

// B13 fwd: per-slot (w, xh) (B, tb) -> out as for B7. `work` holds
// B * tb int4 slot records.
extern "C" int vt_fragment_fwd(const void* wb, const void* xb,
                               const void* cells, const void* batch_tile,
                               const void* run_start, int num_batches, int num_runs,
                               int tb, int n, int tc, int num_tiles, float ox,
                               float vs, float tau_x, void* work, void* out,
                               void* stream) {
  const Geom g = {ox, 0.0f, 0.0f, vs, 1.0f, tau_x, n, tc, 0};
  if (n >= (1 << 15)) return (int)cudaErrorInvalidValue;
  const long long slots = (long long)num_batches * tb;
  const cudaStream_t st = (cudaStream_t)stream;
  fragment_window_kernel<<<(unsigned)((slots + kThreads - 1) / kThreads), kThreads, 0,
                           st>>>((const float*)wb, (const float*)xb, (const int*)cells,
                                 (const int*)batch_tile, slots, tb, num_tiles, g,
                                 (int4*)work);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return accumulate((const int4*)work, (const int*)batch_tile, (const int*)run_start,
                    num_runs, tb, num_tiles, g, (float*)out, st);
}

// B13 bwd: cotangent g (num_tiles * tc, n) -> per-slot (dw, dxh), each
// (B, tb). `pre` holds (num_tiles * tc, n) doubles, g's row prefix.
extern "C" int vt_fragment_bwd(const void* wb, const void* xb,
                               const void* cells, const void* batch_tile,
                               const void* gocc, int num_batches, int tb,
                               int n, int tc, int num_tiles, float ox,
                               float vs, float tau_x, void* pre, void* dw, void* dx,
                               void* stream) {
  const Geom g = {ox, 0.0f, 0.0f, vs, 1.0f, tau_x, n, tc, 0};
  if (n >= (1 << 15)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = row_prefix((const float*)gocc, (long long)num_tiles * tc, n, (double*)pre, st);
  if (e) return e;
  const long long slots = (long long)num_batches * tb;
  const unsigned blocks = (unsigned)((slots + kThreads - 1) / kThreads);
  fragment_grad_kernel<<<blocks, kThreads, 0, st>>>(
      (const float*)wb, (const float*)xb, (const int*)cells, (const int*)batch_tile,
      (const float*)gocc, (const double*)pre, slots, tb, num_tiles, g, (float*)dw,
      (float*)dx);
  return (int)cudaGetLastError();
}
