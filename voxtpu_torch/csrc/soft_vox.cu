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
// dxh = (w / tau_x) * sum_x g[cell, x] * sig * (1 - sig), a group of
// lanes a slot (B13: a warp over the row; B8: kGroup lanes over the
// window), its lanes striding over x, a fixed shuffle tree for the sum.
// B13 writes (dw, dxh) per slot. B8 chain-rules them to the 13
// coefficient cotangents and sums those per table row: one block per
// batch, so no two blocks write one row, and each row's sum runs over
// the batch's slots in slot order.
//
// The fused kernels (B7, B8) compute a slot's sigmoid only inside its
// transition window [a, b) of columns (`slot_window` in soft_common.cuh,
// which says why left of a the sigmoid is exactly 1.0f and from b on a
// forward term rounds to 0); B13 evaluates every (slot, column) pair.
// B7 adds the saturated columns' integer __float2ll_rn(w * 2^40), the
// very integer the full row adds there, through a per-cell difference
// along the chunk and one scan, and drops the zero columns: its 64-bit
// sums, and so its output, are bitwise those of the full row. A slot
// whose w or xh is not finite, or |w| > 1, takes the whole row, so
// that its NaN marks fall where the full row puts them. B8 takes the
// saturated columns' sum of g from a float64 prefix of g's rows
// (`row_prefix_kernel`, one pass a call) and drops the terms right of
// b (each below 2^-41 |g[x]|); a row whose total is not finite, or a
// slot whose xh is not finite, takes the whole row. At the default
// tau_x of half a voxel a window is ~24 columns of 512.
//
// What bounds them on this card: the sigmoid of every (slot, column)
// pair in the window (kGroup lanes a slot, ~23 columns), each with a
// 64-bit shared add (two native 32-bit atomics) in the forward and a
// read of the cotangent in the backward; B7's record pass (16 bytes a
// slot) and each chunk block's two reads of its run's records; B8's
// prefix (4 bytes read and 8 written a grid cell) and its per-slot
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
constexpr int kLanes = 4;   // slot lanes per B13 fwd block (kXC x kLanes threads)
constexpr int kThreads = 256;
constexpr int kFwdThreads = 512;  // B7's accumulation: 16 warps at 3 blocks an SM

// A fused slot's fragment from its global cell (z * n + y).
__device__ __forceinline__ Frag fused_frag(const float* __restrict__ at,
                                           int gcell, const Geom& g) {
  return frag_at(at, center(g.oy, gcell % g.n, g.vs),
                 center(g.oz, gcell / g.n, g.vs), g);
}

// ---------------------------------------------------------------------
// B7: a record pass, then the windowed accumulation.
// ---------------------------------------------------------------------

// One thread a slot: its record (`slot_record` over the row).
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
  rec[k] = at ? slot_record(c, fused_frag(at, tile * g.tc + c, g), 0, g.n, g)
              : make_int4(-1, 0, 0, 0);
}

// Grid (num_runs * chunks), kFwdThreads threads: block (run, chunk) sums
// columns [x0, x1) of the run's tile (`accumulate_windows`).
__global__ void fused_accumulate_kernel(const int4* __restrict__ rec,
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

// ---------------------------------------------------------------------
// B8: a row prefix pass, then the windowed slot gradients.
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

// Grid (num_batches), kThreads threads. A thread a slot rebuilds its
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
  const int glane = threadIdx.x % kGroup;
  const int groups = blockDim.x / kGroup;
  const bool geom_ok = window_geom(g);

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
    Window win = {0, g.n};
    if (isfinite(f.xh) && geom_ok && isfinite(pre[((long long)row + 1) * g.n - 1]))
      win = slot_window(f.xh, g);
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
    float sa = 0.0f, sb = 0.0f;
    if (live) {
      const float xh = d[kXh];
      const int win = __float_as_int(d[kWin]);
      const float* grow = gocc + (long long)__float_as_int(d[kRow]) * g.n;
      for (int x = (win & 0xffff) + glane; x < (win >> 16); x += kGroup) {
        const float sig = sigmoid(profile_arg(xh, x, g));
        const float ps = grow[x] * sig;
        sa += ps;
        sb += ps * (1.0f - sig);
      }
    }
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    __syncwarp();  // every lane has read d before its group's first lane writes it
    if (live && glane == 0) {
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
    const long long row = __float_as_int(d[kRow]);
    const double left = a > 0 ? pre[row * g.n + a - 1] : 0.0;
    const float dw = (float)(left + (double)d[kSa]);
    const float dxh = (f.w / g.tau_x) * d[kSb];
    chain_rule(d, tables + ((long long)b * tbl + s_row[s]) * kNattr, f, dw, dxh, g);
  }
  __syncthreads();
  row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab + (long long)b * tbl * kNattr);
}

// ---------------------------------------------------------------------
// B13: every (slot, column) pair.
// ---------------------------------------------------------------------

// B13 fwd. Grid (runs, ceil(n / kXC)), kXC * kLanes threads: a thread
// owns column threadIdx.x % kXC and every kLanes-th slot (one slot lane
// per pair of warps, so a warp reads one slot at a time). A run is the
// batches [run_start[r], run_start[r + 1]) of one tile. Per batch the
// block first stages every slot's (cell, w, xh) in shared memory.
__global__ void fragment_accumulate_kernel(const float* __restrict__ wb,
                                           const float* __restrict__ xb,
                                           const int* __restrict__ cells,
                                           const int* __restrict__ batch_tile,
                                           const int* __restrict__ run_start, int tb,
                                           int num_tiles, Geom g,
                                           float* __restrict__ out) {
  extern __shared__ u64 acc[];                 // [tc][kXC] fixed point
  float* s_w = (float*)(acc + g.tc * kXC);     // [tb]
  float* s_xh = s_w + tb;                      // [tb]
  int* s_cell = (int*)(s_xh + tb);             // [tb]
  unsigned* s_bad = (unsigned*)(s_cell + tb);  // [tc / 32][kXC] cell bits
  const int b0 = run_start[blockIdx.x];
  const int b1 = run_start[blockIdx.x + 1];
  if (b1 <= b0) return;
  const int tile = batch_tile[b0];
  if (tile < 0 || tile >= num_tiles) return;  // uniform per block
  const int col = threadIdx.x % kXC;
  const int lane = threadIdx.x / kXC;
  const int x = blockIdx.y * kXC + col;
  const float cx = center(g.ox, x, g.vs);

  for (int i = threadIdx.x; i < g.tc * kXC; i += blockDim.x) acc[i] = 0ull;
  for (int i = threadIdx.x; i < bad_words(g.tc) * kXC; i += blockDim.x) s_bad[i] = 0u;
  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // the previous batch's staging is consumed
    for (int s = threadIdx.x; s < tb; s += blockDim.x) {
      const long long k = (long long)b * tb + s;
      int c = cells[k];
      float w = 0.0f, xh = 0.0f;
      if (c >= 0 && c < g.tc) {
        w = wb[k];
        xh = xb[k];
      } else {
        c = -1;
      }
      s_cell[s] = c;
      s_w[s] = w;
      s_xh[s] = xh;
    }
    __syncthreads();
    for (int s = lane; s < tb; s += kLanes) {
      const int c = s_cell[s];
      if (c < 0) continue;  // uniform per warp: its threads read one slot
      const float v = s_w[s] * sigmoid((s_xh[s] - cx) / g.tau_x);
      fix_add(&acc[c * kXC + col], &s_bad[(c >> 5) * kXC + col], 1u << (c & 31), v);
    }
  }
  __syncthreads();
  if (x < g.n) {
    float* o = out + (long long)tile * g.tc * g.n + x;
    for (int c = lane; c < g.tc; c += kLanes)
      o[(long long)c * g.n] =
          fix_value(acc[c * kXC + col], (s_bad[(c >> 5) * kXC + col] >> (c & 31)) & 1u);
  }
}

// B13 bwd. Grid (num_batches), kThreads threads, one warp per slot at
// a time.
__global__ void fragment_grad_kernel(const float* __restrict__ wb,
                                     const float* __restrict__ xb,
                                     const int* __restrict__ cells,
                                     const int* __restrict__ batch_tile,
                                     const float* __restrict__ gocc, int tb,
                                     int num_tiles, Geom g,
                                     float* __restrict__ dw_out,
                                     float* __restrict__ dx_out) {
  const int b = blockIdx.x;
  const int tile = batch_tile[b];
  const bool tile_ok = tile >= 0 && tile < num_tiles;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int s = threadIdx.x >> 5; s < tb; s += nwarps) {
    const long long k = (long long)b * tb + s;
    const int c = cells[k];
    const bool live = tile_ok && c >= 0 && c < g.tc;
    float w = 0.0f;
    float sa = 0.0f, sb = 0.0f;
    if (live) {  // uniform per warp
      w = wb[k];
      const float xh = xb[k];
      const float* grow = gocc + ((long long)tile * g.tc + c) * g.n;
      for (int x = lane; x < g.n; x += 32) {
        const float sig = sigmoid((xh - center(g.ox, x, g.vs)) / g.tau_x);
        const float ps = grow[x] * sig;
        sa += ps;
        sb += ps * (1.0f - sig);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    if (lane != 0) continue;
    dw_out[k] = sa;
    dx_out[k] = (w / g.tau_x) * sb;
  }
}

size_t fragment_fwd_smem(int tc, int tb) {
  return (size_t)tc * kXC * sizeof(u64) + 3 * (size_t)tb * sizeof(float) +
         (size_t)bad_words(tc) * kXC * sizeof(unsigned);
}

// Lift a kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
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
  int e = (int)cudaGetLastError();
  if (e) return e;
  const size_t smem = acc_smem_bytes(tc, tb);
  e = allow_smem(fused_accumulate_kernel, smem);
  if (e) return e;
  const int chunks = (n + kXC - 1) / kXC;
  fused_accumulate_kernel<<<(unsigned)((long long)num_runs * chunks), kFwdThreads, smem,
                            st>>>(
      (const int4*)work, (const int*)batch_tile, (const int*)run_start, tb, num_tiles, chunks,
      g, (float*)out);
  return (int)cudaGetLastError();
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
  const long long rows = (long long)num_tiles * tc;
  row_prefix_kernel<<<(unsigned)((rows * 32 + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const float*)gocc, rows, n, (double*)pre);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const size_t smem = (size_t)tb * (kNgrad + 1) * sizeof(float) + 2 * (size_t)tbl * sizeof(int);
  e = allow_smem(fused_grad_kernel, smem);
  if (e) return e;
  fused_grad_kernel<<<num_batches, kThreads, smem, st>>>(
      (const float*)tables, (const int*)tblidx, (const int*)cells, (const int*)batch_tile,
      (const float*)gocc, (const double*)pre, tb, tbl, num_tiles, g, (float*)dtab);
  return (int)cudaGetLastError();
}

// B13 fwd: per-slot (w, xh) (B, tb) -> out as for B7.
extern "C" int vt_fragment_fwd(const void* wb, const void* xb,
                               const void* cells, const void* batch_tile,
                               const void* run_start, int num_runs, int tb,
                               int n, int tc, int num_tiles, float ox,
                               float vs, float tau_x, void* out,
                               void* stream) {
  const Geom g = {ox, 0.0f, 0.0f, vs, 1.0f, tau_x, n, tc, 0};
  const size_t smem = fragment_fwd_smem(tc, tb);
  const int e = allow_smem(fragment_accumulate_kernel, smem);
  if (e) return e;
  const dim3 grid(num_runs, (n + kXC - 1) / kXC);
  fragment_accumulate_kernel<<<grid, kXC * kLanes, smem, (cudaStream_t)stream>>>(
      (const float*)wb, (const float*)xb, (const int*)cells, (const int*)batch_tile,
      (const int*)run_start, tb, num_tiles, g, (float*)out);
  return (int)cudaGetLastError();
}

// B13 bwd: cotangent g -> per-slot (dw, dxh), each (B, tb).
extern "C" int vt_fragment_bwd(const void* wb, const void* xb,
                               const void* cells, const void* batch_tile,
                               const void* gocc, int num_batches, int tb,
                               int n, int tc, int num_tiles, float ox,
                               float vs, float tau_x, void* dw, void* dx,
                               void* stream) {
  const Geom g = {ox, 0.0f, 0.0f, vs, 1.0f, tau_x, n, tc, 0};
  fragment_grad_kernel<<<num_batches, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)wb, (const float*)xb, (const int*)cells, (const int*)batch_tile,
      (const float*)gocc, tb, num_tiles, g, (float*)dw, (float*)dx);
  return (int)cudaGetLastError();
}
