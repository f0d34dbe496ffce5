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
// associative, so kLanes slot lanes add with shared-memory atomics in
// any order and the sum stays deterministic; it is rounded to float
// once. Per batch the block first stages every slot's (cell, w, xh) in
// shared memory, computed once per slot.
//
// Backward (B8, B13 bwd): per slot, dw = sum_x g[cell, x] * sig and
// dxh = (w / tau_x) * sum_x g[cell, x] * sig * (1 - sig). One warp per
// slot, its lanes striding over x (coalesced reads of the cotangent
// row), a fixed shuffle tree for the sum. B13 writes (dw, dxh) per
// slot. B8 chain-rules them to the 13 coefficient cotangents and sums
// those per table row: one block per batch, so no two blocks write one
// row, and each row's sum runs over the batch's slots in slot order.
//
// What bounds them on this card: the sigmoid of every (slot, column)
// pair, F x N of them (~1e10 for 20M fragments at N = 512), each with
// a shared-memory read-modify-write in the forward and a read of the
// cotangent (from L1/L2: a tile's rows are read by all its slots) in
// the backward. The library is built with -fmad=false and the
// coefficient, x-hit and chain-rule arithmetic is spelled in voxtpu's
// order, so every operation rounds on its own.

#include <cuda_runtime.h>

namespace {

constexpr int kXC = 64;     // columns per forward block
constexpr int kLanes = 4;   // slot lanes per forward block (kXC x kLanes threads)
// Forward terms in units of 2^-40: |w * sig| <= 1 (w is a coverage
// times a facing sign), so a 64-bit sum holds 2^23 terms, and rounding a
// term costs at most 2^-41. A term that is not in [-1, 1] (NaN, inf) has
// no fixed-point value: it marks its cell and column, which read NaN.
constexpr float kFix = 0x1p40f;
constexpr float kUnfix = 0x1p-40f;
constexpr int kNattr = 16;  // coefficient table row width
constexpr int kNgrad = 13;  // coefficient cotangents per slot
constexpr int kBwdThreads = 256;

__host__ __device__ constexpr int bad_words(int tc) { return (tc + 31) / 32; }

struct Geom {
  float ox, oy, oz, vs, tau_e, tau_x;
  int n, tc;
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Cell-centre coordinate o + (i * vs + vs * 0.5).
__device__ __forceinline__ float center(float o, int i, float vs) {
  return o + ((float)i * vs + vs * 0.5f);
}

// A fused slot's fragment, rebuilt from its triangle's table row `at`
// (layout: (u, v, w) of the three edges, P, Q, R, wmul) and its global
// cell (z * n + y); `_fused_fwd_kernel` lines 257-261.
struct Frag {
  float cy, cz, s0, s1, s2, cov, w, xh;
};

__device__ __forceinline__ Frag fused_frag(const float* __restrict__ at,
                                           int gcell, const Geom& g) {
  Frag f;
  f.cy = center(g.oy, gcell % g.n, g.vs);
  f.cz = center(g.oz, gcell / g.n, g.vs);
  f.s0 = sigmoid((at[0] * f.cz + at[1] * f.cy + at[2]) / g.tau_e);
  f.s1 = sigmoid((at[3] * f.cz + at[4] * f.cy + at[5]) / g.tau_e);
  f.s2 = sigmoid((at[6] * f.cz + at[7] * f.cy + at[8]) / g.tau_e);
  f.cov = f.s0 * f.s1 * f.s2;
  f.w = at[12] * f.cov;
  f.xh = at[9] - at[10] * f.cy - at[11] * f.cz;
  return f;
}

// The slot's table row, or nullptr for a pad slot or an index outside
// the table (inert, never read out of bounds).
__device__ __forceinline__ const float* table_row(const float* tables,
                                                  const int* tblidx,
                                                  long long k, int b,
                                                  int tbl) {
  const int idx = tblidx[k];
  if (idx < 0 || idx >= tbl) return nullptr;
  return tables + ((long long)b * tbl + idx) * kNattr;
}

// B7 / B13 fwd. Grid (runs, ceil(n / kXC)), kXC * kLanes threads: a
// thread owns column threadIdx.x % kXC and every kLanes-th slot (one
// slot lane per pair of warps, so a warp reads one slot at a time). A
// run is the batches [run_start[r], run_start[r + 1]) of one tile.
template <bool kFused>
__global__ void accumulate_kernel(const float* __restrict__ tables,
                                  const int* __restrict__ tblidx,
                                  const float* __restrict__ wb,
                                  const float* __restrict__ xb,
                                  const int* __restrict__ cells,
                                  const int* __restrict__ batch_tile,
                                  const int* __restrict__ run_start, int tb,
                                  int tbl, int num_tiles, Geom g,
                                  float* __restrict__ out) {
  extern __shared__ unsigned long long acc[];  // [tc][kXC] fixed point
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
        if (kFused) {
          const float* at = table_row(tables, tblidx, k, b, tbl);
          if (at) {
            const Frag f = fused_frag(at, tile * g.tc + c, g);
            w = f.w;
            xh = f.xh;
          } else {
            c = -1;
          }
        } else {
          w = wb[k];
          xh = xb[k];
        }
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
      if (fabsf(v) <= 1.0f)
        atomicAdd(&acc[c * kXC + col], (unsigned long long)__float2ll_rn(v * kFix));
      else
        atomicOr(&s_bad[(c >> 5) * kXC + col], 1u << (c & 31));
    }
  }
  __syncthreads();
  if (x < g.n) {
    float* o = out + (long long)tile * g.tc * g.n + x;
    for (int c = lane; c < g.tc; c += kLanes)
      o[(long long)c * g.n] = (s_bad[(c >> 5) * kXC + col] >> (c & 31)) & 1u
                                  ? __int_as_float(0x7fffffff)
                                  : __ll2float_rn((long long)acc[c * kXC + col]) * kUnfix;
  }
}

// B8 / B13 bwd. Grid (num_batches), kBwdThreads threads, one warp per
// slot at a time.
template <bool kFused>
__global__ void slot_grad_kernel(const float* __restrict__ tables,
                                 const int* __restrict__ tblidx,
                                 const float* __restrict__ wb,
                                 const float* __restrict__ xb,
                                 const int* __restrict__ cells,
                                 const int* __restrict__ batch_tile,
                                 const float* __restrict__ gocc, int tb,
                                 int tbl, int num_tiles, Geom g,
                                 float* __restrict__ dtab,
                                 float* __restrict__ dw_out,
                                 float* __restrict__ dx_out) {
  extern __shared__ float smem[];
  float* s_d = smem;                       // [tb][kNgrad] (fused)
  int* s_row = (int*)(s_d + tb * kNgrad);  // [tb] table row, -1 = none
  const int b = blockIdx.x;
  const int tile = batch_tile[b];
  const bool tile_ok = tile >= 0 && tile < num_tiles;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int s = threadIdx.x >> 5; s < tb; s += nwarps) {
    const long long k = (long long)b * tb + s;
    const int c = cells[k];
    const float* at = nullptr;
    bool live = tile_ok && c >= 0 && c < g.tc;
    if (kFused && live) {
      at = table_row(tables, tblidx, k, b, tbl);
      live = at != nullptr;
    }
    Frag f = {};
    float w = 0.0f, xh = 0.0f;
    float sa = 0.0f, sb = 0.0f;
    if (live) {  // uniform per warp
      if (kFused) {
        f = fused_frag(at, tile * g.tc + c, g);
        w = f.w;
        xh = f.xh;
      } else {
        w = wb[k];
        xh = xb[k];
      }
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
    const float dw = sa;
    const float dxh = (w / g.tau_x) * sb;
    if (!kFused) {
      dw_out[k] = dw;
      dx_out[k] = dxh;
      continue;
    }
    // Chain rule to the coefficients, `_fused_bwd_kernel` lines 348-360.
    float* d = s_d + s * kNgrad;
    if (!live) {
      s_row[s] = -1;
      continue;
    }
    const float dcov = dw * at[12];
    const float de0 = dcov * f.cov * (1.0f - f.s0) / g.tau_e;
    const float de1 = dcov * f.cov * (1.0f - f.s1) / g.tau_e;
    const float de2 = dcov * f.cov * (1.0f - f.s2) / g.tau_e;
    d[0] = de0 * f.cz;
    d[1] = de0 * f.cy;
    d[2] = de0;
    d[3] = de1 * f.cz;
    d[4] = de1 * f.cy;
    d[5] = de1;
    d[6] = de2 * f.cz;
    d[7] = de2 * f.cy;
    d[8] = de2;
    d[9] = dxh;
    d[10] = -dxh * f.cy;
    d[11] = -dxh * f.cz;
    d[12] = dw * f.cov;
    s_row[s] = tblidx[k];
  }
  if (!kFused) return;
  __syncthreads();
  // One thread per table row: its slots (contiguous in the plan) in
  // slot order.
  for (int r = threadIdx.x; r < tbl; r += blockDim.x) {
    float sum[kNgrad];
    for (int j = 0; j < kNgrad; ++j) sum[j] = 0.0f;
    for (int s = 0; s < tb; ++s) {
      if (s_row[s] != r) continue;
      for (int j = 0; j < kNgrad; ++j) sum[j] += s_d[s * kNgrad + j];
    }
    float* o = dtab + ((long long)b * tbl + r) * kNattr;
    for (int j = 0; j < kNgrad; ++j) o[j] = sum[j];
    for (int j = kNgrad; j < kNattr; ++j) o[j] = 0.0f;
  }
}

size_t fwd_smem(int tc, int tb) {
  return (size_t)tc * kXC * sizeof(unsigned long long) +
         3 * (size_t)tb * sizeof(float) +
         (size_t)bad_words(tc) * kXC * sizeof(unsigned);
}

template <bool kFused>
int launch_fwd(const void* tables, const void* tblidx, const void* wb,
               const void* xb, const void* cells, const void* batch_tile,
               const void* run_start, int num_runs, int tb, int tbl,
               int num_tiles, Geom g, void* out, void* stream) {
  const size_t smem = fwd_smem(g.tc, tb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        accumulate_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(num_runs, (g.n + kXC - 1) / kXC);
  accumulate_kernel<kFused><<<grid, kXC * kLanes, smem, (cudaStream_t)stream>>>(
      (const float*)tables, (const int*)tblidx, (const float*)wb,
      (const float*)xb, (const int*)cells, (const int*)batch_tile,
      (const int*)run_start, tb, tbl, num_tiles, g, (float*)out);
  return (int)cudaGetLastError();
}

template <bool kFused>
int launch_bwd(const void* tables, const void* tblidx, const void* wb,
               const void* xb, const void* cells, const void* batch_tile,
               const void* gocc, int num_batches, int tb, int tbl,
               int num_tiles, Geom g, void* dtab, void* dw, void* dx,
               void* stream) {
  const size_t smem = (size_t)tb * (kNgrad + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slot_grad_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  slot_grad_kernel<kFused><<<num_batches, kBwdThreads, smem,
                             (cudaStream_t)stream>>>(
      (const float*)tables, (const int*)tblidx, (const float*)wb,
      (const float*)xb, (const int*)cells, (const int*)batch_tile,
      (const float*)gocc, tb, tbl, num_tiles, g, (float*)dtab, (float*)dw,
      (float*)dx);
  return (int)cudaGetLastError();
}

}  // namespace

// B7: (B, tbl, 16) tables -> out (num_tiles * tc, n) floats, zeroed;
// only the tiles of the runs are written.
extern "C" int vt_fused_fwd(const void* tables, const void* cells,
                            const void* tblidx, const void* batch_tile,
                            const void* run_start, int num_runs, int tb,
                            int tbl, int n, int tc, int num_tiles, float ox,
                            float oy, float oz, float vs, float tau_e,
                            float tau_x, void* out, void* stream) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc};
  return launch_fwd<true>(tables, tblidx, nullptr, nullptr, cells, batch_tile,
                          run_start, num_runs, tb, tbl, num_tiles, g, out,
                          stream);
}

// B8: cotangent g (num_tiles * tc, n) -> dtab (B, tbl, 16).
extern "C" int vt_fused_bwd(const void* tables, const void* cells,
                            const void* tblidx, const void* batch_tile,
                            const void* gocc, int num_batches, int tb,
                            int tbl, int n, int tc, int num_tiles, float ox,
                            float oy, float oz, float vs, float tau_e,
                            float tau_x, void* dtab, void* stream) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc};
  return launch_bwd<true>(tables, tblidx, nullptr, nullptr, cells, batch_tile,
                          gocc, num_batches, tb, tbl, num_tiles, g, dtab,
                          nullptr, nullptr, stream);
}

// B13 fwd: per-slot (w, xh) (B, tb) -> out as for B7.
extern "C" int vt_fragment_fwd(const void* wb, const void* xb,
                               const void* cells, const void* batch_tile,
                               const void* run_start, int num_runs, int tb,
                               int n, int tc, int num_tiles, float ox,
                               float vs, float tau_x, void* out,
                               void* stream) {
  const Geom g = {ox, 0.0f, 0.0f, vs, 1.0f, tau_x, n, tc};
  return launch_fwd<false>(nullptr, nullptr, wb, xb, cells, batch_tile,
                           run_start, num_runs, tb, 0, num_tiles, g, out,
                           stream);
}

// B13 bwd: cotangent g -> per-slot (dw, dxh), each (B, tb).
extern "C" int vt_fragment_bwd(const void* wb, const void* xb,
                               const void* cells, const void* batch_tile,
                               const void* gocc, int num_batches, int tb,
                               int n, int tc, int num_tiles, float ox,
                               float vs, float tau_x, void* dw, void* dx,
                               void* stream) {
  const Geom g = {ox, 0.0f, 0.0f, vs, 1.0f, tau_x, n, tc};
  return launch_bwd<false>(nullptr, nullptr, wb, xb, cells, batch_tile, gocc,
                           num_batches, tb, 0, num_tiles, g, nullptr, dw, dx,
                           stream);
}
