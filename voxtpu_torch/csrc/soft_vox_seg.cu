// Segmented soft voxelization kernels (the seg engine), for Hopper
// (sm_90a).
//
// Replaces three Pallas TPU kernels of voxtpu/ops/soft_vox_seg.py:
//   B9   _seg_fwd_kernel      (vt_seg_fwd)
//   B10  _seg_combine_kernel  (vt_seg_combine)
//   B11  _seg_bwd_kernel      (vt_seg_bwd)
//
// The fused engine (soft_vox.cu, B7/B8) evaluates each slot's profile
// w * sigmoid((xh - cx) / tau_x) over all n columns of its cell's row.
// The seg engine evaluates it over one 128-column panel [p0, p0 + 128),
// chosen on the host so that xh lies >= 32 columns inside it: left of
// the panel the sigmoid is 1.0 in float32, so those columns get w as a
// carry; right of it they get nothing. Tiles are square tz x ty YZ
// patches: tile t, local cell c are the cell
//   y = (t % (n / ty)) * ty + c % ty,  z = (t / (n / ty)) * tz + c / ty.
// A (tile, panel) key's batches form one run of the plan.
//
// B9: one block per (run, 64-column half of the panel), 64 columns x 4
// slot lanes, as B7 runs one block per (tile run, 64-column chunk): per
// batch the block stages each slot's (cell, w, xh) in shared memory and
// adds every term as a 64-bit fixed-point integer (soft_common.cuh), so
// the sum is exact, order-free and deterministic. The half-0 block also
// sums each cell's weights into the run's carry, also in fixed point.
// Each run writes its own output block whole (family A, p0 % 128 == 0,
// into out_a block p0 / 128; family B into out_b block (p0 - 64) / 128)
// and its carry row, so no global atomics; unvisited blocks keep the
// wrapper's zeros.
//
// B10: one thread per voxel of the dense (z, y, x) grid:
//   out = (A[j][l] + B') + pre[x / 64],  j = x / 128, l = x % 128,
// with B' = B[j - 1][l + 64] for l < 64 (0 for j = 0) and B[j][l - 64]
// otherwise: voxtpu's combine, the same association, so bitwise equal
// to the plain version (adds only; the library is built with
// -fmad=false).
//
// B11: B8's structure over the panel: one block per batch, one warp per
// slot, lanes over the 128 panel columns of the cotangent read in
// place in (z, y, x) layout; dw = sum(g * sig) + gpre (the sum of g left
// of the panel), dxh = (w / tau_x) * sum(g * sig * (1 - sig)), the 13
// chain-ruled cotangents summed per table row in slot order.
//
// What bounds them on this card: B9 and B11 compute the sigmoid of every
// (slot, panel column) pair, 128 per slot (~3.2e9 for 25M slots at
// n = 512, against n per slot in B7/B8): three special-function
// operations a pair (the division by tau_x, expf, the reciprocal). B9
// also writes both family arrays whole (2 x 537 MB at n = 512) and B11
// reads the panel columns of g (each cell's row by all of its slots,
// from L1/L2). B10 moves bytes: reads A, B and the carry prefix, writes
// the grid.

#include "soft_common.cuh"

namespace {

constexpr int kPanel = 128;   // panel width
constexpr int kLattice = 64;  // panel placement granularity
constexpr int kHalf = 64;     // columns per B9 block
constexpr int kLanes = 4;     // slot lanes per B9 block (kHalf x kLanes threads)
constexpr int kBwdThreads = 256;
constexpr int kCombineThreads = 256;

// The cell centre of local cell c of square tile `tile`.
__device__ __forceinline__ void tile_cell(int tile, int c, const Geom& g, int* gy,
                                          int* gz) {
  const int ty = g.tc / g.tz;
  const int tyn = g.n / ty;
  *gy = (tile % tyn) * ty + c % ty;
  *gz = (tile / tyn) * g.tz + c / ty;
}

__device__ __forceinline__ bool panel_ok(int p0, int n) {
  return p0 >= 0 && p0 % kLattice == 0 && p0 + kPanel <= n;
}

// B9. Grid (runs, 2), kHalf * kLanes threads.
__global__ void seg_fwd_kernel(const float* __restrict__ tables,
                               const int* __restrict__ cells,
                               const int* __restrict__ tblidx,
                               const int* __restrict__ batch_tile,
                               const int* __restrict__ batch_panel,
                               const int* __restrict__ run_start, int tb, int tbl,
                               int num_tiles, Geom g, float* __restrict__ out_a,
                               float* __restrict__ out_b, float* __restrict__ carry) {
  extern __shared__ unsigned long long acc[];   // [tc][kHalf] fixed point
  unsigned long long* cacc = acc + g.tc * kHalf;  // [tc] carry, fixed point
  float* s_w = (float*)(cacc + g.tc);           // [tb]
  float* s_xh = s_w + tb;                       // [tb]
  int* s_cell = (int*)(s_xh + tb);              // [tb]
  unsigned* s_bad = (unsigned*)(s_cell + tb);   // [tc / 32][kHalf] cell bits
  unsigned* s_cbad = s_bad + bad_words(g.tc) * kHalf;  // [tc / 32]
  const int b0 = run_start[blockIdx.x];
  const int b1 = run_start[blockIdx.x + 1];
  if (b1 <= b0) return;
  const int tile = batch_tile[b0];
  const int p0 = batch_panel[b0];
  // A run outside the output is skipped (uniform per block).
  if (tile < 0 || tile >= num_tiles || !panel_ok(p0, g.n)) return;
  const int half = blockIdx.y;
  const int col = threadIdx.x % kHalf;
  const int lane = threadIdx.x / kHalf;
  const float cx = center(g.ox, p0 + half * kHalf + col, g.vs);

  for (int i = threadIdx.x; i < g.tc * kHalf; i += blockDim.x) acc[i] = 0ull;
  for (int i = threadIdx.x; i < g.tc; i += blockDim.x) cacc[i] = 0ull;
  for (int i = threadIdx.x; i < bad_words(g.tc) * (kHalf + 1); i += blockDim.x)
    s_bad[i] = 0u;
  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // the previous batch's staging is consumed
    for (int s = threadIdx.x; s < tb; s += blockDim.x) {
      const long long k = (long long)b * tb + s;
      int c = cells[k];
      float w = 0.0f, xh = 0.0f;
      const float* at = (c >= 0 && c < g.tc) ? table_row(tables, tblidx, k, b, tbl)
                                             : nullptr;
      if (at) {
        int gy, gz;
        tile_cell(tile, c, g, &gy, &gz);
        const Frag f = frag_at(at, center(g.oy, gy, g.vs), center(g.oz, gz, g.vs), g);
        w = f.w;
        xh = f.xh;
        if (half == 0) fix_add(&cacc[c], &s_cbad[c >> 5], 1u << (c & 31), w);
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
      fix_add(&acc[c * kHalf + col], &s_bad[(c >> 5) * kHalf + col], 1u << (c & 31), v);
    }
  }
  __syncthreads();
  const bool fam_b = (p0 / kLattice) % 2 == 1;
  const int blk = fam_b ? (p0 - kLattice) / kPanel : p0 / kPanel;
  const int nblk = g.n / kPanel;
  float* o = (fam_b ? out_b : out_a) +
             ((long long)tile * nblk + blk) * g.tc * kPanel + half * kHalf + col;
  for (int c = lane; c < g.tc; c += kLanes)
    o[(long long)c * kPanel] =
        fix_value(acc[c * kHalf + col], (s_bad[(c >> 5) * kHalf + col] >> (c & 31)) & 1u);
  if (half == 0) {
    float* cr = carry + ((long long)tile * (g.n / kLattice) + p0 / kLattice) * g.tc;
    for (int c = threadIdx.x; c < g.tc; c += blockDim.x)
      cr[c] = fix_value(cacc[c], (s_cbad[c >> 5] >> (c & 31)) & 1u);
  }
}

// B10. One thread per voxel.
__global__ void seg_combine_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   const float* __restrict__ pre, int n, int tc,
                                   int tz, float* __restrict__ out) {
  const long long nn = (long long)n * n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nn * n) return;
  const int x = (int)(i % n);
  const int y = (int)((i / n) % n);
  const int z = (int)(i / nn);
  const int ty = tc / tz;
  const int t = (z / tz) * (n / ty) + y / ty;
  const int c = (z % tz) * ty + y % ty;
  const int j = x / kPanel;
  const int l = x % kPanel;
  const long long row = ((long long)t * (n / kPanel) + j) * tc + c;
  float bv = 0.0f;
  if (l >= kLattice)
    bv = b[row * kPanel + (l - kLattice)];
  else if (j > 0)
    bv = b[(row - tc) * kPanel + (l + kLattice)];
  const float pv = pre[((long long)t * (n / kLattice) + x / kLattice) * tc + c];
  out[i] = __fadd_rn(__fadd_rn(a[row * kPanel + l], bv), pv);
}

// B11. Grid (num_batches), kBwdThreads threads, one warp per slot at a
// time.
__global__ void seg_bwd_kernel(const float* __restrict__ tables,
                               const int* __restrict__ cells,
                               const int* __restrict__ tblidx,
                               const int* __restrict__ batch_tile,
                               const int* __restrict__ batch_panel,
                               const float* __restrict__ gocc,
                               const float* __restrict__ gpre, int tb, int tbl,
                               int num_tiles, Geom g, float* __restrict__ dtab) {
  extern __shared__ float smem[];
  float* s_d = smem;                       // [tb][kNgrad]
  int* s_row = (int*)(s_d + tb * kNgrad);  // [tb] table row, -1 = none
  const int b = blockIdx.x;
  const int tile = batch_tile[b];
  const int p0 = batch_panel[b];
  const bool batch_ok = tile >= 0 && tile < num_tiles && panel_ok(p0, g.n);
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int s = threadIdx.x >> 5; s < tb; s += nwarps) {
    const long long k = (long long)b * tb + s;
    const int c = cells[k];
    const float* at = (batch_ok && c >= 0 && c < g.tc)
                          ? table_row(tables, tblidx, k, b, tbl) : nullptr;
    Frag f = {};
    long long cell = 0;
    float sa = 0.0f, sb = 0.0f;
    if (at) {  // uniform per warp
      int gy, gz;
      tile_cell(tile, c, g, &gy, &gz);
      f = frag_at(at, center(g.oy, gy, g.vs), center(g.oz, gz, g.vs), g);
      cell = (long long)gz * g.n + gy;
      const float* grow = gocc + cell * g.n;
      for (int x = p0 + lane; x < p0 + kPanel; x += 32) {
        const float sig = sigmoid((f.xh - center(g.ox, x, g.vs)) / g.tau_x);
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
    if (!at) {
      s_row[s] = -1;
      continue;
    }
    const float dw = sa + gpre[cell * (g.n / kLattice) + p0 / kLattice];
    const float dxh = (f.w / g.tau_x) * sb;
    chain_rule(s_d + s * kNgrad, at, f, dw, dxh, g);
    s_row[s] = tblidx[k];
  }
  __syncthreads();
  row_sums(s_d, s_row, tb, tbl, dtab + (long long)b * tbl * kNattr);
}

size_t seg_fwd_smem(int tc, int tb) {
  return (size_t)tc * (kHalf + 1) * sizeof(unsigned long long) +
         3 * (size_t)tb * sizeof(float) +
         (size_t)bad_words(tc) * (kHalf + 1) * sizeof(unsigned);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// B9: (B, tbl, 16) tables -> out_a, out_b (num_tiles, n / 128, tc, 128)
// and carry (num_tiles, n / 64, tc) floats, zeroed; only the blocks of
// the runs are written.
extern "C" int vt_seg_fwd(const void* tables, const void* cells, const void* tblidx,
                          const void* batch_tile, const void* batch_panel,
                          const void* run_start, int num_runs, int tb, int tbl,
                          int n, int tc, int tz, int num_tiles, float ox, float oy,
                          float oz, float vs, float tau_e, float tau_x, void* out_a,
                          void* out_b, void* carry, void* stream) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc, tz};
  const size_t smem = seg_fwd_smem(tc, tb);
  const int e = set_smem((const void*)seg_fwd_kernel, smem);
  if (e != 0) return e;
  const dim3 grid(num_runs, kPanel / kHalf);
  seg_fwd_kernel<<<grid, kHalf * kLanes, smem, (cudaStream_t)stream>>>(
      (const float*)tables, (const int*)cells, (const int*)tblidx,
      (const int*)batch_tile, (const int*)batch_panel, (const int*)run_start, tb,
      tbl, num_tiles, g, (float*)out_a, (float*)out_b, (float*)carry);
  return (int)cudaGetLastError();
}

// B10: out_a, out_b and the carry prefix pre (num_tiles, n / 64, tc) ->
// the dense (n, n, n) grid.
extern "C" int vt_seg_combine(const void* out_a, const void* out_b, const void* pre,
                              int n, int tc, int tz, void* out, void* stream) {
  const long long total = (long long)n * n * n;
  const unsigned int blocks = (unsigned int)((total + kCombineThreads - 1) / kCombineThreads);
  seg_combine_kernel<<<blocks, kCombineThreads, 0, (cudaStream_t)stream>>>(
      (const float*)out_a, (const float*)out_b, (const float*)pre, n, tc, tz,
      (float*)out);
  return (int)cudaGetLastError();
}

// B11: cotangent g (n, n, n) and gpre (n, n, n / 64) -> dtab (B, tbl, 16).
extern "C" int vt_seg_bwd(const void* tables, const void* cells, const void* tblidx,
                          const void* batch_tile, const void* batch_panel,
                          const void* g_occ, const void* gpre, int num_batches,
                          int tb, int tbl, int n, int tc, int tz, int num_tiles,
                          float ox, float oy, float oz, float vs, float tau_e,
                          float tau_x, void* dtab, void* stream) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc, tz};
  const size_t smem = (size_t)tb * (kNgrad + 1) * sizeof(float);
  const int e = set_smem((const void*)seg_bwd_kernel, smem);
  if (e != 0) return e;
  seg_bwd_kernel<<<num_batches, kBwdThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tables, (const int*)cells, (const int*)tblidx,
      (const int*)batch_tile, (const int*)batch_panel, (const float*)g_occ,
      (const float*)gpre, tb, tbl, num_tiles, g, (float*)dtab);
  return (int)cudaGetLastError();
}
