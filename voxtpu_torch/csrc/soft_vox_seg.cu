// Segmented soft voxelization kernels (the seg engine), for Hopper
// (sm_90a).
//
// Replaces three Pallas TPU kernels of voxtpu/ops/soft_vox_seg.py:
//   B9   _seg_fwd_kernel      (vt_seg_fwd)
//   B10  _seg_combine_kernel  (vt_seg_combine)
//   B11  _seg_bwd_kernel      (vt_seg_bwd)
//
// The fused engine (soft_vox.cu, B7/B8) sums each slot's profile
// w * sigmoid((xh - cx) / tau_x) over all n columns of its cell's row.
// The seg engine sums it over one 128-column panel [p0, p0 + 128),
// chosen on the host so that xh lies >= 32 columns inside it: left of
// the panel the sigmoid is 1.0 in float32, so those columns get w as a
// carry; right of it they get nothing. Tiles are square tz x ty YZ
// patches: tile t, local cell c are the cell
//   y = (t % (n / ty)) * ty + c % ty,  z = (t / (n / ty)) * tz + c / ty.
// A (tile, panel) key's batches form one run of the plan.
//
// B9 and B11 compute a slot's sigmoid only inside its transition window
// [a, b) (`slot_window` in soft_common.cuh, as B7/B8), clipped to the
// slot's panel. Left of a the sigmoid is exactly 1.0f and from b on a
// forward term rounds to 0 in the fixed point, so the clipped window
// gives what the whole panel gives, also where the window lies partly
// or wholly outside the panel (an x_hit that drifted since the plan was
// built, or tau_x up to the guard's 32/17 voxels): a window right of
// the panel makes every panel column saturated, one left of it none.
// A slot whose w or xh is not finite, or |w| > 1, takes the whole panel
// (B9), as does a slot with a non-finite xh or whose panel's cotangent
// is not finite (B11), so that NaN and inf fall where the whole panel
// puts them.
//
// B9: a record pass (`seg_window_kernel`, a thread a slot: local cell,
// w, xh and the clipped window as an int4), then `seg_accumulate_kernel`,
// one block per (run, 64-column half of the panel), B7's accumulation
// (`accumulate_windows` in soft_common.cuh) over the half: each cell's saturated columns as a 64-bit base plus
// per-column differences (w's integer __float2ll_rn(w * 2^40), the very
// integer the whole panel adds there) and one scan; then per batch the
// slots whose window meets the half, kGroup lanes a slot, each term a
// 64-bit fixed-point add (soft_common.cuh). The half-0 block adds every
// live slot's w to its cell's base, with the difference at the window's
// start, so that the base before the scan is the run's carry (the sum
// of w per cell, which B10 spreads left of the panel); a w outside
// [-1, 1] marks the carry NaN instead. The integer sums are exact and
// order-free, so out_a, out_b and the carry are bitwise those of the
// whole panel. Each run writes its own output block whole (family A,
// p0 % 128 == 0, into out_a block p0 / 128; family B into out_b block
// (p0 - 64) / 128) and its carry row, so no global atomics; unvisited
// blocks keep the wrapper's zeros.
//
// B10: the dense (z, y, x) grid,
//   out = (A[j][l] + B') + pre[x / 64],  j = x / 128, l = x % 128,
// with B' = B[j - 1][l + 64] for l < 64 (0 for j = 0) and B[j][l - 64]
// otherwise: voxtpu's combine, the same association, so bitwise equal
// to the plain version (adds only; the library is built with
// -fmad=false). It moves bytes: A and B read once, the grid written
// once (12 bytes a voxel; pre is 1/64 of that). A block takes one
// (tile t, panel j) and 32 of its cells, a warp a cell row at a time, a
// lane four columns as float4s: A's row (t, j, c) is 512 contiguous
// bytes, B' the upper half of B's row (t, j - 1, c) for lanes 0-15 and
// the lower half of (t, j, c) for lanes 16-31 (16-byte aligned: 64
// floats), pre one value a half warp, and the grid's row (z, y) of the
// panel 512 contiguous bytes. The block divides once for (t, j, cells)
// and its 64-bit bases; per element only 32-bit offsets are added, so
// no 64-bit division a voxel (the C entry checks that they fit).
//
// B11: B8's structure over the panel: one block per batch (one tile,
// one panel); a thread a slot rebuilds its fragment and clipped window;
// kGroup lanes a slot walk the panel's columns of the cotangent g, read
// in place in (z, y, x) layout: g itself over [p0, a) (the in-panel
// prefix: sig is 1.0f there and 1 - sig 0), four columns a load, then
// g * sig and g * sig * (1 - sig) over the window [a, b); the terms from
// b on are dropped (each below 2^-41 |g|). dw = sum + gpre (the sum of
// g left of the panel, `seg_gpre`), dxh = (w / tau_x) * sum(g * sig *
// (1 - sig)), the 13 chain-ruled cotangents summed per table row in
// slot order (each row over its own slot range, the same additions).
// The in-panel prefix, and not B8's float64 row prefix, because every
// slot of a batch shares one panel: the columns left of the panel come
// summed in gpre, the ~47 saturated panel columns a slot are plain adds
// of aligned float4 loads, and no extra pass over the grid (0.59 ms and
// 1 GiB for B8's prefix at 512^3) is needed. Whether a panel's
// cotangent is finite is read from gpre through the panel's end (a
// finite prefix sum has only finite terms), and for a row's last panel
// from gpre and its last 64 columns.
//
// What bounds them on this card: the sigmoid of every (slot, column)
// pair in the clipped window (~23 columns at tau_x of half a voxel),
// three special-function operations a pair, with a 64-bit shared add
// (two native 32-bit atomics) in B9 and a read of g in B11; B9's record
// pass (16 bytes a slot, read four times: two halves, two passes) and
// the zeroed family arrays (2 x 537 MB at n = 512, written by the
// wrapper); B11's ~47 in-panel prefix columns a slot and its per-slot
// rebuild and chain rule. B10 moves bytes: reads A, B and the carry
// prefix, writes the grid; its loads are issued for a warp's four cell
// rows before any add.
//
// tests/test_torch_seg_emulated.py runs this file on the host through
// tests/emulation.py (see soft_vox.cu's note on the rewritten lines).

#include "soft_common.cuh"

namespace {

constexpr int kPanel = 128;   // panel width
constexpr int kLattice = 64;  // panel placement granularity
constexpr int kHalf = kScanCols;  // columns per B9 accumulation block
constexpr int kThreads = 256;     // B9's record pass, B11
constexpr int kFwdThreads = 512;  // B9's accumulation: 16 warps at 3 blocks an SM
constexpr int kCombineWarps = 8;  // B10: a cell row of one panel a warp at a time
constexpr int kCombineRounds = 4;
constexpr int kCombineCells = kCombineWarps * kCombineRounds;  // cells a block
static_assert(kPanel == 2 * kHalf, "a panel is two B9 halves");

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

// ---------------------------------------------------------------------
// B9: a record pass, then the windowed accumulation per half panel.
// ---------------------------------------------------------------------

// One thread a slot: its record (`slot_record` over the panel).
__global__ void seg_window_kernel(const float* __restrict__ tables,
                                  const int* __restrict__ tblidx,
                                  const int* __restrict__ cells,
                                  const int* __restrict__ batch_tile,
                                  const int* __restrict__ batch_panel,
                                  long long num_slots, int tb, int tbl, int num_tiles,
                                  Geom g, int4* __restrict__ rec) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= num_slots) return;
  const int b = (int)(k / tb);
  const int tile = batch_tile[b];
  const int p0 = batch_panel[b];
  const int c = cells[k];
  const float* at = tile >= 0 && tile < num_tiles && panel_ok(p0, g.n) && c >= 0 && c < g.tc
                        ? table_row(tables, tblidx, k, b, tbl)
                        : nullptr;
  int4 r = make_int4(-1, 0, 0, 0);
  if (at) {
    int gy, gz;
    tile_cell(tile, c, g, &gy, &gz);
    const Frag f = frag_at(at, center(g.oy, gy, g.vs), center(g.oz, gz, g.vs), g);
    r = slot_record(c, f.w, f.xh, p0, p0 + kPanel, g);
  }
  rec[k] = r;
}

// Grid (num_runs, 2), kFwdThreads threads: block (run, half) sums
// columns [x0, x0 + kHalf) of the run's panel (`accumulate_windows`),
// the half-0 block also the run's carry.
__global__ void seg_accumulate_kernel(const int4* __restrict__ rec,
                                      const int* __restrict__ batch_tile,
                                      const int* __restrict__ batch_panel,
                                      const int* __restrict__ run_start, int tb,
                                      int num_tiles, Geom g, float* __restrict__ out_a,
                                      float* __restrict__ out_b,
                                      float* __restrict__ carry) {
  extern __shared__ u64 smem_acc[];
  const int b0 = run_start[blockIdx.x];
  const int b1 = run_start[blockIdx.x + 1];
  if (b1 <= b0) return;
  const int tile = batch_tile[b0];
  const int p0 = batch_panel[b0];
  // A run outside the output is skipped (uniform per block).
  if (tile < 0 || tile >= num_tiles || !panel_ok(p0, g.n)) return;
  const bool carry_block = blockIdx.y == 0;
  const int x0 = p0 + blockIdx.y * kHalf;
  const AccSmem s = acc_smem(smem_acc, g.tc, tb);
  accumulate_windows(s, rec, b0, b1, tb, x0, x0 + kHalf, carry_block, g);
  const bool fam_b = (p0 / kLattice) % 2 == 1;
  const int blk = fam_b ? (p0 - kLattice) / kPanel : p0 / kPanel;
  store_windows(s, g.tc, kHalf,
                (fam_b ? out_b : out_a) +
                    ((long long)tile * (g.n / kPanel) + blk) * g.tc * kPanel + (x0 - p0),
                kPanel);
  if (carry_block) {
    float* cr = carry + ((long long)tile * (g.n / kLattice) + p0 / kLattice) * g.tc;
    for (int c = threadIdx.x; c < g.tc; c += blockDim.x)
      cr[c] = fix_value(s.base[c], (s.cbad[c >> 5] >> (c & 31)) & 1u);
  }
}

// ---------------------------------------------------------------------
// B10: the combine.
// ---------------------------------------------------------------------

// Grid (num_tiles * nj * groups), kCombineWarps warps: block (t, j,
// group) computes panel j of cells [32 * group, 32 * group + 32) of tile
// t; lane L columns 4L .. 4L + 3 of the panel.
__global__ void __launch_bounds__(kCombineWarps * 32)
    seg_combine_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ pre, int n, int tc, int tz,
                       float* __restrict__ out) {
  const int groups = (tc + kCombineCells - 1) / kCombineCells;
  const int nj = n / kPanel;
  const int group = blockIdx.x % groups;
  const int j = blockIdx.x / groups % nj;
  const int t = blockIdx.x / groups / nj;
  const int ty = tc / tz;
  const int tz0 = t / (n / ty) * tz, ty0 = t % (n / ty) * ty;  // the tile's first cell
  // 64-bit bases, once a block: A's and B's row (t, j, 0), pre's (t, 2j,
  // 0), the grid's (tz0, ty0) at column 128j.
  const long long row = ((long long)t * nj + j) * tc;
  const float* a_t = a + row * kPanel;
  const float* b_t = b + row * kPanel;
  const float* pre_t = pre + ((long long)t * (n / kLattice) + 2 * j) * tc;
  float* out_t = out + ((long long)tz0 * n + ty0) * n + j * kPanel;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = 4 * lane;
  const bool low = l < kLattice;  // B' from panel j - 1 (none at j = 0)
  const bool b_none = low && j == 0;
  const int b_off = low ? l + kLattice - tc * kPanel : l - kLattice;
  const int p_off = low ? 0 : tc;  // group 2j or 2j + 1
  float4 av[kCombineRounds], bv[kCombineRounds];
  float pv[kCombineRounds];
  int dst[kCombineRounds];
#pragma unroll
  for (int i = 0; i < kCombineRounds; ++i) {
    const int c = group * kCombineCells + i * kCombineWarps + warp;
    dst[i] = -1;
    if (c >= tc) continue;  // uniform in the warp
    const int cz = c / ty;
    dst[i] = (cz * n + c - cz * ty) * n + l;
    av[i] = *(const float4*)(a_t + c * kPanel + l);
    bv[i] = b_none ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                   : *(const float4*)(b_t + c * kPanel + b_off);
    pv[i] = pre_t[p_off + c];
  }
#pragma unroll
  for (int i = 0; i < kCombineRounds; ++i) {
    if (dst[i] < 0) continue;
    const float p = pv[i];
    *(float4*)(out_t + dst[i]) = make_float4(__fadd_rn(__fadd_rn(av[i].x, bv[i].x), p),
                                             __fadd_rn(__fadd_rn(av[i].y, bv[i].y), p),
                                             __fadd_rn(__fadd_rn(av[i].z, bv[i].z), p),
                                             __fadd_rn(__fadd_rn(av[i].w, bv[i].w), p));
  }
}

// ---------------------------------------------------------------------
// B11: the windowed slot gradients over the panel.
// ---------------------------------------------------------------------

// Grid (num_batches), kThreads threads. The block marks each cell whose
// panel cotangent is finite; a thread a slot rebuilds its fragment and
// clipped window; kGroup lanes a slot sum the panel from p0 to b; a
// thread a slot adds gpre and applies the chain rule.
__global__ void seg_grad_kernel(const float* __restrict__ tables,
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
  int* s_first = s_row + tb;               // [tbl]
  int* s_last = s_first + tbl;             // [tbl]
  int* s_fin = s_last + tbl;               // [tc] the cell's panel cotangent is finite
  const int b = blockIdx.x;
  const int tile = batch_tile[b];
  const int p0 = batch_panel[b];
  const bool batch_ok = tile >= 0 && tile < num_tiles && panel_ok(p0, g.n);
  const int ng = g.n / kLattice;
  const int j0 = p0 / kLattice;
  const int lane = threadIdx.x & 31;
  const int glane = threadIdx.x % kGroup;
  const int groups = blockDim.x / kGroup;
  const bool geom_ok = window_geom(g);

  for (int r = threadIdx.x; r < tbl; r += blockDim.x) {
    s_first[r] = tb;
    s_last[r] = -1;
  }
  if (batch_ok && j0 + 2 < ng) {
    // gpre[j0 + 2] sums g over [0, p0 + 128): finite iff all its terms are
    for (int c = threadIdx.x; c < g.tc; c += blockDim.x) {
      int gy, gz;
      tile_cell(tile, c, g, &gy, &gz);
      s_fin[c] = isfinite(gpre[((long long)gz * g.n + gy) * ng + j0 + 2]);
    }
  } else if (batch_ok) {  // the row's last panel: gpre through p0 + 64, then its columns
    for (int c = threadIdx.x >> 5; c < g.tc; c += blockDim.x >> 5) {
      int gy, gz;
      tile_cell(tile, c, g, &gy, &gz);
      const long long cell = (long long)gz * g.n + gy;
      bool bad = !isfinite(gpre[cell * ng + ng - 1]);
      for (int x = p0 + kLattice + lane; x < g.n; x += 32) bad |= !isfinite(gocc[cell * g.n + x]);
      bad = __any_sync(0xffffffffu, bad);
      if (lane == 0) s_fin[c] = !bad;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < tb; s += blockDim.x) {
    const long long k = (long long)b * tb + s;
    const int c = cells[k];
    const float* at = batch_ok && c >= 0 && c < g.tc ? table_row(tables, tblidx, k, b, tbl)
                                                     : nullptr;
    s_row[s] = at ? tblidx[k] : -1;
    if (!at) continue;
    atomicMin(&s_first[s_row[s]], s);
    atomicMax(&s_last[s_row[s]], s);
    int gy, gz;
    tile_cell(tile, c, g, &gy, &gz);
    const Frag f = frag_at(at, center(g.oy, gy, g.vs), center(g.oz, gz, g.vs), g);
    Window win = {p0, p0 + kPanel};
    if (isfinite(f.xh) && geom_ok && s_fin[c]) win = clipped_window(f.xh, p0, p0 + kPanel, g);
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
    d[kRow] = __int_as_float(gz * g.n + gy);
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
      const int a = win & 0xffff;
      const float* grow = gocc + (long long)__float_as_int(d[kRow]) * g.n;
      // The in-panel prefix [p0, a), four columns a load (p0 % 64 == 0
      // and n % 128 == 0: the float4s are aligned).
      const float4* g4 = (const float4*)(grow + p0);
      for (int q = glane; 4 * q < a - p0; q += kGroup) {
        const float4 v = g4[q];
        const int left = a - p0 - 4 * q;  // columns of this float4 left of a
        sa += v.x;
        if (left > 1) sa += v.y;
        if (left > 2) sa += v.z;
        if (left > 3) sa += v.w;
      }
      for (int x = a + glane; x < (win >> 16); x += kGroup) {
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
    const long long cell = __float_as_int(d[kRow]);
    const float dw = d[kSa] + gpre[cell * ng + j0];
    const float dxh = (f.w / g.tau_x) * d[kSb];
    chain_rule(d, tables + ((long long)b * tbl + s_row[s]) * kNattr, f, dw, dxh, g);
  }
  __syncthreads();
  row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab + (long long)b * tbl * kNattr);
}

size_t seg_bwd_smem(int tc, int tb, int tbl) {
  return (size_t)tb * (kNgrad + 1) * sizeof(float) + (2 * (size_t)tbl + tc) * sizeof(int);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// B9: (B, tbl, 16) tables -> out_a, out_b (num_tiles, n / 128, tc, 128)
// and carry (num_tiles, n / 64, tc) floats, zeroed; only the blocks of
// the runs are written. `work` holds B * tb int4 slot records.
extern "C" int vt_seg_fwd(const void* tables, const void* cells, const void* tblidx,
                          const void* batch_tile, const void* batch_panel,
                          const void* run_start, int num_batches, int num_runs, int tb,
                          int tbl, int n, int tc, int tz, int num_tiles, float ox,
                          float oy, float oz, float vs, float tau_e, float tau_x,
                          void* work, void* out_a, void* out_b, void* carry,
                          void* stream) {
  const Geom g = {ox, oy, oz, vs, tau_e, tau_x, n, tc, tz};
  if (n >= (1 << 15)) return (int)cudaErrorInvalidValue;  // a | b << 16 in an int
  const long long slots = (long long)num_batches * tb;
  const cudaStream_t st = (cudaStream_t)stream;
  seg_window_kernel<<<(unsigned)((slots + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const float*)tables, (const int*)tblidx, (const int*)cells, (const int*)batch_tile,
      (const int*)batch_panel, slots, tb, tbl, num_tiles, g, (int4*)work);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const size_t smem = acc_smem_bytes(tc, tb);
  e = set_smem((const void*)seg_accumulate_kernel, smem);
  if (e) return e;
  const dim3 grid(num_runs, kPanel / kHalf);
  seg_accumulate_kernel<<<grid, kFwdThreads, smem, st>>>(
      (const int4*)work, (const int*)batch_tile, (const int*)batch_panel,
      (const int*)run_start, tb, num_tiles, g, (float*)out_a, (float*)out_b, (float*)carry);
  return (int)cudaGetLastError();
}

// B10: out_a, out_b and the carry prefix pre (num_tiles, n / 64, tc) ->
// the dense (n, n, n) grid. Refuses (cudaErrorInvalidValue) a geometry
// the kernel does not take: n not a multiple of 128, tz not dividing tc
// and n, tc / tz not dividing n, a tile's cell offsets beyond 32 bits,
// or an out_a, out_b or out not 16-byte aligned.
extern "C" int vt_seg_combine(const void* out_a, const void* out_b, const void* pre,
                              int n, int tc, int tz, void* out, void* stream) {
  const auto misaligned = [](const void* p) { return ((unsigned long long)p & 15) != 0; };
  if (n < kPanel || n % kPanel || tz < 1 || tc < tz || tc % tz || n % tz ||
      n % (tc / tz) || (long long)tz * n * n >= (1ll << 31) ||
      misaligned(out_a) || misaligned(out_b) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n / (tc / tz) * (n / tz) * (n / kPanel) *
                           ((tc + kCombineCells - 1) / kCombineCells);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  seg_combine_kernel<<<(unsigned)blocks, kCombineWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)out_a, (const float*)out_b, (const float*)pre, n, tc, tz, (float*)out);
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
  if (n >= (1 << 15)) return (int)cudaErrorInvalidValue;
  const size_t smem = seg_bwd_smem(tc, tb, tbl);
  const int e = set_smem((const void*)seg_grad_kernel, smem);
  if (e != 0) return e;
  seg_grad_kernel<<<num_batches, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tables, (const int*)cells, (const int*)tblidx,
      (const int*)batch_tile, (const int*)batch_panel, (const float*)g_occ,
      (const float*)gpre, tb, tbl, num_tiles, g, (float*)dtab);
  return (int)cudaGetLastError();
}
