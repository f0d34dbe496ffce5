// Device code shared by the soft voxelization kernels (soft_vox.cu,
// soft_vox_seg.cu): a slot's fragment rebuilt from its triangle's
// 16-coefficient table row, the 64-bit fixed-point sum of the forward
// kernels, a slot's transition window (`slot_window`), the windowed
// forward accumulation of B7, B9 and B13 fwd (`slot_record`,
// `accumulate_windows`, `store_windows`), the window sums of B8 and B13
// bwd (`window_sums`), and the chain rule and per-table-row sums of the
// backward kernels. Included, never compiled alone.

#pragma once

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

// Forward terms in units of 2^-40: |w * sig| <= 1 (w is a coverage
// times a facing sign), so a 64-bit sum holds 2^23 terms, and rounding a
// term costs at most 2^-41. A term that is not in [-1, 1] (NaN, inf) has
// no fixed-point value: it marks its cell and column, which read NaN.
constexpr float kFix = 0x1p40f;
constexpr float kUnfix = 0x1p-40f;
constexpr int kNattr = 16;  // coefficient table row width
constexpr int kNgrad = 13;  // coefficient cotangents per slot

__host__ __device__ constexpr int bad_words(int tc) { return (tc + 31) / 32; }

struct Geom {
  float ox, oy, oz, vs, tau_e, tau_x;
  int n, tc;
  int tz;  // square-tile rows (seg kernels)
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Cell-centre coordinate o + (i * vs + vs * 0.5).
__device__ __forceinline__ float center(float o, int i, float vs) {
  return o + ((float)i * vs + vs * 0.5f);
}

// A slot's fragment, rebuilt from its triangle's table row `at`
// (layout: (u, v, w) of the three edges, P, Q, R, wmul) and its cell
// centre (cy, cz); `_fused_fwd_kernel` lines 257-261.
struct Frag {
  float cy, cz, s0, s1, s2, cov, w, xh;
};

__device__ __forceinline__ Frag frag_at(const float* __restrict__ at, float cy,
                                        float cz, const Geom& g) {
  Frag f;
  f.cy = cy;
  f.cz = cz;
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

// Add one forward term to a fixed-point accumulator, or mark its bit.
__device__ __forceinline__ void fix_add(unsigned long long* acc, unsigned* bad,
                                        unsigned bit, float v) {
  if (fabsf(v) <= 1.0f)
    atomicAdd(acc, (unsigned long long)__float2ll_rn(v * kFix));
  else
    atomicOr(bad, bit);
}

// A fixed-point sum as a float, NaN where a term was marked.
__device__ __forceinline__ float fix_value(unsigned long long acc, bool bad) {
  return bad ? __int_as_float(0x7fffffff) : __ll2float_rn((long long)acc) * kUnfix;
}

// ---------------------------------------------------------------------
// Transition windows (B7, B8, B9, B11, B13).
//
// With v = (xh - cx) / tau_x as every kernel computes it (column centre,
// subtraction, division, each rounded on its own), v is non-increasing
// in the column: the centre is a chain of monotone roundings of x, and
// so are the subtraction and the division by tau_x > 0. A window's ends
// are found by evaluating v itself at the boundary columns, so the
// rounding of v and of the centres needs no margin; only expf's does:
//   - left of a, v >= kSatHi = 17: exp(-17) = 4.14e-8 < 2^-24 = 5.96e-8
//     with a factor 1.44 to spare (expf is within 2 ulp, CUDA
//     Programming Guide), so 1 + expf(-v) rounds to 1 and the sigmoid
//     is exactly 1.0f: a forward term is w itself, and 1 - sig is 0;
//   - from b on, v <= kSatLo = -29: expf(-v) >= exp(29) = 3.9e12 >
//     2^41 (factor 1.79), so sig <= 2^-41 and, for |w| <= 1,
//     |w * sig| * 2^40 <= 1/2 rounds to 0 in the fixed point.
// ---------------------------------------------------------------------

constexpr float kSatHi = 17.0f;   // v >= kSatHi: sigmoid(v) == 1.0f
constexpr float kSatLo = -29.0f;  // v <= kSatLo: the term rounds to 0
constexpr int kGroup = 8;         // lanes a windowed slot's columns take (~23 of them)
constexpr int kScanCols = 64;     // columns a forward block owns (B7's chunk, B9's half panel)

// The sigmoid's argument at column x, as every soft kernel computes it.
__device__ __forceinline__ float profile_arg(float xh, int x, const Geom& g) {
  return (xh - center(g.ox, x, g.vs)) / g.tau_x;
}

// Whether `slot_window`'s monotonicity holds for the whole launch.
__device__ __forceinline__ bool window_geom(const Geom& g) {
  return g.tau_x > 0.0f && isfinite(g.tau_x) && g.vs > 0.0f && isfinite(g.vs) &&
         isfinite(g.ox);
}

// A column index near the real column f, clamped to [0, n].
__device__ __forceinline__ int clamp_col(float f, int n) {
  return (int)fminf(fmaxf(f, 0.0f), (float)n);
}

struct Window {
  int a, b;
};

// A slot's transition window at a finite xh (under `window_geom`): the
// least a with v(a) < kSatHi and the least b with v(b) <= kSatLo (n if
// none), found from an estimate by stepping v's own values.
__device__ __forceinline__ Window slot_window(float xh, const Geom& g) {
  const float at = (xh - g.ox) / g.vs - 0.5f;
  const float r = g.tau_x / g.vs;
  int a = clamp_col(at - kSatHi * r, g.n);
  while (a > 0 && profile_arg(xh, a - 1, g) < kSatHi) --a;
  while (a < g.n && profile_arg(xh, a, g) >= kSatHi) ++a;
  int b = max(a, clamp_col(at - kSatLo * r + 1.0f, g.n));
  while (b > a && profile_arg(xh, b - 1, g) <= kSatLo) --b;
  while (b < g.n && profile_arg(xh, b, g) > kSatLo) ++b;
  return {a, b};
}

// A slot's transition window at a finite xh, clipped to [lo, hi).
__device__ __forceinline__ Window clipped_window(float xh, int lo, int hi, const Geom& g) {
  const Window w = slot_window(xh, g);
  return {min(max(w.a, lo), hi), min(max(w.b, lo), hi)};
}

// A forward kernel's record of a live slot of local cell c, weight w
// and x-hit xh over the columns [lo, hi) it owns (B7, B13: the row, B9:
// the panel): (c, w, xh, a | b << 16), the window clipped to [lo, hi),
// or the whole of it where the slot may not be windowed (|w| > 1, w or
// xh not finite, or a launch geometry `slot_window` cannot step).
__device__ __forceinline__ int4 slot_record(int c, float w, float xh, int lo, int hi,
                                            const Geom& g) {
  Window win = {lo, hi};
  if (fabsf(w) <= 1.0f && isfinite(xh) && window_geom(g)) win = clipped_window(xh, lo, hi, g);
  return make_int4(c, __float_as_int(w), __float_as_int(xh), win.a | (win.b << 16));
}

// A backward slot's window [a, b) on its cotangent row `row` (B8, B13
// bwd): the whole row where xh is not finite, the launch geometry fails
// `window_geom`, or the row's total in g's float64 prefix `pre` is not
// finite (its NaN and inf then reach the slot as the full row sends
// them).
__device__ __forceinline__ Window grad_window(float xh, long long row,
                                              const double* __restrict__ pre,
                                              const Geom& g) {
  if (isfinite(xh) && window_geom(g) && isfinite(pre[(row + 1) * g.n - 1]))
    return slot_window(xh, g);
  return {0, g.n};
}

// A backward slot's sums over its window [a, b) of cotangent row
// `grow`: *sa = sum of g[x] * sig and *sb = sum of g[x] * sig * (1 -
// sig), in float32, kGroup lanes a slot striding over the columns, then
// a fixed shuffle tree; every lane of the group gets both. Called by
// every lane of the warp (a lane with no slot passes a = b).
__device__ __forceinline__ void window_sums(const float* __restrict__ grow, float xh,
                                            int a, int b, const Geom& g, float* sa,
                                            float* sb) {
  float ra = 0.0f, rb = 0.0f;
  for (int x = a + (int)(threadIdx.x % kGroup); x < b; x += kGroup) {
    const float sig = sigmoid(profile_arg(xh, x, g));
    const float ps = grow[x] * sig;
    ra += ps;
    rb += ps * (1.0f - sig);
  }
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    ra += __shfl_xor_sync(0xffffffffu, ra, off);
    rb += __shfl_xor_sync(0xffffffffu, rb, off);
  }
  *sa = ra;
  *sb = rb;
}

// A backward slot's dw: the saturated columns' sum of g left of a, from
// the float64 prefix, plus its window sum sa, rounded once.
__device__ __forceinline__ float grad_dw(const double* __restrict__ pre, long long row,
                                         int a, float sa, int n) {
  const double left = a > 0 ? pre[row * n + a - 1] : 0.0;
  return (float)(left + (double)sa);
}

// acc += v (mod 2^64) as two native 32-bit shared atomics, the low
// word's carry added to the high word: the words' sums, and so the
// 64-bit value once every add is done, do not depend on the order
// (a 64-bit shared atomicAdd compiles to a compare-and-swap loop,
// ATOMS.CAST.SPIN.64, on sm_90a).
__device__ __forceinline__ void add_split(u64* acc, u64 v) {
  unsigned* word = (unsigned*)acc;  // little-endian: the low word first
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(word, lo);
  const unsigned hi = (unsigned)(v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) atomicAdd(word + 1, hi);
}

// `fix_add` through `add_split`.
__device__ __forceinline__ void fix_add_split(u64* acc, unsigned* bad, unsigned bit,
                                              float v) {
  if (fabsf(v) <= 1.0f)
    add_split(acc, (u64)__float2ll_rn(v * kFix));
  else
    atomicOr(bad, bit);
}

// Each cell's row of kScanCols fixed-point differences -> its base plus
// their inclusive scan, one warp a cell, two columns a lane.
static_assert(kScanCols == 64, "scan_rows: a warp's 32 lanes take two columns each");
__device__ __forceinline__ void scan_rows(u64* acc, const u64* base, int tc) {
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < tc; c += blockDim.x >> 5) {
    u64* row = acc + c * kScanCols + 2 * lane;
    const u64 d0 = row[0];
    const u64 pair = d0 + row[1];
    u64 incl = pair;
    for (int off = 1; off < 32; off <<= 1) {
      const u64 up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    incl += base[c];
    row[0] = incl - pair + d0;
    row[1] = incl;
  }
}

// A forward block's shared memory (B7, B9, B13 fwd), laid out from the
// front of its dynamic shared memory by `acc_smem`. The base is an array
// of its own because the rows' first columns all lie in one shared-memory
// bank.
struct AccSmem {
  u64* acc;        // [tc][kScanCols] fixed-point sums
  int4* item;      // [tb] the current batch's listed slots
  u64* base;       // [tc] each cell's saturated columns (B9's half 0: its carry)
  unsigned* bad;   // [tc / 32][kScanCols] bits of marked terms
  unsigned* cbad;  // [tc / 32] bits of marked carry terms
  int* count;      // [2] listed slots, alternating between batches
};

__host__ __device__ inline size_t acc_smem_bytes(int tc, int tb) {
  return (size_t)tc * (kScanCols + 1) * sizeof(u64) + (size_t)tb * sizeof(int4) +
         (size_t)bad_words(tc) * (kScanCols + 1) * sizeof(unsigned) + 2 * sizeof(int);
}

__device__ __forceinline__ AccSmem acc_smem(u64* smem, int tc, int tb) {
  AccSmem s;
  s.acc = smem;
  s.item = (int4*)(s.acc + tc * kScanCols);
  s.base = (u64*)(s.item + tb);
  s.bad = (unsigned*)(s.base + tc);
  s.cbad = s.bad + bad_words(tc) * kScanCols;
  s.count = (int*)(s.cbad + bad_words(tc));
  return s;
}

// The fixed-point sums of a forward block that owns the columns [x0,
// x1), x1 - x0 <= kScanCols, of one run's cells, from the run's slot
// records rec[b0 * tb, b1 * tb) (`slot_record`). Pass 1 adds the
// saturated columns: w's integer to its cell's base (every column)
// where a > x0, and its negation as a difference at a where a falls
// inside [x0, x1); then each row is scanned. With `carry` (B9's half-0
// block) every live slot adds its w to the base, which then holds the
// sum of w per cell, and a w outside [-1, 1] marks the cell's carry bit
// instead. Pass 2, per batch, lists the slots whose window meets [x0,
// x1) and gives each listed slot kGroup lanes over its columns there.
// Called by the whole block; ends at a barrier.
__device__ __forceinline__ void accumulate_windows(const AccSmem& s,
                                                   const int4* __restrict__ rec, int b0,
                                                   int b1, int tb, int x0, int x1,
                                                   bool carry, const Geom& g) {
  const int glane = threadIdx.x % kGroup;
  for (int i = threadIdx.x; i < g.tc * kScanCols; i += blockDim.x) s.acc[i] = 0ull;
  for (int i = threadIdx.x; i < bad_words(g.tc) * (kScanCols + 1); i += blockDim.x)
    s.bad[i] = 0u;  // and cbad
  for (int c = threadIdx.x; c < g.tc; c += blockDim.x) s.base[c] = 0ull;
  if (threadIdx.x < 2) s.count[threadIdx.x] = 0;
  __syncthreads();
  const long long k1 = (long long)b1 * tb;
  for (long long k = (long long)b0 * tb + threadIdx.x; k < k1; k += blockDim.x) {
    const int4 r = rec[k];
    if (r.x < 0) continue;
    const int a = r.w & 0xffff;
    const float w = __int_as_float(r.y);
    if (carry) {
      if (!(fabsf(w) <= 1.0f)) {  // no fixed-point value: the carry reads NaN
        atomicOr(&s.cbad[r.x >> 5], 1u << (r.x & 31));
        continue;
      }
    } else if (a <= x0) {
      continue;
    }
    const u64 fix = (u64)__float2ll_rn(w * kFix);
    add_split(&s.base[r.x], fix);
    if (a < x1) add_split(&s.acc[r.x * kScanCols + (a - x0)], 0ull - fix);
  }
  __syncthreads();
  scan_rows(s.acc, s.base, g.tc);

  for (int b = b0; b < b1; ++b) {
    int* count_b = s.count + (b & 1);  // reset a batch before its use
    for (int i = threadIdx.x; i < tb; i += blockDim.x) {
      const int4 r = rec[(long long)b * tb + i];
      const int lo = max(r.w & 0xffff, x0);
      const int hi = min(r.w >> 16, x1);
      if (r.x >= 0 && lo < hi)
        s.item[atomicAdd(count_b, 1)] = make_int4(r.x, r.y, r.z, lo | (hi << 16));
    }
    __syncthreads();
    const int count = *count_b;
    if (threadIdx.x == 0) s.count[(b & 1) ^ 1] = 0;
    for (int i = threadIdx.x / kGroup; i < count; i += blockDim.x / kGroup) {
      const int4 it = s.item[i];
      const int c = it.x;
      const float w = __int_as_float(it.y);
      const float xh = __int_as_float(it.z);
      for (int x = (it.w & 0xffff) + glane; x < (it.w >> 16); x += kGroup) {
        const float v = w * sigmoid(profile_arg(xh, x, g));
        fix_add_split(&s.acc[c * kScanCols + (x - x0)],
                      &s.bad[(c >> 5) * kScanCols + (x - x0)], 1u << (c & 31), v);
      }
    }
    __syncthreads();  // the items are consumed
  }
}

// Column col < cols of cell c's sums, NaN where marked, to
// o[c * stride + col].
__device__ __forceinline__ void store_windows(const AccSmem& s, int tc, int cols,
                                              float* __restrict__ o, long long stride) {
  const int col = threadIdx.x % kScanCols;
  if (col >= cols) return;
  for (int c = threadIdx.x / kScanCols; c < tc; c += blockDim.x / kScanCols)
    o[c * stride + col] = fix_value(s.acc[c * kScanCols + col],
                                    (s.bad[(c >> 5) * kScanCols + col] >> (c & 31)) & 1u);
}

// The chain rule of a slot's (dw, dxh) to its 13 coefficient
// cotangents, `_fused_bwd_kernel` lines 348-360.
__device__ __forceinline__ void chain_rule(float* d, const float* at, const Frag& f,
                                           float dw, float dxh, const Geom& g) {
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
}

// Per-row sums of a batch's staged slot cotangents: one thread per table
// row, its slots (contiguous in the plan) in slot order; rows 13..15
// zero. Called by the whole block after the staging barrier.
__device__ __forceinline__ void row_sums(const float* s_d, const int* s_row, int tb,
                                         int tbl, float* __restrict__ dtab_b) {
  for (int r = threadIdx.x; r < tbl; r += blockDim.x) {
    float sum[kNgrad];
    for (int j = 0; j < kNgrad; ++j) sum[j] = 0.0f;
    for (int s = 0; s < tb; ++s) {
      if (s_row[s] != r) continue;
      for (int j = 0; j < kNgrad; ++j) sum[j] += s_d[s * kNgrad + j];
    }
    float* o = dtab_b + (long long)r * kNattr;
    for (int j = 0; j < kNgrad; ++j) o[j] = sum[j];
    for (int j = kNgrad; j < kNattr; ++j) o[j] = 0.0f;
  }
}

// Per-row sums of a batch's slot cotangents as `row_sums` adds them
// (slot order, the same float additions), each row scanning only the
// slots from its first to its last (`s_first`, `s_last`).
__device__ __forceinline__ void row_sums_ranged(const float* s_d, const int* s_row,
                                                const int* s_first, const int* s_last,
                                                int tbl, float* __restrict__ dtab_b) {
  for (int r = threadIdx.x; r < tbl; r += blockDim.x) {
    float sum[kNgrad];
    for (int j = 0; j < kNgrad; ++j) sum[j] = 0.0f;
    for (int s = s_first[r]; s <= s_last[r]; ++s) {
      if (s_row[s] != r) continue;
      for (int j = 0; j < kNgrad; ++j) sum[j] += s_d[s * kNgrad + j];
    }
    float* o = dtab_b + (long long)r * kNattr;
    for (int j = 0; j < kNgrad; ++j) o[j] = sum[j];
    for (int j = kNgrad; j < kNattr; ++j) o[j] = 0.0f;
  }
}

// A windowed backward kernel's values of a slot, staged in its kNgrad
// floats of s_d until the chain rule overwrites them.
enum { kCy, kCz, kS0, kS1, kS2, kCov, kW, kXh, kWin, kRow, kSa, kSb };
static_assert(kSb < kNgrad, "a slot's staged values fit its cotangent row");

}  // namespace
