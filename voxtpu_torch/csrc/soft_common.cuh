// Device code shared by the soft voxelization kernels (soft_vox.cu,
// soft_vox_seg.cu): a slot's fragment rebuilt from its triangle's
// 16-coefficient table row, and the 64-bit fixed-point sum of the
// forward kernels. Included, never compiled alone.

#pragma once

#include <cuda_runtime.h>

namespace {

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

}  // namespace
