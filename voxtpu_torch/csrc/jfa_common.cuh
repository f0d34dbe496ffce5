// Device code shared by the flood kernels (jfa.cu) and the flood-step
// probe (jfa_probe.cu): the packed seed's fields and the reference
// squared distance, each float operation rounded on its own.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMask10 = 0x3FF;

// Squared world distance voxel -> seed, with no test for the -1
// sentinel (the caller selects +inf for it).
__device__ __forceinline__ float packed_d2(int seed, float px, float py,
                                           float pz, float ox, float oy,
                                           float oz, float vs) {
  const float sx = (float)(seed & kMask10);
  const float sy = (float)((seed >> 10) & kMask10);
  const float sz = (float)((seed >> 20) & kMask10);
  const float dx = __fsub_rn(px, __fadd_rn(ox, __fmul_rn(sx, vs)));
  const float dy = __fsub_rn(py, __fadd_rn(oy, __fmul_rn(sy, vs)));
  const float dz = __fsub_rn(pz, __fadd_rn(oz, __fmul_rn(sz, vs)));
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Squared world distance voxel -> seed; +inf for the -1 sentinel.
__device__ __forceinline__ float seed_d2(int seed, float px, float py,
                                         float pz, float ox, float oy,
                                         float oz, float vs) {
  if (seed < 0) return __int_as_float(0x7f800000);  // +inf
  return packed_d2(seed, px, py, pz, ox, oy, oz, vs);
}

}  // namespace
