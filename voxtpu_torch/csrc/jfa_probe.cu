// Flood-step probe kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   P1  scripts/probe_jfa_micro.py::_kernel  (vt_flood_probe)
//
// voxtpu's probe times one flood step (B3, `legacy`) against variants
// that isolate one part of its cost; `tools/probe_jfa_micro.py` is the
// port's runner. One thread per voxel, as B3, with the variant as a
// template argument:
//
//   hoist   B3's function with the address work out of the candidate
//           loop: the x offsets and their validity once per voxel, a
//           row pointer once per (plane, dy), x innermost (what the
//           TPU buys with hoisted lane rolls). Bitwise B3.
//   hoistv  hoist with validity folded into one +inf select on d2: the
//           load is clamped into the grid and taken without a branch.
//           Bitwise B3 (+inf is never strictly less).
//   rolls   the data movement alone: the integer min of the own seed
//           and the 26 candidates, x and y wrapping around the plane
//           (jnp.roll), z clamped into the grid (the TPU's block index
//           map), no masks.
//   alu     the arithmetic alone: 26 distance folds over the clamped
//           plane's seed at the voxel's own (y, x) XOR i, i = 1..26 in
//           candidate order, strict `<`.
//
// `legacy` is B3 itself: the wrapper launches vt_flood_step for it.
//
// Bound on this card: as B3, the per-candidate unpack and distance
// (~14 flops per candidate that holds a seed) for hoist, hoistv and alu;
// rolls moves 27 int32 reads a voxel, most of them from L2. The probe
// splits a step's time into those two parts.

#include <cuda_runtime.h>

#include "jfa_common.cuh"

namespace {

constexpr int kHoist = 1, kHoistV = 2, kRolls = 3, kAlu = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_to(int v, int n) {
  return min(max(v, 0), n - 1);
}

__device__ __forceinline__ int wrap(int v, int n) {  // v in (-n, 2n)
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

template <int V>
__global__ void flood_probe_kernel(const int* __restrict__ seed,
                                   int* __restrict__ out,
                                   const float* __restrict__ org, int n,
                                   int k) {
  const long long nn = (long long)n * n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nn * n) return;
  const int x = (int)(i % n);
  const int y = (int)((i / n) % n);
  const int z = (int)(i / nn);

  int best = seed[i];
  if constexpr (V == kRolls) {
    for (int dz = -1; dz <= 1; ++dz) {
      const int* plane = seed + clamp_to(z + dz * k, n) * nn;
      for (int dy = -1; dy <= 1; ++dy) {
        const int* row = plane + (long long)wrap(y + dy * k, n) * n;
        for (int dx = -1; dx <= 1; ++dx) {
          if (dz == 0 && dy == 0 && dx == 0) continue;
          best = min(best, row[wrap(x + dx * k, n)]);
        }
      }
    }
  } else {
    const float ox = org[0], oy = org[1], oz = org[2], vs = org[3];
    const float px = __fadd_rn(ox, __fmul_rn((float)x, vs));
    const float py = __fadd_rn(oy, __fmul_rn((float)y, vs));
    const float pz = __fadd_rn(oz, __fmul_rn((float)z, vs));
    float best_d2 = seed_d2(best, px, py, pz, ox, oy, oz, vs);
    if constexpr (V == kAlu) {
      int c = 1;
      for (int dz = -1; dz <= 1; ++dz) {
        const int own = seed[clamp_to(z + dz * k, n) * nn + (long long)y * n + x];
        for (int j = 0; j < 9; ++j) {
          if (dz == 0 && j == 4) continue;  // the centre
          const int cand = own ^ c++;
          const float d2 = seed_d2(cand, px, py, pz, ox, oy, oz, vs);
          if (d2 < best_d2) {
            best_d2 = d2;
            best = cand;
          }
        }
      }
    } else {
      // hoist / hoistv: x offsets and validity once, a row pointer per
      // (plane, dy) (clamped, so always an address in the grid).
      int xs[3];
      bool xok[3];
      for (int d = 0; d < 3; ++d) {
        const int xn = x + (d - 1) * k;
        xok[d] = xn >= 0 && xn < n;
        xs[d] = clamp_to(xn, n);
      }
      const float inf = __int_as_float(0x7f800000);
      for (int dz = -1; dz <= 1; ++dz) {
        const int zn = z + dz * k;
        const bool zok = zn >= 0 && zn < n;
        const int* plane = seed + clamp_to(zn, n) * nn;
        for (int dy = -1; dy <= 1; ++dy) {
          const int yn = y + dy * k;
          const bool zyok = zok && yn >= 0 && yn < n;
          const int* row = plane + (long long)clamp_to(yn, n) * n;
          for (int d = 0; d < 3; ++d) {
            if (dz == 0 && dy == 0 && d == 1) continue;
            int cand;
            float d2;
            if constexpr (V == kHoistV) {
              cand = row[xs[d]];
              const bool ok = zyok && xok[d] && cand >= 0;
              const float dist = packed_d2(cand, px, py, pz, ox, oy, oz, vs);
              d2 = ok ? dist : inf;
            } else {
              cand = zyok && xok[d] ? row[xs[d]] : -1;
              d2 = seed_d2(cand, px, py, pz, ox, oy, oz, vs);
            }
            if (d2 < best_d2) {
              best_d2 = d2;
              best = cand;
            }
          }
        }
      }
    }
  }
  out[i] = best;
}

template <int V>
int launch(const void* seed, void* out, const void* org, int n, int k,
           cudaStream_t stream) {
  const long long total = (long long)n * n * n;
  const unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  flood_probe_kernel<V><<<blocks, kThreads, 0, stream>>>(
      (const int*)seed, (int*)out, (const float*)org, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// P1: variant 1 hoist, 2 hoistv, 3 rolls, 4 alu (0, legacy, is
// vt_flood_step); another value is refused.
extern "C" int vt_flood_probe(const void* seed, void* out, const void* org,
                              int n, int k, int variant, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kHoist: return launch<kHoist>(seed, out, org, n, k, s);
    case kHoistV: return launch<kHoistV>(seed, out, org, n, k, s);
    case kRolls: return launch<kRolls>(seed, out, org, n, k, s);
    case kAlu: return launch<kAlu>(seed, out, org, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
