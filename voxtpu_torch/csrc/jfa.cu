// Jump Flooding kernels of the SDF op, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of voxtpu/ops/jfa_pallas.py:
//   B3  _step_kernel           (vt_flood_step): one flood step at stride k
//   B4  _step_kernel_yblocked  (vt_flood_step_rows): the same step in
//                              (1, H, n) row bands, for 512 < N <= 1024
//   B5  _final_kernel          (vt_sdf_from_seed): signed squared distance
//   B6  _pipe_kernel           (vt_flood_step_pipe): B3 by a residue walk
//                              that unpacks each seed once; at k = 1
//                              optionally fused with B5 (JFA_PIPE=1)
//
// State is one int32 seed grid, 10-bit packed (z << 20 | y << 10 | x),
// -1 where no seed is known; N <= 1024.
//
// Exactness: selection must reproduce the TPU kernel and the NumPy
// oracle bit for bit, since a different tie-break cascades through the
// later steps. So the distance is the reference float formula, term
// for term: px = ox + col*vs, the seed's world coordinate ox + sx*vs,
// the difference squared as d*d, the three squares summed left to
// right, each operation rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, and the library is built with -fmad=false), the candidate
// order of _step_kernel (dz, then dy, then dx over -1, 0, 1, skipping
// the centre; `best` starts at the voxel's own seed) and strict `<`.
//
// The TPU kernel takes three (n, n) planes into VMEM per z and builds
// in-plane neighbours with rolls and masks. Here one thread computes
// one voxel and reads its 26 candidates straight from device memory;
// the planes z-k, z, z+k of a block's neighbours stay in the 50 MB L2.
// Bound on this card: the candidate reads (27 x 4 bytes a voxel, most
// of them from L2) and the per-candidate unpack and distance (~15
// flops). The step writes a second buffer; the caller ping-pongs.

#include <cuda_runtime.h>

#include "jfa_common.cuh"

namespace {

__global__ void flood_step_kernel(const int* __restrict__ seed,
                                  int* __restrict__ out,
                                  const float* __restrict__ org, int n, int k) {
  const long long nn = (long long)n * n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nn * n) return;
  const int x = (int)(i % n);
  const int y = (int)((i / n) % n);
  const int z = (int)(i / nn);
  const float ox = org[0], oy = org[1], oz = org[2], vs = org[3];
  const float px = __fadd_rn(ox, __fmul_rn((float)x, vs));
  const float py = __fadd_rn(oy, __fmul_rn((float)y, vs));
  const float pz = __fadd_rn(oz, __fmul_rn((float)z, vs));

  int best = seed[i];
  float best_d2 = seed_d2(best, px, py, pz, ox, oy, oz, vs);
  for (int dz = -1; dz <= 1; ++dz) {
    const int zn = z + dz * k;
    const bool zok = zn >= 0 && zn < n;
    for (int dy = -1; dy <= 1; ++dy) {
      const int yn = y + dy * k;
      const bool yok = yn >= 0 && yn < n;
      for (int dx = -1; dx <= 1; ++dx) {
        if (dz == 0 && dy == 0 && dx == 0) continue;
        const int xn = x + dx * k;
        const bool ok = zok && yok && xn >= 0 && xn < n;
        const int cand = ok ? seed[zn * nn + (long long)yn * n + xn] : -1;
        const float d2 = seed_d2(cand, px, py, pz, ox, oy, oz, vs);
        if (d2 < best_d2) {
          best_d2 = d2;
          best = cand;
        }
      }
    }
  }
  out[i] = best;
}

// B4. The TPU kernel exists because at N = 1024 the full-plane step's
// ~26 live (n, n) candidate planes exceed VMEM: it computes (1, H, n)
// row bands from nine (1, H, n) source bands, one per (dz, dy), with
// the dy shift in block index maps and the dx shift as lane rolls. On
// this card nothing has to fit on chip, so the band keeps only its
// scheduling role: one block per (x chunk of kCols, band of `band`
// rows, z), walking its band kRows rows at a time. Each pass stages in
// shared memory the source window of its (kRows, kCols) tile for the
// three planes z - k, z, z + k: per axis the rows (columns) tile +
// dy*k for dy = -1, 0, 1, which is one window of tile + 2k when k is
// below the tile and three tile-sized windows otherwise; -1 outside
// the grid. The 26 candidates are then read from shared memory.
// Selection is B3's, term for term and in its order, so the result is
// bitwise B3's at every k and every band height; n and the band need
// not divide each other.
//
// Bound on this card: like B3, the candidate unpack and distance (~14
// flops per candidate that holds a seed). Device memory: every staged
// element is read once per pass, 27 reads a voxel at large k (B3's 27,
// now coalesced), fewer at small k where the windows overlap. The
// staging loops step by the tile sizes, so no address needs a division
// by a runtime value: integer division dominated a flat-index staging
// loop at large k.
constexpr int kRows = 8;
constexpr int kCols = 32;

__host__ __device__ __forceinline__ int window_len(int tile, int k) {
  return k < tile ? tile + 2 * k : 3 * tile;
}

// Window slot of tile offset t shifted by d*k, d in {-1, 0, 1}.
__device__ __forceinline__ int window_slot(int t, int d, int tile, int k) {
  return k < tile ? t + d * k + k : (d + 1) * tile + t;
}

// Tile offset + shift of window slot s (the inverse of window_slot).
__device__ __forceinline__ int window_offset(int s, int tile, int k) {
  return k < tile ? s - k : s % tile + (s / tile - 1) * k;
}

__global__ void flood_step_rows_kernel(const int* __restrict__ seed,
                                       int* __restrict__ out,
                                       const float* __restrict__ org, int n,
                                       int k, int band) {
  __shared__ int stage[3 * (3 * kRows) * (3 * kCols)];
  const int x0 = blockIdx.x * kCols;
  const int y_band = blockIdx.y * band;
  const int y_end = min(y_band + band, n);
  const int z = blockIdx.z;
  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int rl = window_len(kRows, k);
  const int cl = window_len(kCols, k);
  const long long nn = (long long)n * n;
  const float ox = org[0], oy = org[1], oz = org[2], vs = org[3];
  const int x = x0 + tx;
  const float px = __fadd_rn(ox, __fmul_rn((float)x, vs));
  const float pz = __fadd_rn(oz, __fmul_rn((float)z, vs));

  for (int y0 = y_band; y0 < y_end; y0 += kRows) {
    __syncthreads();  // the previous pass has read the stage
    // Thread (ty, tx) stages rows ty, ty + kRows, ... and columns tx,
    // tx + kCols, ... of each plane's window: no division by a runtime
    // value (kRows and kCols are powers of two), coalesced along x.
    for (int dzi = 0; dzi < 3; ++dzi) {
      const int zn = z + (dzi - 1) * k;
      const bool zok = zn >= 0 && zn < n;
      for (int sr = ty; sr < rl; sr += kRows) {
        const int yn = y0 + window_offset(sr, kRows, k);
        const bool yok = zok && yn >= 0 && yn < n;
        const int* src = seed + (yok ? zn * nn + (long long)yn * n : 0);
        int* dst = stage + (dzi * rl + sr) * cl;
        for (int sc = tx; sc < cl; sc += kCols) {
          const int xn = x0 + window_offset(sc, kCols, k);
          dst[sc] = yok && xn >= 0 && xn < n ? src[xn] : -1;
        }
      }
    }
    __syncthreads();
    const int y = y0 + ty;
    if (y >= y_end || x >= n) continue;
    const float py = __fadd_rn(oy, __fmul_rn((float)y, vs));
    const int* own = stage + (rl + window_slot(ty, 0, kRows, k)) * cl;
    int best = own[window_slot(tx, 0, kCols, k)];
    float best_d2 = seed_d2(best, px, py, pz, ox, oy, oz, vs);
    for (int dz = -1; dz <= 1; ++dz) {
      for (int dy = -1; dy <= 1; ++dy) {
        const int* row = stage + ((dz + 1) * rl + window_slot(ty, dy, kRows, k)) * cl;
        for (int dx = -1; dx <= 1; ++dx) {
          if (dz == 0 && dy == 0 && dx == 0) continue;
          const int cand = row[window_slot(tx, dx, kCols, k)];
          const float d2 = seed_d2(cand, px, py, pz, ox, oy, oz, vs);
          if (d2 < best_d2) {
            best_d2 = d2;
            best = cand;
          }
        }
      }
    }
    out[z * nn + (long long)y * n + x] = best;
  }
}

// B6. The TPU kernel walks the planes of one residue class r (mod k) in
// a sequential grid (k, n/k + 1), carries the previous and current
// planes in VMEM scratch, reads each seed plane once per step and
// unpacks each seed once into world coordinates (sxw, syw, szw), +inf
// in z for no seed, so a candidate costs the distance alone. Blocks run
// in no order here, so the walk goes inside the block: one block per
// (in-plane tile of kRows x kCols, residue r, run of kPipeWalk planes of
// that residue) walks z = r + j*k with a ring of three staged source
// windows in shared memory (planes z - k, z, z + k), each window B4's
// tile + (-k, 0, +k) per axis, each entry unpacked once as a float4
// (sxw, syw, szw, seed bits); -1 (+inf in z) outside the grid. A plane
// outside the grid contributes only +inf candidates, which strict `<`
// never takes, so its nine candidates are skipped.
//
// Exactness: sxw = ox + sx*vs as in seed_d2, d2 = (px - sxw)^2 +
// (py - syw)^2 + (pz - szw)^2 left to right, each operation rounded on
// its own: the same floats as seed_d2, so with B3's candidate order and
// strict `<` the result is B3's bit for bit. With emit_sdf the output
// is sign(occ) * best_d2 as float32: best_d2 is the distance of the
// chosen seed by B5's formula, so the k = 1 step equals B5 after B3.
//
// Bound on this card: the distance of each candidate (8 flops, from
// shared memory) now that the unpack (6 flops and 3 conversions) is
// done once per staged seed, not 26 times; device memory reads fall
// from B3's 27 a voxel to the window's 9 at large k and ~1.3 at k = 1.
// Shared memory is 3 windows of up to 24 x 96 float4 (110,592 bytes):
// two blocks an SM.
constexpr int kPipeWalk = 32;

__device__ __forceinline__ float4 world_of(int s, float ox, float oy, float oz,
                                           float vs) {
  float4 w;
  w.x = __fadd_rn(ox, __fmul_rn((float)(s & kMask10), vs));
  w.y = __fadd_rn(oy, __fmul_rn((float)((s >> 10) & kMask10), vs));
  w.z = s < 0 ? __int_as_float(0x7f800000)
              : __fadd_rn(oz, __fmul_rn((float)((s >> 20) & kMask10), vs));
  w.w = __int_as_float(s);
  return w;
}

__device__ __forceinline__ float world_d2(float4 w, float px, float py,
                                          float pz) {
  const float dx = __fsub_rn(px, w.x);
  const float dy = __fsub_rn(py, w.y);
  const float dz = __fsub_rn(pz, w.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void flood_step_pipe_kernel(const int* __restrict__ seed,
                                       const unsigned char* __restrict__ occ,
                                       const float* __restrict__ org,
                                       void* __restrict__ out, int n, int k,
                                       int emit_sdf) {
  extern __shared__ float4 ring[];  // [3][rl][cl]
  const int tiles_x = (n + kCols - 1) / kCols;
  const int x0 = (blockIdx.x % tiles_x) * kCols;
  const int y0 = (blockIdx.x / tiles_x) * kRows;
  const int r = blockIdx.y;
  const int planes = (n - 1 - r) / k + 1;  // z = r, r + k, ... < n
  const int j0 = blockIdx.z * kPipeWalk;
  if (j0 >= planes) return;
  const int j1 = min(j0 + kPipeWalk, planes);
  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int rl = window_len(kRows, k);
  const int cl = window_len(kCols, k);
  const int plane = rl * cl;
  const long long nn = (long long)n * n;
  const float ox = org[0], oy = org[1], oz = org[2], vs = org[3];
  const int x = x0 + tx;
  const int y = y0 + ty;
  const float px = __fadd_rn(ox, __fmul_rn((float)x, vs));
  const float py = __fadd_rn(oy, __fmul_rn((float)y, vs));

  // Stage plane j of the residue into ring slot j % 3.
  auto stage = [&](int j) {
    const int* src = seed + (long long)(r + j * k) * nn;
    float4* dst = ring + (j % 3) * plane;
    for (int sr = ty; sr < rl; sr += kRows) {
      const int yn = y0 + window_offset(sr, kRows, k);
      const bool yok = yn >= 0 && yn < n;
      const int* row = src + (yok ? (long long)yn * n : 0);
      for (int sc = tx; sc < cl; sc += kCols) {
        const int xn = x0 + window_offset(sc, kCols, k);
        const int s = yok && xn >= 0 && xn < n ? row[xn] : -1;
        dst[sr * cl + sc] = world_of(s, ox, oy, oz, vs);
      }
    }
  };

  if (j0 >= 1) stage(j0 - 1);
  stage(j0);
  for (int j = j0; j < j1; ++j) {
    if (j + 1 < planes) stage(j + 1);
    __syncthreads();
    if (x < n && y < n) {
      const int z = r + j * k;
      const float pz = __fadd_rn(oz, __fmul_rn((float)z, vs));
      const float4 own = ring[(j % 3) * plane + window_slot(ty, 0, kRows, k) * cl +
                              window_slot(tx, 0, kCols, k)];
      int best = __float_as_int(own.w);
      float best_d2 = world_d2(own, px, py, pz);
      for (int dz = -1; dz <= 1; ++dz) {
        if ((dz < 0 && j == 0) || (dz > 0 && j + 1 >= planes)) continue;
        const float4* src = ring + ((j + dz + 3) % 3) * plane;
        for (int dy = -1; dy <= 1; ++dy) {
          const float4* row = src + window_slot(ty, dy, kRows, k) * cl;
          for (int dx = -1; dx <= 1; ++dx) {
            if (dz == 0 && dy == 0 && dx == 0) continue;
            const float4 c = row[window_slot(tx, dx, kCols, k)];
            const float d2 = world_d2(c, px, py, pz);
            if (d2 < best_d2) {
              best_d2 = d2;
              best = __float_as_int(c.w);
            }
          }
        }
      }
      const long long i = z * nn + (long long)y * n + x;
      if (emit_sdf) {
        ((float*)out)[i] = __fmul_rn(occ[i] ? 1.0f : -1.0f, best_d2);
      } else {
        ((int*)out)[i] = best;
      }
    }
    __syncthreads();  // every thread has read slot (j - 1) % 3 before it is restaged
  }
}

__global__ void sdf_from_seed_kernel(const int* __restrict__ seed,
                                     const unsigned char* __restrict__ occ,
                                     const float* __restrict__ org,
                                     float* __restrict__ out, int n) {
  const long long nn = (long long)n * n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nn * n) return;
  const int x = (int)(i % n);
  const int y = (int)((i / n) % n);
  const int z = (int)(i / nn);
  const float ox = org[0], oy = org[1], oz = org[2], vs = org[3];
  const float px = __fadd_rn(ox, __fmul_rn((float)x, vs));
  const float py = __fadd_rn(oy, __fmul_rn((float)y, vs));
  const float pz = __fadd_rn(oz, __fmul_rn((float)z, vs));
  const float sign = occ[i] ? 1.0f : -1.0f;
  out[i] = __fmul_rn(sign, seed_d2(seed[i], px, py, pz, ox, oy, oz, vs));
}

constexpr int kThreads = 256;

unsigned int blocks_for(int n) {
  const long long total = (long long)n * n * n;
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int vt_flood_step(const void* seed, void* out, const void* org,
                             int n, int k, void* stream) {
  flood_step_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)seed, (int*)out, (const float*)org, n, k);
  return (int)cudaGetLastError();
}

extern "C" int vt_flood_step_rows(const void* seed, void* out, const void* org,
                                  int n, int k, int band, void* stream) {
  const dim3 grid((n + kCols - 1) / kCols, (n + band - 1) / band, n);
  flood_step_rows_kernel<<<grid, kRows * kCols, 0, (cudaStream_t)stream>>>(
      (const int*)seed, (int*)out, (const float*)org, n, k, band);
  return (int)cudaGetLastError();
}

// B6: out is int32 seeds, or with emit_sdf float32 sign(occ) * d2
// (occ read only then). Any 1 <= k < n; the wrapper sends k | n.
extern "C" int vt_flood_step_pipe(const void* seed, const void* occ,
                                  const void* org, void* out, int n, int k,
                                  int emit_sdf, void* stream) {
  const int tiles = ((n + kCols - 1) / kCols) * ((n + kRows - 1) / kRows);
  const int walks = ((n + k - 1) / k + kPipeWalk - 1) / kPipeWalk;
  const size_t smem =
      3 * (size_t)window_len(kRows, k) * window_len(kCols, k) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flood_step_pipe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flood_step_pipe_kernel<<<dim3(tiles, k, walks), kRows * kCols, smem,
                           (cudaStream_t)stream>>>(
      (const int*)seed, (const unsigned char*)occ, (const float*)org, out, n,
      k, emit_sdf);
  return (int)cudaGetLastError();
}

extern "C" int vt_sdf_from_seed(const void* seed, const void* occ,
                                const void* org, void* out, int n,
                                void* stream) {
  sdf_from_seed_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)seed, (const unsigned char*)occ, (const float*)org,
      (float*)out, n);
  return (int)cudaGetLastError();
}
