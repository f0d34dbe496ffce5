// Jump Flooding kernels of the SDF op, for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of voxtpu/ops/jfa_pallas.py:
//   B3  _step_kernel           (vt_flood_step): one flood step at stride k
//   B4  _step_kernel_yblocked  (vt_flood_step_rows): the same step in
//                              (1, H, n) row bands, for 512 < N <= 1024
//   B5  _final_kernel          (vt_sdf_from_seed): signed squared distance,
//                              one 16-byte stream of 4 voxels a thread
//   B6  _pipe_kernel           (vt_flood_step_pipe): B3 at a stride k | n,
//                              the walk's third entry; at k = 1 optionally
//                              with B5 fused into its write-out (JFA_PIPE=1)
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
// B3, B4 and B6: one lattice walk (flood_walk), three entry points. The TPU
// kernel takes three (n, n) planes into VMEM per z and builds in-plane
// neighbours with rolls and masks; B4 exists because at N = 1024 the
// ~26 live candidate planes exceed VMEM. On this card the step's bound
// is its operations (chip_smoke.py's `flood_ops`), uncontracted (no
// FMA) at 128 a clock an SM: one unpack of each seed (9), per seeded
// (source entry, voxel column) pair (px - sx)^2 + (py - sy)^2 (5), per
// seeded candidate (pz - sz)^2 and the sum (3). A dense voxel needs
// ~135: 0.54 ms for a dense 512^3 step, 4.3 ms at 1024^3 (NVIDIA H100
// 80GB HBM3, 700 W; the bytes, the grid read and written once, take
// 0.32 and 2.56 ms). The earlier one-thread-a-voxel form (kept as
// P1's `legacy`, csrc/jfa_probe.cu) read 27 seeds a voxel from L2 and
// unpacked each again (3 int-to-float conversions at 16 a clock an
// SM): 6.1 ms a dense 512^3 step on that card (PERF.md). The walk:
//
// - A block is 8 warps x 32 lanes. A warp computes one row y of a
//   residue class y mod k (the block holds `per` residues of `mr` rows,
//   so at k >= n/2 no warp idles); a thread computes up to 4 columns,
//   lane + 32c below k = 32 and rho + c*k of residue rho = lane (mod k)
//   from k = 32 (x a lattice too, loads still 32 contiguous seeds); the
//   block walks 32 planes of one residue class z mod k. Its source
//   window is then one plane of mr + 2 rows a residue and 32*cols + 2k
//   columns, or cols + 2 chunks of 32: 1.3-1.9 staged seeds a voxel
//   (the one-thread form read 27).
// - Staging: plane p + 2's raw seeds are copied into a ring of 3 planes
//   in shared memory by cp.async (no registers, 2 planes in flight);
//   entries outside the grid hold -1 from the start. Each thread then
//   unpacks its own entries of plane p once into the window as float4
//   world coordinates (x, y, z, seed bits; z = +inf without a seed, so
//   strict `<` never takes it and no candidate branches), the fields
//   exactly by 2^23 + f - 2^23 at the float rate. Two barriers a plane.
// - Source plane order. Plane p holds the dz = +1 candidates of voxel
//   plane p - 1, the dz = 0 ones of p and the dz = -1 ones of p + 1. A
//   thread reads each of its nine window entries a column once,
//   computes (px - sx)^2 + (py - sy)^2 once and adds (pz - sz)^2 for
//   each of the three voxel planes: the same floats as the full
//   formula. Each voxel plane keeps a running (d2, seed) over its three
//   groups in candidate order; its own seed comes with plane p, after
//   its dz = -1 group, and is taken on `<=` (the own seed is first in
//   the order, so it wins ties): the sequential result.
// - Exact skips: a plane whose window holds no seed (__syncthreads_or),
//   or a column whose nine raw seeds hold none for any lane of a warp
//   (__any_sync on their AND), adds only +inf candidates: skipped.
// - No division a voxel: the launch geometry (lattice, grid, shared
//   bytes) comes from the wrapper (`jfa_cuda._walk_geometry`, tested on
//   the CPU); the kernel divides a few times a block.
//
// What holds it above the bound (tools/ablate_flood_step.py, PERF.md):
// each candidate costs a 16-byte shared load (4 wavefronts a warp) and
// ~9 issued instructions, so shared-memory bandwidth and issue both run
// near their limits in the dense steps; barriers, occupancy (3 blocks
// an SM at 80 registers) and the copies' latency do not.
//
// B4 is the walk with its blocks confined to one band of `band` rows:
// the y lattice is taken within the band, the candidates come from the
// whole grid. Its result is B3's at every k and band; n, band and k
// need not divide each other. Where k >= band a residue has one row a
// band, so its window stages 3 rows a computed row.
//
// B6 is the walk at a stride k | n (voxtpu's residue walk), and at k = 1
// with emit_sdf the walk whose write-out stores the signed distance of
// the chosen seed: B5 fused in, bitwise (see flood_sdf_kernel).
//
// B5 is a stream: per voxel sign(occ) * d2 of its seed, 9 bytes (seed 4,
// occ 1, out 4) and no reuse, so its bound is bytes: 1.21 GB at 512^3,
// 0.36 ms at 3.35 TB/s, and 2.88 ms at 1024^3 (NVIDIA H100 80GB HBM3,
// 700 W). A warp takes a stretch of one row, a thread 4 voxels: one
// int4 of seeds, one 32-bit word of occ bytes and one float4 out, the
// store streamed (st.global.cs). No 64-bit index or division by n: the
// grid is (x groups, row groups, plane), and py, pz are computed once a
// row. Seed fields and columns become floats exactly by 2^23 + f - 2^23
// (field_f) at the float rate, not by int-to-float conversions at 16 a
// clock an SM; the distance is B6's fused write-out (signed_d2), so the
// roundings are seed_d2's. Rows that do not start on a 16-byte boundary
// (n % 4 != 0) take their first and last voxels one by one.

// Two tools match this file's text. tests/test_torch_flood_emulated.py
// runs it on the host by rewriting the cuda_runtime.h include, each
// `extern __shared__` array, each `<<<...>>>` launch and the asm of the
// three cp.async helpers; tools/ablate_flood_step.py substitutes the
// lines marked "ablate". A change to those lines' text changes the
// tools with it.

#include <cuda_runtime.h>

#include "jfa_common.cuh"

namespace {

constexpr int kTileX = 32;  // lanes a warp
constexpr int kTileY = 8;   // warps a block: one voxel row each
constexpr int kColsMax = 4; // voxel columns a thread, at most
constexpr int kWalk = 32;   // voxel planes a block walks
constexpr int kRing = 3;    // raw planes in shared memory: 2 in flight

// The walk's lattice, from `_walk_geometry`: a block holds
// per = kTileY >> mr_shift residues of mr = 1 << mr_shift rows;
// blockIdx.y = (band * groups + group) * chunks + chunk,
// blockIdx.z = rz * walks + walk. A thread computes `cols` columns:
// below k = 32 the block's 32*cols contiguous ones, lane + 32c; from
// k = 32 columns rho + c*k of residue rho (mod k), blockIdx.x =
// slice * x_groups + x_group, rho = 32*slice + lane.
struct WalkGeom {
  int n, k, band, mr_shift, chunks, groups, walks, cols, x_groups;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Field f of a packed seed as a float, exactly: 2^23 + f, less 2^23
// (f < 2^10).
__device__ __forceinline__ float field_f(int s, int shift) {
  return __fsub_rn(__int_as_float(0x4B000000 | ((s >> shift) & kMask10)), 8388608.0f);
}

// A seed in world coordinates (x, y, z, seed bits); no seed: z = +inf
// (the -1 sentinel's masked fields give finite x and y, never used).
__device__ __forceinline__ float4 unpack_world(int s, float ox, float oy,
                                               float oz, float vs) {
  const float z = __fadd_rn(oz, __fmul_rn(field_f(s, 20), vs));
  return make_float4(__fadd_rn(ox, __fmul_rn(field_f(s, 0), vs)),
                     __fadd_rn(oy, __fmul_rn(field_f(s, 10), vs)),
                     s < 0 ? inf_f() : z, __int_as_float(s));
}

// (px - sx)^2 + (py - sy)^2 of a staged seed: the first two terms of
// the distance, summed as the full formula sums them.
__device__ __forceinline__ float dist_xy(float4 w, float px, float py) {
  const float dx = __fsub_rn(px, w.x);
  const float dy = __fsub_rn(py, w.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float dist_z(float hxy, float4 w, float pz) {
  const float dz = __fsub_rn(pz, w.z);
  return __fadd_rn(hxy, __fmul_rn(dz, dz));
}

// Strict `<`: an equal distance keeps the earlier candidate. fminf
// (never NaN here) issues on the float pipe where a select would not.
__device__ __forceinline__ void take(float d2, float4 w, float& best_d2,
                                     int& best) {
  best = d2 < best_d2 ? __float_as_int(w.w) : best;
  best_d2 = fminf(best_d2, d2);
}

// The running selection of one voxel column over three voxel planes:
// p - 1 (prev), p (cur), p + 1 (next).
struct Column {
  float prev_d2, cur_d2, next_d2;
  int prev, cur, next;
};

// Plane p's nine window entries of a column (dy-major from `at`, the
// entry of dy = dx = -1; candidate order) into the selections of voxel
// planes p - 1 (dz = +1 group), p (own seed, then the dz = 0 group) and
// p + 1 (dz = -1 group); kAll: all three planes are the block's.
template <bool kAll>
__device__ __forceinline__ void add_plane(const float4* at, int cols, int cstep,
                                          float px, float py, float pz_prev,
                                          float pz_cur, float pz_next,
                                          bool use_prev, bool use_cur,
                                          bool use_next, Column& a) {
  const float4 w_own = at[cols + cstep];
  const float h_own = dist_xy(w_own, px, py);
  if (kAll || use_cur) {
    const float d2 = dist_z(h_own, w_own, pz_cur);
    if (d2 <= a.cur_d2) {  // the own seed is first: it wins ties
      a.cur_d2 = d2;
      a.cur = __float_as_int(w_own.w);
    }
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float4 w = e == 4 ? w_own : at[(e / 3) * cols + (e % 3) * cstep];
    const float h = e == 4 ? h_own : dist_xy(w, px, py);
    if (kAll || use_next) take(dist_z(h, w, pz_next), w, a.next_d2, a.next);
    if (e != 4 && (kAll || use_cur)) take(dist_z(h, w, pz_cur), w, a.cur_d2, a.cur);
    if (kAll || use_prev) take(dist_z(h, w, pz_prev), w, a.prev_d2, a.prev);
  }
}

// One int copied from device to shared memory without passing through
// registers (cp.async, 4 bytes); a thread's copies are complete and
// visible to it after the wait for their group. The emulation test
// replaces these three helpers' asm statements by their text.
__device__ __forceinline__ void copy_async(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kSdf: the write-out stores sign(occ) * d2 of the chosen seed as a
// float (B6 fused with B5) instead of the seed; occ is read only then.
template <bool kBands, bool kSdf>
__device__ __forceinline__ void flood_walk(const int* __restrict__ seed,
                                           const unsigned char* __restrict__ occ,
                                           void* __restrict__ out,
                                           const float* __restrict__ org,
                                           const WalkGeom g) {
  // The unpacked window [srows][width], then kRing raw planes of it.
  extern __shared__ float4 window[];
  const int n = g.n, k = g.k, ncol = g.cols;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int mr = 1 << g.mr_shift;
  const int per = kTileY >> g.mr_shift;
  const int wrows = mr + 2;  // rows m - 1 .. m + mr of one residue
  const int srows = per * wrows;
  const bool lattice = k >= kTileX;
  const int cstep = lattice ? kTileX : k;  // window columns of dx = 1
  const int width = lattice ? kTileX * (ncol + 2) : kTileX * ncol + 2 * k;
  const int area = srows * width;
  int* ring = (int*)(window + area);

  int by = blockIdx.y;
  const int chunk = by % g.chunks;
  by /= g.chunks;
  const int group = by % g.groups;
  const int y_band = kBands ? by / g.groups * g.band : 0;
  const int y_end = kBands ? min(y_band + g.band, n) : n;
  const int res = min(k, y_end - y_band);  // residues in the band
  const int rz = blockIdx.z / g.walks;
  const int j0 = blockIdx.z % g.walks * kWalk;
  const int planes = (n - 1 - rz) / k + 1;  // z = rz, rz + k, ... < n
  if (j0 >= planes) return;
  const int j1 = min(j0 + kWalk, planes);
  const long long nn = (long long)n * n;
  const float ox = org[0], oy = org[1], oz = org[2], vs = org[3];

  // Column c of this thread is x0 + c*xstep; window column w of the
  // block is grid column xw + (w / 32) * kstep + w % 32 - 32 (lattice)
  // or x0 - tx - k + w (contiguous).
  bool lane_ok = true;
  int x0, xstep;
  if (lattice) {
    const int rho = blockIdx.x / g.x_groups * kTileX + tx;
    lane_ok = rho < k;
    x0 = rho + blockIdx.x % g.x_groups * ncol * k;
    xstep = k;
  } else {
    x0 = blockIdx.x * kTileX * ncol + tx;
    xstep = kTileX;
  }
  // The window entries this thread stages: rows ty + 8i and chunks of
  // 32 columns q, lane tx: grid row offsets y*n and columns x, -1
  // outside the grid or the window. A thread copies and unpacks only
  // its own entries.
  int src_row[3], src_col[kColsMax + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int sr = ty + i * kTileY;
    src_row[i] = -1;
    if (sr < srows) {
      const int r = group * per + sr / wrows;
      const int yy = y_band + r + (chunk * mr + sr % wrows - 1) * k;
      if (r < res && yy >= 0 && yy < n) src_row[i] = yy * n;
    }
  }
#pragma unroll
  for (int q = 0; q < kColsMax + 2; ++q) {
    const int xx = lattice ? x0 + (q - 1) * k : x0 - k + q * kTileX;
    const bool in_window = lattice ? q < ncol + 2 : tx + q * kTileX < width;
    src_col[q] = lane_ok && in_window && xx >= 0 && xx < n ? xx : -1;
  }
  // Entries outside the grid hold -1 in every ring slot, once: no copy
  // ever lands there.
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int q = 0; q < kColsMax + 2; ++q) {
      const int sr = ty + i * kTileY, w = tx + q * kTileX;
      if (sr < srows && w < width && (src_row[i] < 0 || src_col[q] < 0))
        for (int d = 0; d < kRing; ++d) ring[d * area + sr * width + w] = -1;
    }
  // This thread's voxels: row y of residue r, columns x0 + c*xstep; the
  // window index of column 0's entry of dy = dx = -1.
  const int r = group * per + (ty >> g.mr_shift);
  const int mm = ty & (mr - 1);
  const int y = y_band + r + (chunk * mr + mm) * k;
  const bool row_ok = r < res && y < y_end;  // one row a warp: uniform
  const int own = ((ty >> g.mr_shift) * wrows + mm) * width + tx;
  const float py = __fadd_rn(oy, __fmul_rn((float)y, vs));
  float px[kColsMax];
#pragma unroll
  for (int c = 0; c < kColsMax; ++c)
    px[c] = __fadd_rn(ox, __fmul_rn((float)(x0 + c * xstep), vs));

  // Plane p's entries into ring slot p % kRing; one group a call.
  const int p_last = min(j1, planes - 1);
  auto issue = [&](int p) {
    // ablate: the copies (loop_only)
    if (p <= p_last) {
      const int* plane = seed + (long long)(rz + p * k) * nn;
      int* slot = ring + (p % kRing) * area;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int q = 0; q < kColsMax + 2; ++q)
          if (src_row[i] >= 0 && src_col[q] >= 0)
            copy_async(slot + (ty + i * kTileY) * width + tx + q * kTileX,
                       plane + src_row[i] + src_col[q]);
    }
    commit_async();
  };
  auto pz_of = [&](int p) {
    return __fadd_rn(oz, __fmul_rn((float)(rz + p * k), vs));
  };

  Column col[kColsMax];
#pragma unroll
  for (int c = 0; c < kColsMax; ++c) {
    col[c].prev_d2 = col[c].cur_d2 = inf_f();
    col[c].prev = col[c].cur = -1;
  }
  const int p0 = max(j0 - 1, 0);
  float pz_prev = pz_of(p0 - 1), pz_cur = pz_of(p0);
#pragma unroll
  for (int d = 0; d < kRing - 1; ++d) issue(p0 + d);
  for (int p = p0; p <= j1; ++p) {
    const float pz_next = pz_of(p + 1);
#pragma unroll
    for (int c = 0; c < kColsMax; ++c) {
      col[c].next_d2 = inf_f();
      col[c].next = -1;
    }
    if (p < planes) {  // the block's planes: uniform
      wait_async<kRing - 2>();  // this thread's copies of plane p
      __syncthreads();          // every warp has read plane p - 1's window
      // Plane p's raw seeds: each thread unpacks its own entries; after
      // the next barrier the whole slot is read by the warps' votes (the
      // slot is refilled only after the next plane's first barrier).
      const int* slot = ring + (p % kRing) * area;
      int none = -1;  // AND of the seeds: negative iff none holds a seed
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int q = 0; q < kColsMax + 2; ++q) {
          const int sr = ty + i * kTileY, w = tx + q * kTileX;
          if (sr < srows && w < width) {  // ablate: the unpack (loop_only)
            const int s = slot[sr * width + w];
            window[sr * width + w] = unpack_world(s, ox, oy, oz, vs);
            none &= s;
          }
        }
      issue(p + kRing - 1);  // into plane p - 1's slot, unpacked before
      // ablate: the candidates (staging_only, loop_only)
      if (__syncthreads_or(none >= 0) && row_ok) {
        const bool use_prev = p - 1 >= j0, use_cur = p >= j0 && p < j1,
                   use_next = p + 1 < j1, all = use_prev && use_cur && use_next;
#pragma unroll
        for (int c = 0; c < kColsMax; ++c) {
          if (c >= ncol) break;  // uniform
          const int at = own + c * kTileX;
          int mine = -1;
#pragma unroll
          for (int e = 0; e < 9; ++e) mine &= slot[at + (e / 3) * width + (e % 3) * cstep];
          if (!__any_sync(0xffffffffu, mine >= 0)) continue;  // ablate: no_vote
          // ablate: both add_plane calls (no_distances)
          if (all) {
            add_plane<true>(window + at, width, cstep, px[c], py, pz_prev, pz_cur,
                            pz_next, true, true, true, col[c]);
          } else {
            add_plane<false>(window + at, width, cstep, px[c], py, pz_prev, pz_cur,
                             pz_next, use_prev, use_cur, use_next, col[c]);
          }
        }
      }
    }
    if (p - 1 >= j0 && row_ok && lane_ok) {
      const long long row = (rz + (p - 1) * k) * nn + (long long)y * n;
#pragma unroll
      for (int c = 0; c < kColsMax; ++c) {
        const int x = x0 + c * xstep;
        if (c >= ncol || x >= n) continue;
        if constexpr (kSdf) {
          ((float*)out)[row + x] = __fmul_rn(occ[row + x] ? 1.0f : -1.0f, col[c].prev_d2);
        } else {
          ((int*)out)[row + x] = col[c].prev;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kColsMax; ++c) {
      col[c].prev_d2 = col[c].cur_d2;
      col[c].prev = col[c].cur;
      col[c].cur_d2 = col[c].next_d2;
      col[c].cur = col[c].next;
    }
    pz_prev = pz_cur;
    pz_cur = pz_next;
  }
}

__global__ void __launch_bounds__(kTileX* kTileY, 3)
    flood_step_kernel(const int* __restrict__ seed, const unsigned char* __restrict__ occ,
                      void* __restrict__ out, const float* __restrict__ org,
                      const WalkGeom g) {
  flood_walk<false, false>(seed, occ, out, org, g);
}

__global__ void __launch_bounds__(kTileX* kTileY, 3)
    flood_step_rows_kernel(const int* __restrict__ seed,
                           const unsigned char* __restrict__ occ, void* __restrict__ out,
                           const float* __restrict__ org, const WalkGeom g) {
  flood_walk<true, false>(seed, occ, out, org, g);
}

// B6. voxtpu's _pipe_kernel is B3's step at a stride k that divides n:
// it walks the planes of one residue class z mod k in order, unpacks
// each seed once into world coordinates and keeps the neighbour planes
// in VMEM; with emit_sdf (voxtpu runs it at k = 1) it writes sign(occ)
// * d2 of the chosen seed instead of the seed, B5 after B3. On this card
// that design is the lattice walk above, so B6 is the walk's third
// entry: vt_flood_step_pipe launches flood_step_kernel (B3's own), or
// with emit_sdf this kernel, the walk whose write-out stores
// __fmul_rn(occ ? 1 : -1, prev_d2) in place of prev.
//
// Why the fused write-out is B5 after B3 bit for bit: prev_d2 is the
// chosen seed's distance, dist_z(dist_xy(w, px, py), w, pz) of
// unpack_world's floats. Those are seed_d2 / packed_d2's floats
// (jfa_common.cuh), in the same association, and B5 evaluates the same
// function (signed_d2) on them: the
// fields exactly (field_f is (float)f), ox + f*vs, px - sx and the
// squares each rounded on their own, (dx^2 + dy^2) + dz^2; px, py, pz as
// B5 computes them. `take` keeps d2 with fminf and the own seed's `<=`
// keeps an equal value, so prev_d2 is the least candidate distance,
// which is the chosen seed's. A voxel with no seed keeps +inf (B5's
// value for the -1 sentinel), and the exact skips leave a column at
// (-1, +inf), which is B5's result for it too. The product with +-1.0f
// is B5's. tests/test_torch_flood_emulated.py holds it bitwise.
__global__ void __launch_bounds__(kTileX* kTileY, 3)
    flood_sdf_kernel(const int* __restrict__ seed, const unsigned char* __restrict__ occ,
                     void* __restrict__ out, const float* __restrict__ org,
                     const WalkGeom g) {
  flood_walk<false, true>(seed, occ, out, org, g);
}

// B5. Grid (x groups, ceil(n / kSdfRows), n), kTileX x kSdfRows
// threads: a warp a stretch of one row of plane blockIdx.z, a thread 4
// consecutive voxels from the row's first 16-byte boundary (one int4 of
// seeds, one 32-bit word of 4 occ bytes, one float4 out, streamed past
// the caches: each byte is used once). The thread past the row's last
// vector, j == vecs, takes the voxels before that boundary and after
// the last vector one by one (n % 4 != 0; none otherwise).
constexpr int kSdfRows = 8;

// sign(occ) * d2 of one voxel, B6's fused write-out: unpack_world's
// floats, (px - sx)^2 + (py - sy)^2, then + (pz - sz)^2 (+inf without a
// seed), times +-1.
__device__ __forceinline__ float signed_d2(int s, unsigned o, float px, float py,
                                           float pz, float ox, float oy, float oz,
                                           float vs) {
  const float4 w = unpack_world(s, ox, oy, oz, vs);
  return __fmul_rn(o ? 1.0f : -1.0f, dist_z(dist_xy(w, px, py), w, pz));
}

__global__ void __launch_bounds__(kTileX* kSdfRows)
    sdf_from_seed_kernel(const int* __restrict__ seed,
                         const unsigned char* __restrict__ occ,
                         const float* __restrict__ org, float* __restrict__ out,
                         int n) {
  const int y = blockIdx.y * kSdfRows + threadIdx.y;
  if (y >= n) return;
  const long long r0 = ((long long)blockIdx.z * n + y) * n;  // the row's first voxel
  const int head = min((int)(-r0 & 3), n);  // voxels before its first 16-byte boundary
  const int vecs = (n - head) >> 2;
  const int j = blockIdx.x * kTileX + threadIdx.x;
  if (j > vecs) return;
  const float ox = org[0], oy = org[1], oz = org[2], vs = org[3];
  // Columns and rows as floats exactly (field_f: f < 2^10), once a row.
  const float py = __fadd_rn(oy, __fmul_rn(field_f(y, 0), vs));
  const float pz = __fadd_rn(oz, __fmul_rn(field_f(blockIdx.z, 0), vs));
  const int* srow = seed + r0;
  const unsigned char* orow = occ + r0;
  float* drow = out + r0;
  if (j < vecs) {
    const int x = head + 4 * j;
    const int4 s = __ldcs(reinterpret_cast<const int4*>(srow + x));
    const unsigned o = __ldcs(reinterpret_cast<const unsigned*>(orow + x));
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __fadd_rn(ox, __fmul_rn(field_f(x + i, 0), vs));
    const float4 d = make_float4(signed_d2(s.x, o & 0xFFu, p[0], py, pz, ox, oy, oz, vs),
                                 signed_d2(s.y, o & 0xFF00u, p[1], py, pz, ox, oy, oz, vs),
                                 signed_d2(s.z, o & 0xFF0000u, p[2], py, pz, ox, oy, oz, vs),
                                 signed_d2(s.w, o & 0xFF000000u, p[3], py, pz, ox, oy, oz, vs));
    __stcs(reinterpret_cast<float4*>(drow + x), d);
    return;
  }
  for (int x = 0; x < n; ++x) {
    if (x == head) x = head + 4 * vecs;  // past the vectors
    if (x >= n) break;
    const float px = __fadd_rn(ox, __fmul_rn(field_f(x, 0), vs));
    drow[x] = signed_d2(srow[x], orow[x], px, py, pz, ox, oy, oz, vs);
  }
}

}  // namespace

// B3, B4 and B6: the launch geometry comes from `_walk_geometry` (blocks
// of kTileX x kTileY threads, `smem` bytes of window and ring).
template <typename Kernel>
int launch_walk(Kernel kernel, const void* seed, const void* occ, void* out,
                const void* org, WalkGeom g, int gx, int gy, int gz, int smem,
                void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(gx, gy, gz), dim3(kTileX, kTileY), smem, (cudaStream_t)stream>>>(
      (const int*)seed, (const unsigned char*)occ, out, (const float*)org, g);
  return (int)cudaGetLastError();
}

extern "C" int vt_flood_step(const void* seed, void* out, const void* org,
                             int n, int k, int mr_shift, int chunks,
                             int groups, int walks, int cols, int x_groups,
                             int gx, int gy, int gz, int smem, void* stream) {
  return launch_walk(flood_step_kernel, seed, nullptr, out, org,
                     WalkGeom{n, k, n, mr_shift, chunks, groups, walks, cols, x_groups},
                     gx, gy, gz, smem, stream);
}

extern "C" int vt_flood_step_rows(const void* seed, void* out, const void* org,
                                  int n, int k, int band, int mr_shift,
                                  int chunks, int groups, int walks, int cols,
                                  int x_groups, int gx, int gy, int gz,
                                  int smem, void* stream) {
  return launch_walk(flood_step_rows_kernel, seed, nullptr, out, org,
                     WalkGeom{n, k, band, mr_shift, chunks, groups, walks, cols, x_groups},
                     gx, gy, gz, smem, stream);
}

// B6: B3's walk at (n, k) with `_walk_geometry(n, k, n)`; out is int32
// seeds, or with emit_sdf float32 sign(occ) * d2 (occ read only then).
// Any 1 <= k < n; the wrapper sends k | n.
extern "C" int vt_flood_step_pipe(const void* seed, const void* occ, const void* org,
                                  void* out, int n, int k, int emit_sdf, int mr_shift,
                                  int chunks, int groups, int walks, int cols,
                                  int x_groups, int gx, int gy, int gz, int smem,
                                  void* stream) {
  const WalkGeom g{n, k, n, mr_shift, chunks, groups, walks, cols, x_groups};
  if (emit_sdf)
    return launch_walk(flood_sdf_kernel, seed, occ, out, org, g, gx, gy, gz, smem, stream);
  return launch_walk(flood_step_kernel, seed, nullptr, out, org, g, gx, gy, gz, smem, stream);
}

extern "C" int vt_sdf_from_seed(const void* seed, const void* occ,
                                const void* org, void* out, int n,
                                void* stream) {
  // 16-byte seeds and out, 4-byte occ: the vectors' alignment.
  if (((size_t)seed | (size_t)out) % 16 != 0 || (size_t)occ % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = (n + 3) / 4;  // a row's vectors, and its scalar thread
  const dim3 grid((threads + kTileX - 1) / kTileX, (n + kSdfRows - 1) / kSdfRows, n);
  sdf_from_seed_kernel<<<grid, dim3(kTileX, kSdfRows), 0, (cudaStream_t)stream>>>(
      (const int*)seed, (const unsigned char*)occ, (const float*)org,
      (float*)out, n);
  return (int)cudaGetLastError();
}
