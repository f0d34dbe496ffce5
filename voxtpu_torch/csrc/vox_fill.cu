// Suffix-fill parity kernels of the solid voxelizer, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of voxtpu:
//   B1  voxtpu/ops/vox_slots_banded.py::_banded_kernel  (vt_banded_fill)
//   B2  voxtpu/ops/vox_pallas.py::_pallas_kernel         (vt_wide_fill)
//
// Both compute, for the batches of slots (local cell, x entry) of one YZ
// tile, the XOR over the live slots of the suffix fill mask of x (every
// voxel of the cell's x row from x to the end), packed 32 voxels to a
// word. Parity is additive mod 2, so batches compose by XOR in any order.
// B1 takes a slot as live when x lies in its batch's band (bwords words
// from the batch's base word), B2 anywhere in the row.
//
// The TPU kernels build the same words from one-hot x suffix-step int8
// matmuls on the MXU and two exact bf16 packing matmuls, and accumulate a
// tile's batches in VMEM between FIRST and LAST flags of their sequential
// grid. Here a thread-block cluster owns a tile (or, where a tile's rows
// do not fit one block's shared memory, a group of its cells):
//
// - The plan lists its tiles busy first (`order`: the nbusy tiles that
//   hold a batch, ascending, then the others) and the busy tiles' batch
//   ranges over the non-decreasing batch_tile (`start`: busy tile i's
//   batches are [start[i], start[i + 1])). Cluster i < nbusy * groups
//   takes cell group i % groups of busy tile i / groups; the clusters
//   after them are zero writers, whose blocks store whole empty tiles
//   (about 32 KB a block), with no shared memory and no barrier. Every
//   block of a busy cluster also writes a share of the empty tiles. The
//   in-place form writes no zeros.
// - A busy cluster's blocks take the tile's batches in turn: block r of C
//   takes batches r, r + C, ..., as rows of 128 slots.
// - Each block keeps the group's whole rows in its shared memory: the
//   in-word masks, 0xFFFFFFFF << (x & 31) at word x >> 5, and one flip
//   marker bit a word, at x >> 5 + 1, each by a shared atomicXor. A
//   marker past the last word is dropped. A batch whose band lies outside
//   the row is skipped; one whose tile lies outside [0, num_tiles) is in
//   no busy tile's range.
// - After a cluster barrier, block r XOR-reduces its share of the group's
//   cells across the C blocks' shared memory (distributed shared memory:
//   a thread reads one sibling's unit and XORs it into its own copy by a
//   shared atomic, so a pass's reads are all in flight), and a second
//   barrier lets every block leave. A thread a cell turns the
//   cell's marker words into carries: a bit prefix XOR a word (x ^= x << 1,
//   << 2, ... << 16) and the parity of the lower words. Carry bit q is set
//   where an odd number of slots lies before word q, which flips the word
//   whole: the carry past the band is this prefix running on to the end
//   of the row.
// - The write-out folds the carries in, out = inword ^ (carry ? ~0 : 0),
//   and stores each grid word once, as uint4 where nw % 4 == 0 and the
//   output lies on 16 bytes, else as words. The in-place form of B2 XORs
//   this into the rows of the grid tile `tile_map[t]` (read and written
//   once; a cluster owns its rows), which folds the pipeline's compact
//   buffer, gather, XOR and scatter into the kernel.
//
// No device-memory atomics and no zeroed output: every word of the output
// is written by exactly one block. The cluster size C (1-16) is the
// caller's, from counts its plan makes once (the mean batches on a busy
// tile, the blocks an SM holds); it changes how the work spreads, never
// the result.
//
// tests/test_torch_fill_emulated.py runs this file on the host through
// tests/emulation.py, which runs a cluster's blocks together (a cluster
// barrier, map_shared_rank to a sibling block's buffer).
//
// Bound on this card: bytes. Each slot is read once (8 B) and each output
// word written once (in place: read and written), n^3 / 8 bytes for B1.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 128;               // a batch row's slots (TB_LANE), 32 int4
constexpr int kGroups = kThreads / 32;    // batch rows a block takes at once, a warp each
constexpr int kUnroll = 4;                // rows a thread loads before its atomics
constexpr int kMaxCluster = 16;    // H100's largest (non-portable) cluster
constexpr long long kZeroBytes = 32768;  // empty tiles a block writes, at most about
constexpr int kSmemMax = 232448;   // shared memory a block may use

struct Fill {
  const int* local;         // (B, tb) local cells
  const int* xs;            // (B, tb) x entries
  const int* batch_basew;   // (B,) band base words (B1), or null (B2)
  const int* start;         // (nbusy + 1,) each busy tile's batch range
  const int* order;         // (num_tiles,) busy tiles first
  const int* tile_map;      // (num_tiles,) output tile of a tile, or null
  unsigned* out;
  int num_batches, tb, tc, nw, mw, bwords, num_tiles, nbusy, out_tiles;
  int cells, groups, vec;  // set by launch_fill
};

// Bit i of the result: the XOR of bits 0 ... i of x.
__device__ __forceinline__ unsigned prefix_xor(unsigned x) {
  x ^= x << 1;
  x ^= x << 2;
  x ^= x << 4;
  x ^= x << 8;
  x ^= x << 16;
  return x;
}

// ~0 if x has an odd number of bits set, else 0.
__device__ __forceinline__ unsigned odd(unsigned x) { return 0u - (__popc(x) & 1u); }

__device__ __forceinline__ unsigned spread(unsigned bit) { return 0u - (bit & 1u); }

__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <int kV>
struct Unit;
template <>
struct Unit<1> {
  using T = unsigned;
  __device__ static T zero() { return 0u; }
  __device__ static T carry(unsigned bits) { return spread(bits); }
  __device__ static void xor_into(unsigned* p, T v) { atomicXor(p, v); }
};
template <>
struct Unit<4> {
  using T = uint4;
  __device__ static T zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static T carry(unsigned bits) {
    return make_uint4(spread(bits), spread(bits >> 1), spread(bits >> 2), spread(bits >> 3));
  }
  __device__ static void xor_into(unsigned* p, T v) {
    atomicXor(p, v.x);
    atomicXor(p + 1, v.y);
    atomicXor(p + 2, v.z);
    atomicXor(p + 3, v.w);
  }
};

// Rows [c_lo, c_hi) of the group: the reduced words with their carries
// folded in, XORed into the output where in place.
template <int kV>
__device__ __forceinline__ void write_rows(const Fill& f, const unsigned* inword,
                                           const unsigned* carry, unsigned* rows, int c_lo,
                                           int c_hi) {
  using U = Unit<kV>;
  using T = typename U::T;
  const int units = f.nw / kV;
  const int total = (c_hi - c_lo) * units;
  T* dst = reinterpret_cast<T*>(rows + (long long)c_lo * f.nw);
  for (int u = threadIdx.x; u < total; u += kThreads) {
    const int c = c_lo + u / units;
    const int q = (u % units) * kV;  // the unit's first word in its row
    T v = *reinterpret_cast<const T*>(inword + c * f.nw + q) ^
          U::carry(carry[c * f.mw + (q >> 5)] >> (q & 31));
    if (f.tile_map) v = v ^ dst[u];
    dst[u] = v;
  }
}

// XOR of the C blocks' words [lo, lo + count) of `own`, into `own`: a
// thread a (rank, unit of kV words), rank-major, so that a warp reads one
// sibling's consecutive units from its distributed shared memory and
// every read of the pass is in flight together, then XORs what it read
// into this block's copy by shared atomics (distinct words in a warp).
template <int kV>
__device__ __forceinline__ void reduce_words(cg::cluster_group& cluster, unsigned* own,
                                             int lo, int count, int csize, int rank) {
  using T = typename Unit<kV>::T;
  const int units = count / kV;
  for (int i = threadIdx.x; i < units * csize; i += kThreads) {
    const int q = i / units, at = lo + (i - q * units) * kV;
    if (q == rank) continue;  // this block's own copy holds its part
    const T v = *reinterpret_cast<const T*>(cluster.map_shared_rank(own, q) + at);
    Unit<kV>::xor_into(own + at, v);
  }
}

// This block's share of the empty tiles, order[nbusy + e] for e in
// [blockIdx.x * E / blocks, (blockIdx.x + 1) * E / blocks), whole: a
// thread looks up the tiles of kUnroll units before it stores them.
template <int kV>
__device__ __forceinline__ void write_zero_tiles(const Fill& f) {
  using T = typename Unit<kV>::T;
  const long long empty = f.num_tiles - f.nbusy, blocks = gridDim.x;
  const long long first = f.nbusy + blockIdx.x * empty / blocks;
  const int tiles = (int)(f.nbusy + (blockIdx.x + 1) * empty / blocks - first);
  const int units = f.tc * f.nw / kV;  // a tile's rows are consecutive
  const int total = tiles * units;
  for (int u0 = threadIdx.x; u0 < total; u0 += kThreads * kUnroll) {
    int tile[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + k * kThreads;
      tile[k] = u < total ? f.order[first + u / units] : 0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + k * kThreads;
      if (u < total)
        reinterpret_cast<T*>(f.out + (long long)tile[k] * f.tc * f.nw)[u % units] =
            Unit<kV>::zero();
    }
  }
}

__global__ void __launch_bounds__(kThreads) suffix_fill_kernel(const Fill f) {
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  if (!f.tile_map && f.nbusy < f.num_tiles) {  // every block writes a share of the zeros
    if (f.vec) {
      write_zero_tiles<4>(f);
    } else {
      write_zero_tiles<1>(f);
    }
  }
  const long long item = blockIdx.x / csize;  // (busy tile, cell group)
  if (item >= (long long)f.nbusy * f.groups) return;  // a cluster of zero writers only
  const int busy = (int)(item / f.groups);
  const int tile = f.order[busy];
  const int c0 = (int)(item % f.groups) * f.cells;
  const int cn = min(f.cells, f.tc - c0);
  const int per = (cn + csize - 1) / csize;  // this block's cells [lo, hi) of the group
  const int lo = min(rank * per, cn), hi = min(lo + per, cn);

  const int b0 = max(f.start[busy], 0);
  const int b1 = min(f.start[busy + 1], f.num_batches);
  const int real = f.tile_map ? f.tile_map[tile] : tile;
  unsigned* rows = f.out + ((long long)real * f.tc + c0) * f.nw;
  // Uniform across the cluster: no block reaches a barrier the others skip.
  if (real < 0 || real >= f.out_tiles) return;

  unsigned* inword = reinterpret_cast<unsigned*>(smem);  // [cn][nw]
  unsigned* marks = inword + cn * f.nw;                   // [cn][mw]: a bit a word
  const int words = cn * (f.nw + f.mw);
  for (int i = threadIdx.x; i < (words + 3) / 4; i += kThreads)
    smem[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // This block's batches b0 + rank + m * csize, as rows of 128 slots: a
  // warp takes a row, a lane its 4 slots as one int4 of cells and one of
  // x; a thread has kUnroll rows' loads in flight before their atomics.
  const int span = f.bwords * 32;
  const int share = (b1 - b0 > rank) ? (b1 - b0 - rank + csize - 1) / csize : 0;
  const int tsub = f.tb / kLanes;  // rows a batch
  const int nrows = share * tsub;
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  for (int r0 = grp; r0 < nrows; r0 += kGroups * kUnroll) {
    int4 cv[kUnroll], xv[kUnroll];
    int lo_x[kUnroll];  // the row's band start, or INT_MAX: a batch to skip
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int r = r0 + k * kGroups;
      lo_x[k] = 0x7FFFFFFF;
      if (r < nrows) {
        const int m = r / tsub;
        const long long b = b0 + rank + (long long)m * csize;
        const long long row = (b * tsub + (r - m * tsub)) * kLanes;
        const int bw = f.batch_basew ? f.batch_basew[b] : 0;
        cv[k] = reinterpret_cast<const int4*>(f.local + row)[lane];
        xv[k] = reinterpret_cast<const int4*>(f.xs + row)[lane];
        if (bw >= 0 && bw <= f.nw - f.bwords) lo_x[k] = bw * 32;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (lo_x[k] == 0x7FFFFFFF) continue;
      const int cs[4] = {cv[k].x, cv[k].y, cv[k].z, cv[k].w};
      const int xs4[4] = {xv[k].x, xv[k].y, xv[k].z, xv[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cs[j] - c0, x = xs4[j];
        if (c < 0 || c >= cn || x < lo_x[k] || x >= lo_x[k] + span) continue;  // inert
        const int w = x >> 5;
        atomicXor(&inword[c * f.nw + w], 0xFFFFFFFFu << (x & 31));
        if (w + 1 < f.nw) atomicXor(&marks[c * f.mw + ((w + 1) >> 5)], 1u << ((w + 1) & 31));
      }
    }
  }
  cluster.sync();  // every block's rows are complete

  if (csize > 1) {
    if (f.vec) {
      reduce_words<4>(cluster, inword, lo * f.nw, (hi - lo) * f.nw, csize, rank);
    } else {
      reduce_words<1>(cluster, inword, lo * f.nw, (hi - lo) * f.nw, csize, rank);
    }
    reduce_words<1>(cluster, marks, lo * f.mw, (hi - lo) * f.mw, csize, rank);
    cluster.sync();  // every block's cells are whole, and no block reads a sibling's after this
  }

  for (int c = lo + threadIdx.x; c < hi; c += kThreads) {
    unsigned below = 0u;
    for (int j = 0; j < f.mw; ++j) {
      const unsigned m = marks[c * f.mw + j];
      marks[c * f.mw + j] = prefix_xor(m) ^ below;
      below ^= odd(m);
    }
  }
  __syncthreads();

  if (f.vec) {
    write_rows<4>(f, inword, marks, rows, lo, hi);
  } else {
    write_rows<1>(f, inword, marks, rows, lo, hi);
  }
}

int launch_fill(Fill f, int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || f.tc < 1 || f.nw < 1 || f.tb < kLanes ||
      f.tb % kLanes || f.num_tiles < 0)
    return (int)cudaErrorInvalidValue;
  if (f.num_tiles == 0) return (int)cudaSuccess;
  f.mw = (f.nw + 31) / 32;
  // The most cells whose rows (words and marker words, in 16-byte units)
  // fit one block, then that many groups of near-equal size.
  const long long row = f.nw + f.mw;
  int cells = f.tc;
  while (cells > 1 && (cells * row + 3) / 4 * 16 > kSmemMax) cells = (cells + 1) / 2;
  if ((cells * row + 3) / 4 * 16 > kSmemMax) return (int)cudaErrorInvalidValue;
  f.groups = (f.tc + cells - 1) / cells;
  f.cells = (f.tc + f.groups - 1) / f.groups;
  f.vec = f.nw % 4 == 0 && reinterpret_cast<unsigned long long>(f.out) % 16 == 0;
  if (f.nbusy < 0 || f.nbusy > f.num_tiles || !f.order || !f.start)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<unsigned long long>(f.local) % 16 ||
      reinterpret_cast<unsigned long long>(f.xs) % 16)
    return (int)cudaErrorInvalidValue;  // slots are read as int4
  // A cluster a busy (tile, cell group); every block also writes a share of
  // the empty tiles (none in place), with clusters of zero writers added
  // where the busy ones would take more than kZeroBytes of zeros a block.
  const long long empty = f.tile_map ? 0 : f.num_tiles - f.nbusy;
  const long long per_block = std::max(1LL, kZeroBytes / ((long long)f.tc * f.nw * 4));
  const long long zero_clusters = (empty + per_block * cluster - 1) / (per_block * cluster);
  const long long blocks = std::max((long long)f.nbusy * f.groups, zero_clusters) * cluster;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const int smem = (int)((f.cells * row + 3) / 4 * 16);
  // The attributes apply to the current device: set them on every launch
  // that needs them.
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        suffix_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        suffix_fill_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, suffix_fill_kernel, f);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// B1: banded batches into the full grid. out: (num_tiles * tc, nw) words
// (num_tiles = n * n / tc), every one written. order: the plan's tiles,
// its nbusy busy ones first.
extern "C" int vt_banded_fill(const void* local, const void* xs, const void* batch_basew,
                              const void* start, const void* order,
                              int num_batches, int tb, int tc, int nw, int bwords,
                              int num_tiles, int nbusy, int cluster, void* out, void* stream) {
  Fill f = {};
  f.local = (const int*)local;
  f.xs = (const int*)xs;
  f.batch_basew = (const int*)batch_basew;
  f.start = (const int*)start;
  f.order = (const int*)order;
  f.nbusy = nbusy;
  f.out = (unsigned*)out;
  f.num_batches = num_batches;
  f.tb = tb;
  f.tc = tc;
  f.nw = nw;
  f.bwords = bwords;
  f.num_tiles = num_tiles;
  f.out_tiles = num_tiles;
  if (bwords < 1 || bwords > nw) return (int)cudaErrorInvalidValue;
  return launch_fill(f, cluster, stream);
}

// B2: whole-axis batches of num_tiles (compact) tiles. Without a tile map,
// into a (num_tiles, tc, nw) buffer, every word written; with one, XORed
// into the rows of grid tile tile_map[t] of out (out_tiles tiles; the map's
// entries distinct), whose other tiles are left as they are.
extern "C" int vt_wide_fill(const void* local, const void* xs, const void* start,
                            const void* order, const void* tile_map,
                            int num_batches, int tb, int tc, int nw, int num_tiles,
                            int nbusy, int out_tiles, int cluster, void* out,
                            void* stream) {
  Fill f = {};
  f.local = (const int*)local;
  f.xs = (const int*)xs;
  f.start = (const int*)start;
  f.order = (const int*)order;
  f.nbusy = nbusy;
  f.tile_map = (const int*)tile_map;
  f.out = (unsigned*)out;
  f.num_batches = num_batches;
  f.tb = tb;
  f.tc = tc;
  f.nw = nw;
  f.bwords = nw;
  f.num_tiles = num_tiles;
  f.out_tiles = tile_map ? out_tiles : num_tiles;
  return launch_fill(f, cluster, stream);
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
