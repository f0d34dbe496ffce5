// Work-queue fill kernel of the solid voxelizer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   B14  voxtpu/ops/vox_pallas_wq.py::_wq_kernel  (vt_wq_fill)
//
// The plan (`ops/vox_work_queue.py::WorkQueueVoxPlan`) lays each active
// YZ tile's fragments out as one run of (rows, 128) lanes: local cell c
// of the tile (-1 for a pad lane) and entry x. Word q of cell c is the
// parity of the fragments at x' <= 32q + b for each bit b, i.e. the XOR
// of the fragments' suffix masks: 0xFFFFFFFF << (x & 31) at word x >> 5
// and all ones in every later word.
//
// The TPU kernel walks the run in double-buffered DMA chunks, counts
// the fill per column in an int32 (tc, n) VMEM accumulator with one-hot
// int8 matmuls per X segment present, and packs the count parities into
// words with two bf16 matmuls. Here the fill is XOR-linear, so:
//
// - One block per YZ tile of the grid. It finds its run by binary search
//   over the ascending tile ids; a tile without a run, or outside the
//   tile mask, writes zeros (so the output needs no clearing).
// - The block's threads stride over the run's lanes (the TPU's chunks,
//   coalesced), skip pad lanes, XOR each fragment's in-word mask into its
//   (c, x >> 5) word and toggle a carry marker at word (x >> 5) + 1, both
//   with shared-memory atomicXor, in two (tc, n/32 + 1) arrays.
// - One thread per cell then runs the markers into a prefix XOR along
//   its words and XORs in the masks (B12's walk); the odd row stride
//   keeps it free of bank conflicts.
// - The tile's tc x n/32 words are one contiguous output range, written
//   once each with coalesced stores.
//
// Exact for any fragments: XOR, not counts, so `seg` (the TPU's X
// segments) does not enter. Bound on this card: bytes, each lane read
// once (8 B) and each grid word written once (n^3 / 8 bytes). Shared
// memory is 2 x tc x (n/32 + 1) x 4 B: 17 KB at 512^3, 66.5 KB at 2048^3
// (opt-in above 48 KB).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLane = 128;      // lanes a row
constexpr int kChunkRows = 8;   // rows a chunk (voxtpu's CH_SUB)

__device__ int lower_bound(const int* __restrict__ a, int len, int value) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void wq_fill_kernel(const int* __restrict__ cells2d,
                               const int* __restrict__ xs2d,
                               const int* __restrict__ row_start,
                               const int* __restrict__ num_chunks,
                               const int* __restrict__ tile_id,
                               const unsigned char* __restrict__ tile_mask,
                               int num_active, int num_rows, int n, int tc,
                               unsigned int* __restrict__ out) {
  extern __shared__ unsigned int smem[];
  const int nw = n >> 5;
  const int stride = nw + 1;
  unsigned int* inword = smem;              // [tc][stride]
  unsigned int* flip = smem + tc * stride;  // [tc][stride]
  __shared__ int found;
  const int t = blockIdx.x;
  unsigned int* dst = out + (long long)t * tc * nw;

  if (threadIdx.x == 0) {
    const int a = lower_bound(tile_id, num_active, t);
    found = a < num_active && tile_id[a] == t && tile_mask[t] ? a : -1;
  }
  __syncthreads();
  if (found < 0) {
    for (int i = threadIdx.x; i < tc * nw; i += blockDim.x) dst[i] = 0u;
    return;
  }
  for (int i = threadIdx.x; i < 2 * tc * stride; i += blockDim.x) smem[i] = 0u;
  __syncthreads();

  const long long e0 = (long long)row_start[found] * kLane;
  const long long e1 =
      min(e0 + (long long)num_chunks[found] * kChunkRows * kLane,
          (long long)num_rows * kLane);
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const int c = cells2d[e];
    const int x = xs2d[e];
    if (c < 0 || c >= tc || x < 0 || x >= n) continue;  // pad lane
    const int w = x >> 5;
    atomicXor(&inword[c * stride + w], 0xFFFFFFFFu << (x & 31));
    atomicXor(&flip[c * stride + w + 1], 1u);  // w + 1 <= nw < stride
  }
  __syncthreads();

  for (int c = threadIdx.x; c < tc; c += blockDim.x) {
    unsigned int carry = 0u;
    for (int q = 0; q < nw; ++q) {
      carry ^= flip[c * stride + q];
      flip[c * stride + q] = inword[c * stride + q] ^ (0u - carry);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tc * nw; i += blockDim.x) {
    dst[i] = flip[(i / nw) * stride + i % nw];
  }
}

}  // namespace

// B14: out (n, n, nw) words, num_tiles * tc * nw of them; written whole.
extern "C" int vt_wq_fill(const void* cells2d, const void* xs2d,
                          const void* row_start, const void* num_chunks,
                          const void* tile_id, const void* tile_mask,
                          int num_active, int num_rows, int n, int tc,
                          int num_tiles, void* out, void* stream) {
  const size_t smem = 2 * (size_t)tc * ((n >> 5) + 1) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wq_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wq_fill_kernel<<<num_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)cells2d, (const int*)xs2d, (const int*)row_start,
      (const int*)num_chunks, (const int*)tile_id,
      (const unsigned char*)tile_mask, num_active, num_rows, n, tc,
      (unsigned int*)out);
  return (int)cudaGetLastError();
}
