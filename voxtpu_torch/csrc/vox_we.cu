// Word-event fill kernel of the solid voxelizer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   B12  voxtpu/ops/vox_pallas_we.py::_we_kernel  (vt_word_event_fill)
//
// A word event is one touched (cell, word) of the grid: local cell c of
// its supertile (-1 inert), packed lane w = g*nw + w' (sub-tile g, word
// w'), lane bound hi = (g+1)*nw, the XOR of its fragments' in-word
// suffix masks, and the parity of its fragment count. The supertile's
// (tc, wpad) panel word at lane q of cell c is
//
//   XOR over its events at c of (mask if q == w)
//                            ^ (~0 if the count is odd and w < q < hi).
//
// The TPU kernel builds this from five int8 one-hot matmuls per batch
// (the carry count and four mask bytes, exact only because events are
// unique per (cell, word)) and accumulates a supertile's batches in VMEM
// between FIRST and LAST flags of its sequential grid. The function is
// XOR-linear in the events, so here:
//
// - One block per supertile. It finds its batches by binary search over
//   the non-decreasing batch_tile (the plans' order; a batch outside
//   [0, num_super) is never found, so it is skipped), zeroes two
//   (tc, wpad + 1) word arrays in shared memory, and one thread per
//   event XORs the mask into its (c, w) word and, for an odd count,
//   toggles a carry marker at lane w + 1 and again at lane hi, both
//   with shared-memory atomicXor. Duplicate events compose by XOR.
// - One thread per cell then runs the markers into a prefix XOR along
//   its lanes (every lane in [w + 1, hi) is flipped once per odd event)
//   and XORs in the masks. The row stride wpad + 1 keeps that walk free
//   of bank conflicts.
// - The block writes its G sub-tiles' words straight into the
//   (n, n, n/32) grid: sub-tile g's cells are the consecutive run
//   (s*G + g)*tc + c, so the panel's G*tc*nw words are one contiguous
//   output range, written once each with coalesced stores (voxtpu's
//   lane-panel unpack, `_we_words`). Every output word is written, so
//   the output needs no zeroing.
//
// Bound on this card: bytes. Each event is read once (five int32, 20 B)
// and each output word written once (n^3 / 8 bytes): about 0.01 ms at
// 512^3. Shared memory is 2 x tc x (wpad + 1) x 4 B (132 KB at tc = 128,
// wpad = 128), so one block fits an SM, and the per-cell lane walk runs
// on tc threads of the block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

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

__global__ void word_event_fill_kernel(
    const int* __restrict__ cells, const int* __restrict__ ws,
    const int* __restrict__ his, const int* __restrict__ masks,
    const int* __restrict__ cnts, const int* __restrict__ batch_tile,
    int num_batches, int tb, int tc, int nw, int g, int wpad,
    unsigned int* __restrict__ out) {
  extern __shared__ unsigned int smem[];
  const int stride = wpad + 1;
  unsigned int* inword = smem;              // [tc][stride]
  unsigned int* flip = smem + tc * stride;  // [tc][stride]
  __shared__ int range[2];
  const int s = blockIdx.x;

  if (threadIdx.x == 0) range[0] = lower_bound(batch_tile, num_batches, s);
  if (threadIdx.x == 32) range[1] = lower_bound(batch_tile, num_batches, s + 1);
  for (int i = threadIdx.x; i < 2 * tc * stride; i += blockDim.x) smem[i] = 0u;
  __syncthreads();

  const long long e_end = (long long)range[1] * tb;
  for (long long e = (long long)range[0] * tb + threadIdx.x; e < e_end;
       e += blockDim.x) {
    const int c = cells[e];
    const int w = ws[e];
    if (c < 0 || c >= tc || w < 0 || w >= wpad) continue;  // inert event
    const unsigned int m = (unsigned int)masks[e];
    if (m) atomicXor(&inword[c * stride + w], m);
    if (cnts[e] & 1) {
      const int hi = min(his[e], wpad);
      if (w + 1 < hi) {
        atomicXor(&flip[c * stride + w + 1], 1u);
        atomicXor(&flip[c * stride + hi], 1u);  // hi <= wpad < stride
      }
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < tc; c += blockDim.x) {
    unsigned int run = 0u;
    for (int q = 0; q < wpad; ++q) {
      run ^= flip[c * stride + q];
      flip[c * stride + q] = inword[c * stride + q] ^ (0u - run);
    }
  }
  __syncthreads();

  // Panel word (c, sub*nw + w) -> grid word ((s*g + sub)*tc + c)*nw + w,
  // i.e. out[s*g*tc*nw + i] for i = (sub*tc + c)*nw + w.
  unsigned int* dst = out + (long long)s * g * tc * nw;
  for (int i = threadIdx.x; i < g * tc * nw; i += blockDim.x) {
    const int w = i % nw;
    const int c = (i / nw) % tc;
    const int sub = i / (nw * tc);
    dst[i] = flip[c * stride + sub * nw + w];
  }
}

}  // namespace

// B12: out (n, n, nw) words, num_super * g * tc * nw of them; written
// whole (no zeroing needed).
extern "C" int vt_word_event_fill(const void* cells, const void* ws,
                                  const void* his, const void* masks,
                                  const void* cnts, const void* batch_tile,
                                  int num_batches, int tb, int tc, int nw,
                                  int g, int num_super, int wpad, void* out,
                                  void* stream) {
  const size_t smem = 2 * (size_t)tc * (wpad + 1) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        word_event_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  word_event_fill_kernel<<<num_super, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)cells, (const int*)ws, (const int*)his, (const int*)masks,
      (const int*)cnts, (const int*)batch_tile, num_batches, tb, tc, nw, g,
      wpad, (unsigned int*)out);
  return (int)cudaGetLastError();
}
