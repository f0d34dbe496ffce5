// Word-event fill kernel of the solid voxelizer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   B12  voxtpu/ops/vox_pallas_we.py::_we_kernel  (vt_word_event_fill)
//
// A word event is one touched (cell, word) of the grid: local cell c of
// its supertile (-1 inert), packed lane w = g*nw + w' (sub-tile g, word
// w'), lane bound hi = (g+1)*nw, the XOR of its fragments' in-word
// suffix masks, and the parity of its fragment count. The supertile's
// (tc, kLanes) panel word at lane q of cell c is
//
//   XOR over its events at c of (mask if q == w)
//                            ^ (~0 if the count is odd and w < q < hi).
//
// The TPU kernel builds this from five int8 one-hot matmuls per batch
// (the carry count and four mask bytes, exact only because events are
// unique per (cell, word)) and accumulates a supertile's batches in VMEM
// between FIRST and LAST flags of its sequential grid. The function is
// XOR-linear in the events, so here one block takes one supertile:
//
// - It finds its batches by binary search over the non-decreasing
//   batch_tile (the plans' order; a batch outside [0, num_super) is
//   never found, so it is skipped) and zeroes, with 16-byte stores, the
//   (tc, kLanes) word array `inword` and the (tc, 4) words `carry`: one
//   marker bit a lane.
// - A thread an event XORs the mask into its (c, w) word and, for an odd
//   count, toggles the marker bits of lanes w + 1 and hi, each with a
//   shared atomicXor of one bit; a marker at hi = kLanes lies past every
//   lane and is dropped. Duplicate events compose by XOR.
// - A thread a cell turns its four marker words into carries: each word
//   takes a bit prefix XOR (x ^= x << 1, << 2, ... << 16), then the
//   parity of the cell's lower words (__popc & 1) as 0 or ~0. Bit q is
//   then the XOR of the markers at lanes <= q: set where an odd number
//   of odd events has w < q < hi.
// - The write-out folds the carries in: grid word (sub, c, w') is
//   inword[c][q] ^ (carry bit q ? ~0 : 0) at lane q = sub*nw + w'. Sub-
//   tile sub's cells are the consecutive run (s*G + sub)*tc + c, so the
//   panel's G*tc*nw words are one contiguous output range (voxtpu's
//   lane-panel unpack, `_we_words`), written once each, as uint4 where
//   nw % 4 == 0 (n = 128, 512, 1024, ...) and as words otherwise (n = 64,
//   96); a thread's (sub, c, w') steps with its index, no division a
//   word. Every output word is written, so the output needs no zeroing.
//
// tests/test_torch_we_emulated.py runs this file on the host through
// tests/emulation.py (the cuda_runtime.h include, the `extern __shared__`
// array and the `<<<...>>>` launch are rewritten). So the block's batch
// range lives in the dynamic array too: the rewrite would make a static
// __shared__ variable a thread's own.
//
// Bound on this card: bytes. Each event is read once (five int32, 20 B)
// and each output word written once (n^3 / 8 bytes): 0.0052 ms at 512^3
// on the washers of chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// Shared memory is tc x (kLanes + 4) x 4 B + 16, 66 KB at tc = 128, so three
// 512-thread blocks fit an SM (at most 40 registers a thread, by the
// launch bounds): the 256 supertiles of 512^3 run in one wave on the
// 132 SMs (396 slots); 1024^3's 2048 take six.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 128;  // a supertile panel's lanes (wpad)
constexpr int kCarryWords = kLanes / 32;
static_assert(kCarryWords == 4, "a cell's carries are one uint4");

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

__device__ __forceinline__ void toggle(unsigned* bits, int lane) {
  atomicXor(&bits[lane >> 5], 1u << (lane & 31));
}

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

// The panel's g*tc rows (sub, c) of nw words into dst, kV words a unit:
// unit u = (sub*tc + c) * (nw / kV) + wu, a thread's units kThreads apart,
// (sub, c, wu) stepped with their carries.
template <int kV>
__device__ __forceinline__ void write_panel(const unsigned* inword, const unsigned* carry,
                                            int tc, int nw, int g, unsigned* dst) {
  const int units = nw / kV, total = g * tc * units;
  int u = threadIdx.x;
  int wu = u % units, c = (u / units) % tc, sub = u / units / tc;
  const int dwu = kThreads % units, dc = kThreads / units % tc, dsub = kThreads / units / tc;
  for (; u < total; u += kThreads) {
    const int q = sub * nw + wu * kV;  // lane of the unit's first word
    const unsigned bits = carry[c * kCarryWords + (q >> 5)] >> (q & 31);
    const unsigned* in = inword + c * kLanes + q;
    if constexpr (kV == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(in);
      reinterpret_cast<uint4*>(dst)[u] =
          make_uint4(v.x ^ spread(bits), v.y ^ spread(bits >> 1), v.z ^ spread(bits >> 2),
                     v.w ^ spread(bits >> 3));
    } else {
      dst[u] = *in ^ spread(bits);
    }
    wu += dwu;
    c += dc;
    sub += dsub;
    if (wu >= units) {
      wu -= units;
      ++c;
    }
    if (c >= tc) {
      c -= tc;
      ++sub;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3) word_event_fill_kernel(
    const int* __restrict__ cells, const int* __restrict__ ws,
    const int* __restrict__ his, const int* __restrict__ masks,
    const int* __restrict__ cnts, const int* __restrict__ batch_tile,
    int num_batches, int tb, int tc, int nw, int g, unsigned* __restrict__ out) {
  extern __shared__ uint4 smem[];
  unsigned* inword = reinterpret_cast<unsigned*>(smem);  // [tc][kLanes]
  uint4* carry4 = smem + tc * (kLanes / 4);                // [tc]: 4 words a cell
  unsigned* carry = reinterpret_cast<unsigned*>(carry4);
  int* range = reinterpret_cast<int*>(carry4 + tc);       // the block's batches
  const int s = blockIdx.x;

  if (threadIdx.x == 0) range[0] = lower_bound(batch_tile, num_batches, s);
  if (threadIdx.x == 32) range[1] = lower_bound(batch_tile, num_batches, s + 1);
  for (int i = threadIdx.x; i < tc * (kLanes / 4 + 1); i += kThreads)
    smem[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const long long e_end = (long long)range[1] * tb;
  for (long long e = (long long)range[0] * tb + threadIdx.x; e < e_end; e += kThreads) {
    const int c = cells[e];
    const int w = ws[e];
    if (c < 0 || c >= tc || w < 0 || w >= kLanes) continue;  // inert event
    const unsigned int m = (unsigned int)masks[e];
    if (m) atomicXor(&inword[c * kLanes + w], m);
    if (cnts[e] & 1) {
      const int hi = min(his[e], kLanes);
      if (w + 1 < hi) {
        toggle(carry + c * kCarryWords, w + 1);
        if (hi < kLanes) toggle(carry + c * kCarryWords, hi);
      }
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < tc; c += kThreads) {
    const uint4 m = carry4[c];
    const unsigned below1 = odd(m.x), below2 = below1 ^ odd(m.y), below3 = below2 ^ odd(m.z);
    carry4[c] = make_uint4(prefix_xor(m.x), prefix_xor(m.y) ^ below1,
                           prefix_xor(m.z) ^ below2, prefix_xor(m.w) ^ below3);
  }
  __syncthreads();

  // Panel word (c, sub*nw + w) -> grid word ((s*g + sub)*tc + c)*nw + w.
  unsigned* dst = out + (long long)s * g * tc * nw;
  if (nw % 4 == 0) {
    write_panel<4>(inword, carry, tc, nw, g, dst);
  } else {
    write_panel<1>(inword, carry, tc, nw, g, dst);
  }
}

}  // namespace

// B12: out (n, n, nw) words, num_super * g * tc * nw of them; written
// whole (no zeroing needed). wpad must be kLanes (every plan's).
extern "C" int vt_word_event_fill(const void* cells, const void* ws,
                                  const void* his, const void* masks,
                                  const void* cnts, const void* batch_tile,
                                  int num_batches, int tb, int tc, int nw,
                                  int g, int num_super, int wpad, void* out,
                                  void* stream) {
  if (wpad != kLanes) return (int)cudaErrorInvalidValue;
  const int smem = (tc * (kLanes + kCarryWords) + 4) * (int)sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        word_event_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)  // shared memory first: three blocks an SM
      e = cudaFuncSetAttribute(word_event_fill_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  word_event_fill_kernel<<<num_super, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)cells, (const int*)ws, (const int*)his, (const int*)masks,
      (const int*)cnts, (const int*)batch_tile, num_batches, tb, tc, nw, g,
      (unsigned*)out);
  return (int)cudaGetLastError();
}
