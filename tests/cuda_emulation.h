// A host emulation of the CUDA features that the csrc sources run on
// the host use (csrc/jfa.cu, jfa_probe.cu, soft_vox.cu, soft_vox_seg.cu,
// vox_we.cu, vox_fill.cu, vox_plan.cu, soft_plan.cu), for the
// tests/test_torch_*_emulated.py tests.
//
// A launch runs its clusters one after another (a launch without a
// cluster size: its blocks, as clusters of one); a cluster's blocks run
// together, each with its own shared-memory buffer, and every thread of
// the cluster is a fiber (its own stack, switched with swapcontext) on
// the calling OS thread. A fiber runs until it waits at a barrier, then
// hands the thread to the next fiber in turn, so __syncthreads,
// __syncthreads_or and __any_sync are barriers among a block's fibers,
// cluster.sync() a barrier among the cluster's, map_shared_rank the same
// offset in a sibling's buffer, and __syncwarp, the shuffles and
// __ballot_sync barriers among a warp's. One OS thread a launch keeps a
// test's cost the same whatever else loads the machine's cores. A
// barrier that can never complete (a kernel whose threads diverge around
// one) aborts with a message instead of hanging. Atomics are std::atomic_ref operations.
// cp.async copies are queued by the copying thread and land when a wait
// requires their group (the latest a card may land them). Float
// operations round to nearest on their own, as __fadd_rn and friends do
// on the card (build with -ffp-contract=off).
#pragma once

#include <algorithm>
#include <sys/mman.h>
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11,
  cudaSharedmemCarveoutMaxShared = 100
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
using std::fmaxf;
using std::fminf;
using std::isfinite;

inline dim3 blockDim, gridDim;

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline long long __float2ll_rn(float f) { return std::llrintf(f); }  // nearest, ties to even
inline float __ll2float_rn(long long v) { return (float)v; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// Streaming loads and stores: plain ones on the host, which also
// report an address the card would fault on (not a multiple of the
// access's size) as cudaErrorMisalignedAddress from the launch.
inline std::atomic<int> emu_error{0};
template <typename T>
inline void emu_check_aligned(const T* p) {
  if (reinterpret_cast<std::uintptr_t>(p) % sizeof(T)) emu_error = 716;
}
template <typename T>
inline T __ldcs(const T* p) {
  emu_check_aligned(p);
  return *p;
}
template <typename T>
inline void __stcs(T* p, T v) {
  emu_check_aligned(p);
  *p = v;
}

template <typename T>
inline T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}
inline unsigned atomicXor(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_xor(v);
}
inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int cur = a.load();
  while (v < cur && !a.compare_exchange_weak(cur, v)) {
  }
  return cur;
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int cur = a.load();
  while (v > cur && !a.compare_exchange_weak(cur, v)) {
  }
  return cur;
}

struct EmuFiber;
inline thread_local EmuFiber* emu_cur = nullptr;  // the running fiber
inline thread_local std::uint64_t emu_idle = 0;   // hand-overs since a barrier moved
inline thread_local std::uint64_t emu_live = 0;   // the launch's unfinished fibers

// Hand the OS thread to the next fiber that has not finished.
inline void emu_yield();

// A barrier of n fibers (std::barrier's arrive_and_wait, for fibers).
struct EmuBarrier {
  int n, count = 0;
  unsigned gen = 0;
  explicit EmuBarrier(int n_) : n(n_) {}
  void arrive_and_wait() {
    emu_idle = 0;
    const unsigned g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      return;
    }
    while (gen == g) emu_yield();
  }
};

struct EmuBlock {
  std::unique_ptr<EmuBarrier> bar;
  std::vector<std::unique_ptr<EmuBarrier>> warp_bar;
  std::atomic<int> acc[3];
  std::atomic<int> warp_acc[32][3];
  std::uint64_t warp_x[32][32];  // a shuffle's values, a warp's lanes
};
struct EmuCluster {
  std::unique_ptr<EmuBarrier> bar;
  int size;
};

constexpr int kEmuMaxCluster = 16;
constexpr size_t kEmuSmem = 232448;  // a block's most on the card
alignas(16) inline unsigned char emu_smem_pool[kEmuMaxCluster][kEmuSmem];

// What a CUDA thread keeps for itself: its indices, its block and
// cluster, its vote counters and its cp.async groups.
struct EmuFiber {
  ucontext_t ctx;
  dim3 thread_idx, block_idx;
  EmuBlock* block = nullptr;
  EmuCluster* cluster = nullptr;
  int rank = 0;
  unsigned char* smem = nullptr;  // this block's buffer
  int or_calls = 0, vote_calls = 0;
  std::vector<std::vector<std::pair<int*, int>>> groups;
  std::vector<std::pair<int*, int>> open;
  std::function<void()> body;
  EmuFiber *next = nullptr, *prev = nullptr;  // the ring of unfinished fibers
  bool done = false;
};
#define threadIdx (emu_cur->thread_idx)
#define blockIdx (emu_cur->block_idx)
#define emu_block (emu_cur->block)
#define emu_cluster (emu_cur->cluster)
#define emu_rank (emu_cur->rank)
#define emu_smem (emu_cur->smem)
#define emu_or_calls (emu_cur->or_calls)
#define emu_vote_calls (emu_cur->vote_calls)
#define emu_groups (emu_cur->groups)
#define emu_open (emu_cur->open)

inline void emu_yield() {
  EmuFiber* from = emu_cur;
  EmuFiber* to = from->next;
  if (++emu_idle > 2 * emu_live) {
    std::fprintf(stderr, "cuda_emulation: every thread waits at a barrier that cannot "
                         "complete (deadlock)\n");
    std::abort();
  }
  if (to == from) return;
  emu_cur = to;
  swapcontext(&from->ctx, &to->ctx);
}

inline int emu_tid() {
  return threadIdx.x + threadIdx.y * blockDim.x + threadIdx.z * blockDim.x * blockDim.y;
}

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }

// Three accumulators in turn: call c clears the one call c + 1 uses,
// which no thread reads any more (all have passed call c - 1's barrier).
inline int __syncthreads_or(int p) {
  const int c = emu_or_calls++;
  if (emu_tid() == 0) emu_block->acc[(c + 1) % 3] = 0;
  if (p) emu_block->acc[c % 3] |= 1;
  emu_block->bar->arrive_and_wait();
  return emu_block->acc[c % 3].load();
}

inline int __any_sync(unsigned, int p) {
  const int w = emu_tid() / 32, c = emu_vote_calls++;
  if (emu_tid() % 32 == 0) emu_block->warp_acc[w][(c + 1) % 3] = 0;
  if (p) emu_block->warp_acc[w][c % 3] |= 1;
  emu_block->warp_bar[w]->arrive_and_wait();
  return emu_block->warp_acc[w][c % 3].load();
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warp_bar[emu_tid() / 32]->arrive_and_wait();
}

// A bit a lane: bit l set where lane l's predicate holds (all must call).
inline unsigned __ballot_sync(unsigned, int p) {
  const int w = emu_tid() / 32;
  const int nt = blockDim.x * blockDim.y * blockDim.z;
  emu_block->warp_x[w][emu_tid() % 32] = p ? 1 : 0;
  __syncwarp();
  unsigned m = 0;
  for (int l = 0; l < std::min(32, nt - 32 * w); ++l)
    if (emu_block->warp_x[w][l]) m |= 1u << l;
  __syncwarp();
  return m;
}

// Lane `src`'s value of v, for every lane of the warp (all must call).
template <typename T>
inline T emu_shfl(T v, int src) {
  static_assert(sizeof(T) <= sizeof(std::uint64_t));
  const int w = emu_tid() / 32;
  std::memcpy(&emu_block->warp_x[w][emu_tid() % 32], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, &emu_block->warp_x[w][src], sizeof(T));
  __syncwarp();
  return r;
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) { return emu_shfl(v, src); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) { return emu_shfl(v, (emu_tid() % 32) ^ mask); }
template <typename T>
inline T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = emu_tid() % 32;
  return emu_shfl(v, lane >= d ? lane - d : lane);
}

inline void emu_copy(int* dst, const int* src) { emu_open.push_back({dst, *src}); }
inline void emu_commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
inline void emu_wait(int pending) {
  while ((int)emu_groups.size() > pending) {
    for (auto& [dst, v] : emu_groups.front()) *dst = v;
    emu_groups.erase(emu_groups.begin());
  }
}

inline int cudaGetLastError() { return emu_error.exchange(0); }
inline const char* cudaGetErrorString(int) { return "emulated CUDA error"; }
template <typename K>
inline int cudaFuncSetAttribute(K, int, int) { return 0; }

namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_cluster->bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu_rank; }
  unsigned num_blocks() const { return emu_cluster->size; }
  template <typename T>
  T* map_shared_rank(T* p, unsigned rank) const {
    auto* at = reinterpret_cast<unsigned char*>(const_cast<std::remove_cv_t<T>*>(p));
    return reinterpret_cast<T*>(emu_smem_pool[rank] + (at - emu_smem));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// A fiber's entry: it leaves the ring when its blocks are done, and
// returning resumes the launch (uc_link).
inline void emu_fiber_main() {
  EmuFiber* f = emu_cur;
  f->body();
  f->done = true;
  f->prev->next = f->next;
  f->next->prev = f->prev;
  --emu_live;
  emu_idle = 0;
}

// Clusters of `cluster` consecutive blocks along x, one after another.
template <typename Kernel, typename... Args>
int emu_run(Kernel kernel, dim3 grid, dim3 block, size_t smem, int cluster, Args... args) {
  const int nt = block.x * block.y * block.z;
  if (nt > 1024 || smem > kEmuSmem || grid.y > 65535 || grid.z > 65535 || cluster < 1 ||
      cluster > kEmuMaxCluster || grid.x % cluster)
    return cudaErrorInvalidConfiguration;
  blockDim = block;
  gridDim = grid;
  std::vector<std::unique_ptr<EmuBlock>> blks;
  for (int r = 0; r < cluster; ++r) {
    auto blk = std::make_unique<EmuBlock>();
    blk->bar = std::make_unique<EmuBarrier>(nt);
    for (int w = 0; w < (nt + 31) / 32; ++w)
      blk->warp_bar.push_back(std::make_unique<EmuBarrier>(std::min(32, nt - 32 * w)));
    for (auto& a : blk->acc) a = 0;
    for (auto& w : blk->warp_acc)
      for (auto& a : w) a = 0;
    blks.push_back(std::move(blk));
  }
  EmuCluster cl{std::make_unique<EmuBarrier>(cluster * nt), cluster};
  const int nf = cluster * nt;
  constexpr size_t kStack = 128 << 10;
  void* stacks = mmap(nullptr, kStack * nf, PROT_READ | PROT_WRITE,
                      MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (stacks == MAP_FAILED) return cudaErrorInvalidConfiguration;
  std::vector<std::unique_ptr<EmuFiber>> fibers(nf);
  ucontext_t main_ctx;
  for (int t = 0; t < nf; ++t) {
    auto& f = fibers[t];
    f = std::make_unique<EmuFiber>();
    const int rank = t / nt, tid = t % nt;
    f->block = blks[rank].get();
    f->cluster = &cl;
    f->rank = rank;
    f->smem = emu_smem_pool[rank];
    f->thread_idx = dim3(tid % block.x, (tid / block.x) % block.y, tid / (block.x * block.y));
    f->body = [&, rank, f = f.get()] {
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; bx += cluster) {
            f->block_idx = dim3(bx + rank, by, bz);
            kernel(args...);
            f->cluster->bar->arrive_and_wait();
          }
    };
    getcontext(&f->ctx);
    f->ctx.uc_stack.ss_sp = static_cast<char*>(stacks) + kStack * t;
    f->ctx.uc_stack.ss_size = kStack;
    f->ctx.uc_link = &main_ctx;
    makecontext(&f->ctx, emu_fiber_main, 0);
  }
  for (int t = 0; t < nf; ++t) {
    fibers[t]->next = fibers[(t + 1) % nf].get();
    fibers[t]->prev = fibers[(t + nf - 1) % nf].get();
  }
  emu_idle = 0;
  emu_live = nf;
  for (int t = 0; t < nf; ++t)
    while (!fibers[t]->done) {  // each fiber that finishes hands back here
      emu_cur = fibers[t].get();
      swapcontext(&main_ctx, &fibers[t]->ctx);
    }
  emu_cur = nullptr;
  munmap(stacks, kStack * nf);
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
void emu_launch(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                Args... args) {
  const int e = emu_run(kernel, grid, block, smem, 1, args...);
  if (e) emu_error = e;
}

template <typename... Params, typename... Args>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Params...),
                       Args&&... args) {
  int cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].id != cudaLaunchAttributeClusterDimension) continue;
    const auto& d = cfg->attrs[i].val.clusterDim;
    if (d.y != 1 || d.z != 1) return cudaErrorInvalidConfiguration;  // not emulated
    cluster = (int)d.x;
  }
  return emu_run(kernel, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cluster,
                 Params(args)...);
}
