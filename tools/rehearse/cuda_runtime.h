// Host stand-in for the CUDA runtime, so that csrc/trip.cu builds as host
// C++ (tools/rehearse/rehearse.py): every lane of a block is a host thread
// and the blocks of a launch run one after another.  Warp collectives
// (shuffles, ballots, __reduce_min_sync, __syncwarp) write each lane's value
// into an exchange array between two waits on a barrier of the lanes in
// the mask; __syncthreads is a barrier of the block.  Shared memory is a
// per-block buffer filled with NaN, cp.async is a plain copy (the kernel's
// #ifdef __CUDA_ARCH__), clock64 reads 0.  Device attributes are the H100's.
#pragma once
#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3_ {
  unsigned x, y, z;
};
struct uint4 {
  unsigned x, y, z, w;
};
struct float4 {
  float x, y, z, w;
};
struct int4 {
  int x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

extern thread_local uint3_ threadIdx;
extern thread_local uint3_ blockIdx;
extern dim3 blockDim;
extern thread_local float* g_smem;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum {
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
  cudaDevAttrMultiProcessorCount = 16
};
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes, sharedSizeBytes;
};
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) {
  return 0;
}
template <class K>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* f, K) {
  f->numRegs = 0;
  f->localSizeBytes = 0;
  f->sharedSizeBytes = 0;
  return 0;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K,
                                                                 int, size_t) {
  *b = 1;
  return 0;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? 132 : 232448;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline long long clock64() { return 0; }
template <class T>
inline cudaError_t cudaMemcpyFromSymbol(void* d, const T& s, size_t n) {
  std::memcpy(d, &s, n);
  return 0;
}
template <class T>
inline cudaError_t cudaMemcpyToSymbol(T& s, const void* d, size_t n) {
  std::memcpy(&s, d, n);
  return 0;
}

struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, gen = 0;
  void wait(int n) {
    std::unique_lock<std::mutex> lk(m);
    const int g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
      return;
    }
    cv.wait(lk, [&] { return gen != g; });
  }
};
extern std::mutex g_bar_mu;
extern std::map<std::pair<int, unsigned>, HostBarrier*> g_bars;
extern HostBarrier* g_block_bar;
extern uint64_t g_xch[1024];
extern std::mutex g_atomic_mu;

// the barrier of the lanes in `mask` of the calling thread's warp
inline HostBarrier* warp_bar(unsigned mask) {
  const int warp = threadIdx.x / 32;
  std::lock_guard<std::mutex> lk(g_bar_mu);
  const auto key = std::make_pair(warp, mask);
  auto it = g_bars.find(key);
  if (it == g_bars.end()) it = g_bars.emplace(key, new HostBarrier()).first;
  return it->second;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  warp_bar(mask)->wait(__builtin_popcount(mask));
}
inline void __syncthreads() { g_block_bar->wait(blockDim.x); }

template <class T>
inline uint64_t to_bits(T v) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
template <class T>
inline T from_bits(uint64_t b) {
  T v;
  std::memcpy(&v, &b, sizeof(T));
  return v;
}

template <class T>
inline T __shfl_sync(unsigned mask, T v, int src) {
  HostBarrier* b = warp_bar(mask);
  const int n = __builtin_popcount(mask), base = threadIdx.x & ~31;
  g_xch[threadIdx.x] = to_bits(v);
  b->wait(n);
  const T r = from_bits<T>(g_xch[base + (src & 31)]);
  b->wait(n);
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int off) {
  return __shfl_sync(mask, v, (int)((threadIdx.x & 31) ^ off));
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  HostBarrier* b = warp_bar(mask);
  const int n = __builtin_popcount(mask), base = threadIdx.x & ~31;
  g_xch[threadIdx.x] = pred ? 1 : 0;
  b->wait(n);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l)
    if (((mask >> l) & 1u) && g_xch[base + l]) r |= 1u << l;
  b->wait(n);
  return r;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  HostBarrier* b = warp_bar(mask);
  const int n = __builtin_popcount(mask), base = threadIdx.x & ~31;
  g_xch[threadIdx.x] = v;
  b->wait(n);
  unsigned r = 0xffffffffu;
  for (int l = 0; l < 32; ++l)
    if ((mask >> l) & 1u) r = std::min<unsigned>(r, (unsigned)g_xch[base + l]);
  b->wait(n);
  return r;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((uint64_t)a * b) >> 32);
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline double atomicAdd(double* p, double v) {
  std::lock_guard<std::mutex> lk(g_atomic_mu);
  const double o = *p;
  *p = o + v;
  return o;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicOr(int* p, int v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

// what `kernel<<<grid, threads, bytes, stream>>>(a)` becomes
template <class K, class A>
int host_launch(K kernel, dim3 grid, int threads, size_t bytes, const A& a) {
  std::vector<float> smem(bytes / 4 + 1);
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    std::fill(smem.begin(), smem.end(),
              std::numeric_limits<float>::quiet_NaN());
    blockDim = dim3(threads);
    HostBarrier block_bar;
    g_block_bar = &block_bar;
    for (auto& kv : g_bars) delete kv.second;
    g_bars.clear();
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, t, bx] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {bx, 0, 0};
        g_smem = smem.data();
        kernel(a);
      });
    for (auto& x : lanes) x.join();
  }
  return 0;
}
