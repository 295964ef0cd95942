// The globals of the host stand-in (cuda_runtime.h).
#include "cuda_runtime.h"
thread_local uint3_ threadIdx;
thread_local uint3_ blockIdx;
dim3 blockDim;
thread_local float* g_smem;
std::mutex g_bar_mu;
std::map<std::pair<int, unsigned>, HostBarrier*> g_bars;
HostBarrier* g_block_bar;
uint64_t g_xch[1024];
std::mutex g_atomic_mu;
