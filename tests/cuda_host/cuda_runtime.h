// Host stand-ins for the CUDA built-ins that checker/csrc/fold.cu uses, so
// that g++ can compile the kernel source for the CPU tests
// (tests/test_torch_fold_host.py). Each CUDA thread is a std::thread, the
// blocks of a launch run one after another, __syncthreads is a
// std::barrier of the block, and a warp's shuffles, ballots and
// __match_any_sync go through a per-warp barrier and exchange array. Static
// __shared__ variables become function statics (one block runs at a time);
// the test's translation turns the launch syntax and the dynamic shared
// array into calls of jf_host_launch and jf_host_dyn_smem. It checks the
// kernel's logic, not its speed, and not what only the card does (memory
// ordering beyond barriers, register spills, the launch limits).
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

struct jf_host_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local jf_host_dim3 threadIdx;
inline jf_host_dim3 blockIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}

template <class A, class B>
inline auto min(A a, B b) -> std::common_type_t<A, B> {
  return a < b ? a : b;
}
template <class A, class B>
inline auto max(A a, B b) -> std::common_type_t<A, B> {
  return a < b ? b : a;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunch = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int jf_host_error = 0;
inline cudaError_t cudaGetLastError() {
  const int e = jf_host_error;
  jf_host_error = 0;
  return e;
}
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}

struct JfHostWarp {
  std::barrier<> bar{32};
  unsigned long long buf[2][32];
};

struct JfHostBlock {
  std::barrier<> bar;
  std::vector<std::unique_ptr<JfHostWarp>> warps;
  std::atomic<int> red[3];
  std::vector<unsigned char> dyn;
  explicit JfHostBlock(int threads) : bar(threads) {
    for (int i = 0; i < threads / 32; ++i) warps.emplace_back(new JfHostWarp);
    for (auto& r : red) r = 0;
  }
};
inline JfHostBlock* jf_host_block = nullptr;
inline thread_local int jf_host_wgen = 0, jf_host_rgen = 0;
inline std::atomic<long long> jf_host_clock{0};

inline long long clock64() { return jf_host_clock.fetch_add(1); }
inline void __syncthreads() { jf_host_block->bar.arrive_and_wait(); }

// A block-wide reduction of v through one of three rotating slots: a slot
// is cleared two calls after its use, when every thread has read it.
inline int jf_host_reduce(int v, bool all) {
  const int g = jf_host_rgen;
  jf_host_rgen = (g + 1) % 3;
  auto& r = jf_host_block->red[g];
  if (all ? !v : v) r.fetch_add(1);
  jf_host_block->bar.arrive_and_wait();
  const int n = r.load();
  if (threadIdx.x == 0) jf_host_block->red[(g + 2) % 3].store(0);
  return all ? n == 0 : n;
}
inline int __syncthreads_or(int v) { return jf_host_reduce(v, false) != 0; }
inline int __syncthreads_and(int v) { return jf_host_reduce(v, true); }
inline int __syncthreads_count(int v) { return jf_host_reduce(v, false); }

// Every lane's value, after a barrier of the warp: two buffers alternate,
// so a lane reads one while the next exchange fills the other.
inline unsigned long long* jf_host_exchange(unsigned long long v) {
  JfHostWarp& w = *jf_host_block->warps[threadIdx.x / 32];
  const int g = jf_host_wgen;
  jf_host_wgen ^= 1;
  w.buf[g][threadIdx.x & 31] = v;
  w.bar.arrive_and_wait();
  return w.buf[g];
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  jf_host_block->warps[threadIdx.x / 32]->bar.arrive_and_wait();
}
template <class T>
inline unsigned long long jf_host_bits(T v) {
  unsigned long long b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
template <class T>
inline T jf_host_value(unsigned long long b) {
  T v;
  std::memcpy(&v, &b, sizeof(T));
  return v;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int = 32) {
  return jf_host_value<T>(jf_host_exchange(jf_host_bits(v))[src & 31]);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d, int = 32) {
  const unsigned long long* b = jf_host_exchange(jf_host_bits(v));
  const int lane = threadIdx.x & 31;
  return lane >= (int)d ? jf_host_value<T>(b[lane - d]) : v;
}
inline unsigned __ballot_sync(unsigned, int p) {
  const unsigned long long* b = jf_host_exchange(p ? 1 : 0);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)b[i] << i;
  return r;
}
template <class T>
inline unsigned __match_any_sync(unsigned, T v) {
  const unsigned long long me = jf_host_bits(v);
  const unsigned long long* b = jf_host_exchange(me);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (b[i] == me ? 1u : 0u) << i;
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

inline unsigned char* jf_host_dyn_smem() { return jf_host_block->dyn.data(); }

// kernel<<<grid, block, smem, stream>>>(args) as translated by the test.
inline void jf_host_launch(unsigned grid, unsigned block, size_t smem,
                           const std::function<void()>& body) {
  if (block % 32 != 0 || block > 1024 || smem > 232448) {
    jf_host_error = cudaErrorLaunch;
    return;
  }
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    JfHostBlock blk(block);
    blk.dyn.assign(smem, 0xA5);  // not zero: the kernel must not rely on it
    jf_host_block = &blk;
    std::vector<std::thread> threads;
    threads.reserve(block);
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([t, &body] {
        threadIdx.x = t;
        jf_host_wgen = 0;
        jf_host_rgen = 0;
        body();
      });
    for (auto& th : threads) th.join();
    jf_host_block = nullptr;
  }
}
