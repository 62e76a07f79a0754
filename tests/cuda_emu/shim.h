// Host emulation of the CUDA device features the port's kernels use, so
// that their sources compile with a C++20 host compiler and run on the
// CPU: every thread of a block is a std::thread, __syncthreads is a
// block barrier, warp shuffles go through a per-warp barrier, atomics
// are host atomics.  Blocks of a grid run one after another.  Shared
// memory declared in a kernel becomes function-static storage (the
// test harness rewrites the dynamic `extern __shared__` array to point
// at a per-launch buffer).
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static

using std::max;
using std::min;

struct U3 { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

inline thread_local U3 threadIdx, blockIdx;
inline U3 blockDim, gridDim;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline std::vector<int> emu_shfl;
inline void* emu_dyn_smem = nullptr;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }

// A barrier that returns whether any thread's predicate was non-zero:
// the block ORs into one word between two barriers, and thread 0 clears
// it after a third, once every thread has read it.
inline int emu_sync_or = 0;
inline int __syncthreads_or(int p) {
  if (p) __atomic_fetch_or(&emu_sync_or, 1, __ATOMIC_SEQ_CST);
  __syncthreads();
  const int r = __atomic_load_n(&emu_sync_or, __ATOMIC_SEQ_CST);
  __syncthreads();
  if (threadIdx.x == 0) emu_sync_or = 0;
  __syncthreads();
  return r;
}

// Every lane of the warp posts a word; the barrier after the reads lets
// the next exchange reuse the slots.
template <class V, class F>
inline auto emu_warp_exchange(V v, F read) {
  static_assert(sizeof(V) == sizeof(int));
  const int t = threadIdx.x, w = t / 32;
  std::memcpy(&emu_shfl[t], &v, sizeof(V));
  emu_warp_barriers[w]->arrive_and_wait();
  auto r = read(w * 32, std::min(32, (int)blockDim.x - 32 * w));
  emu_warp_barriers[w]->arrive_and_wait();
  return r;
}

template <class V>
inline V emu_lane_value(int slot) {
  V v;
  std::memcpy(&v, &emu_shfl[slot], sizeof(V));
  return v;
}

template <class V>
inline V __shfl_sync(unsigned, V v, int src) {
  return emu_warp_exchange(v, [&](int w0, int nl) {
    return emu_lane_value<V>(w0 + ((src % 32 + 32) % 32) % nl);
  });
}

template <class V>
inline V __shfl_xor_sync(unsigned, V v, int mask) {
  return emu_warp_exchange(v, [&](int w0, int nl) {
    const int src = (threadIdx.x % 32) ^ mask;
    return src < nl ? emu_lane_value<V>(w0 + src) : v;
  });
}

template <class V>
inline V __shfl_up_sync(unsigned, V v, int d) {
  return emu_warp_exchange(v, [&](int w0, int) {
    const int lane = threadIdx.x % 32;
    return lane >= d ? emu_lane_value<V>(w0 + lane - d) : v;
  });
}

inline unsigned __ballot_sync(unsigned, int p) {
  return emu_warp_exchange(p ? 1 : 0, [](int w0, int nl) {
    unsigned b = 0;
    for (int j = 0; j < nl; ++j)
      if (emu_lane_value<int>(w0 + j)) b |= 1u << j;
    return b;
  });
}

// a barrier of the warp's lanes, which also orders their memory
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}

// the lanes of the warp whose value equals this lane's
inline unsigned __match_any_sync(unsigned, int v) {
  return emu_warp_exchange(v, [v](int w0, int nl) {
    unsigned b = 0;
    for (int j = 0; j < nl; ++j)
      if (emu_lane_value<int>(w0 + j) == v) b |= 1u << j;
    return b;
  });
}

inline int __all_sync(unsigned, int p) {
  return emu_warp_exchange(p ? 1 : 0, [](int w0, int nl) {
    for (int j = 0; j < nl; ++j)
      if (!emu_lane_value<int>(w0 + j)) return 0;
    return 1;
  });
}

inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMin(int* p, int v) {
  int cur = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < cur && !__atomic_compare_exchange_n(p, &cur, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return cur;
}
inline int atomicMax(int* p, int v) {
  int cur = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > cur && !__atomic_compare_exchange_n(p, &cur, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return cur;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}

// Run `body` as a grid of `grid` blocks of `block` threads.
template <class F>
void emu_launch(int grid, int block, size_t smem, F body) {
  std::vector<char> buf(smem + 16);
  emu_dyn_smem = buf.data();
  blockDim.x = block;
  gridDim.x = grid;
  emu_shfl.assign(block, 0);
  emu_warp_barriers.clear();
  for (int w = 0; w < (block + 31) / 32; ++w)
    emu_warp_barriers.emplace_back(
        new std::barrier<>(std::min(32, block - 32 * w)));
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    emu_block_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
