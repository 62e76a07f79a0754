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

inline int __shfl_up_sync(unsigned, int v, int d) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  emu_shfl[t] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  const int r = lane >= d ? emu_shfl[t - d] : v;
  emu_warp_barriers[w]->arrive_and_wait();
  return r;
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
