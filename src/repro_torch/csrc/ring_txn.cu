// The page allocator's piecewise ring steps: bulk pop and bulk push of
// the per-class rings (each class ring one row of a (C, cap) int32
// store, counters front/back that only grow), and the wrapped window
// gather of a ring.
//
// Replaces: src/repro/kernels/alloc_txn.py::ring_txn_pop and
// ::ring_txn_push, and src/repro/kernels/ring_window.py::ring_window.
// The plain PyTorch versions are ring_txn_pop_ref, ring_txn_push_ref
// and ring_window_ref in src/repro_torch/kernels/ref.py; each pair must
// give identical words.
//
// What bounds it on the H100: launch latency.  A transaction reads its
// n lane words and writes n values or slots (a few to a few hundred
// kilobytes), a few microseconds of memory traffic at most, and the
// ranks are a block-wide scan over the lanes in order.
//
// Design: one block per class.  Block c ranks its members (valid lanes
// of class c) by a block-wide exclusive scan over tiles of blockDim
// lanes, carried from tile to tile, so a rank is the lane's position
// among the class's members in lane order, never an atomic's.  Every
// lane of vals has exactly one writer: block c writes its members (the
// granted value or -1), block 0 also writes -1 to lanes that are masked
// or whose class lies outside [0, C).  Thread 0 writes the class's new
// counter.  A position is (front mod cap + rank) mod cap with floor
// modulo (fmodi) on the true sum, as the TPU kernels slice a doubled
// row from front mod cap.  Counters wrap as int32 (unsigned adds).  The
// window gather is one thread per output word, a 2-D grid of (tiles of
// m, C).  The push writes the store in place, inside its class's row
// only; more than cap values of one class in one push is not defined
// (the TPU kernel sums colliding one-hot slots), and no caller does it.

#include "arena_dev.cuh"

__global__ void __launch_bounds__(1024)
ring_txn_pop_kernel(const int* __restrict__ store, const int* front,
                    const int* back, const int* __restrict__ cls,
                    const uint8_t* __restrict__ valid, int n, int C, int cap,
                    int limit, int* __restrict__ vals, int* new_front) {
  __shared__ int s_warp[32];
  const int c = blockIdx.x;
  const int f = front[c];
  const int start = fmodi(f, cap);
  const int avail = (int)((unsigned)back[c] - (unsigned)f);
  const int* row = store + (long long)c * cap;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool ok = i < n && valid[i];
    const int k = i < n ? cls[i] : -1;
    const bool member = ok && k == c;
    int total;
    const int r = carry + block_excl_scan(member ? 1 : 0, &total, s_warp);
    if (member) {
      const bool grant = !limit || r < avail;
      vals[i] = grant ? row[(int)(((long long)start + r) % cap)] : -1;
    } else if (c == 0 && i < n && (!ok || k < 0 || k >= C)) {
      vals[i] = -1;
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    const int granted = limit ? max(0, min(carry, avail)) : carry;
    new_front[c] = (int)((unsigned)f + (unsigned)granted);
  }
}

__global__ void __launch_bounds__(1024)
ring_txn_push_kernel(int* __restrict__ store, const int* back,
                     const int* __restrict__ cls,
                     const int* __restrict__ vals,
                     const uint8_t* __restrict__ valid, int n, int cap,
                     int* new_back) {
  __shared__ int s_warp[32];
  const int c = blockIdx.x;
  const int b = back[c];
  const int start = fmodi(b, cap);
  int* row = store + (long long)c * cap;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool member = i < n && valid[i] && cls[i] == c;
    int total;
    const int r = carry + block_excl_scan(member ? 1 : 0, &total, s_warp);
    if (member) row[(int)(((long long)start + r) % cap)] = vals[i];
    carry += total;
  }
  if (threadIdx.x == 0) new_back[c] = (int)((unsigned)b + (unsigned)carry);
}

__global__ void ring_window_kernel(const int* __restrict__ store,
                                   const int* front, const int* counts,
                                   int cap, int m, int* __restrict__ out) {
  const int c = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int start = fmodi(front[c], cap);
  out[(long long)c * m + j] =
      j < counts[c]
          ? store[(long long)c * cap + (int)(((long long)start + j) % cap)]
          : -1;
}

// threads of a window block; the grid covers m in tiles of this many
#define RING_WINDOW_THREADS 256

// ---- host launchers (plain C interface, loaded with ctypes) -------------

extern "C" int ring_txn_pop_launch(const int* store, const int* front,
                                   const int* back, const int* cls,
                                   const uint8_t* valid, int n, int C,
                                   int cap, int limit, int* vals,
                                   int* new_front, void* stream) {
  ring_txn_pop_kernel<<<C, block_threads(n), 0, (cudaStream_t)stream>>>(
      store, front, back, cls, valid, n, C, cap, limit, vals, new_front);
  return (int)cudaGetLastError();
}

extern "C" int ring_txn_push_launch(int* store, const int* back,
                                    const int* cls, const int* vals,
                                    const uint8_t* valid, int n, int C,
                                    int cap, int* new_back, void* stream) {
  ring_txn_push_kernel<<<C, block_threads(n), 0, (cudaStream_t)stream>>>(
      store, back, cls, vals, valid, n, cap, new_back);
  return (int)cudaGetLastError();
}

extern "C" int ring_window_launch(const int* store, const int* front,
                                  const int* counts, int C, int cap, int m,
                                  int* out, void* stream) {
  dim3 grid((m + RING_WINDOW_THREADS - 1) / RING_WINDOW_THREADS, C);
  ring_window_kernel<<<grid, RING_WINDOW_THREADS, 0, (cudaStream_t)stream>>>(
      store, front, counts, cap, m, out);
  return (int)cudaGetLastError();
}
