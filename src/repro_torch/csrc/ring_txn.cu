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
// n lane words and writes n values or slots (a few bytes to a few
// hundred kilobytes), well under a microsecond of memory traffic, and
// most calls are narrow: the piecewise chunk allocator pops and pushes
// one lane at a time.
//
// Design: one block ranks every class at once.  A member is a valid
// lane whose class lies in [0, C); its rank is its position among its
// class's members in lane order, never an atomic's.  The launcher picks
// one of three paths by n and C (ring_path):
//   warp   n <= 32, C <= 32: one warp, no shared memory, no barrier.
//          __match_any_sync groups the lanes by class; a lane's rank is
//          the popcount of its peers below it, and lane c holds class
//          c's counters, so a member reads its class's by a shuffle and
//          lane c writes class c's new counter.
//   block  n > 32, C <= 32: one block of ring_block_threads(n, C)
//          threads ranks every class at once (rank_ring): each warp
//          walks a contiguous run of 32-lane groups, coalesced, and
//          ranks each group's lanes within the warp by one
//          __match_any_sync; one block_class_scan (arena_dev.cuh) gives
//          every warp its start in every class; a member's class rank is
//          the sum.  Threads c < C stage the counters before the scan
//          and write the new ones after; a warp gathers (pop) or
//          scatters (push) a batch of groups at once.  Each lane word is
//          read by one block, where C blocks each read every lane.
//   class  C > 32: one block per class, each ranking its members by a
//          block scan carried over tiles of blockDim lanes (no arena
//          reaches this: a HeapConfig has at most 32 classes).
// Every lane of vals has exactly one writer: its member's granted value,
// or -1 for a lane refused by the inventory, masked, or of a class
// outside [0, C).  A position is (front mod cap + rank) mod cap with
// floor modulo (fmodi) on the true sum, as the TPU kernels slice a
// doubled row from front mod cap.  Counters wrap as int32 (unsigned
// adds).  The push writes the store in place, inside its class's row
// only; more than cap values of one class in one push is not defined
// (the TPU kernel sums colliding one-hot slots), and no caller does it.
// The window gather is one thread per output word, a 2-D grid of (tiles
// of m, C).  Each pop and push launch counts itself by path
// (g_ring_launches, read by ring_txn_launch_stats).

#include "arena_dev.cuh"

// Each pop and push launch by path since the last reset (count_launch),
// read and cleared by ring_txn_launch_stats.
enum RingLaunch {
  LS_POP_WARP,
  LS_POP_BLOCK,
  LS_POP_CLASS,
  LS_PUSH_WARP,
  LS_PUSH_BLOCK,
  LS_PUSH_CLASS,
  kRingLaunches
};
__device__ unsigned long long g_ring_launches[kRingLaunches];

// The path of a transaction of n lanes over C classes (the header's
// warp, block and class), as the launchers and the emulation pick it.
enum RingPath { RING_WARP, RING_BLOCK, RING_CLASS };

static inline int ring_path(int n, int C) {
  return C > MAX_CLASSES ? RING_CLASS : (n <= 32 ? RING_WARP : RING_BLOCK);
}

// The block path's threads: one a lane up to 1024, and at least a warp
// a class, so block_class_scan gives each class its own warp.
static inline int ring_block_threads(int n, int C) {
  const int t = block_threads(n);
  return t < 32 * C ? 32 * C : t;
}

// The block path's batch of 32-lane groups a warp loads at once: the
// fewest of 1, 2, 4, 8 and 16 that hold the warp's whole run (one pass,
// no idle slot; 16 covers 16,384 lanes), else 8 (two passes).  Each is
// its own kernel instance.
static inline int ring_unroll(int n, int C) {
  const int nw = ring_block_threads(n, C) / 32;
  const int per = ((n + 31) / 32 + nw - 1) / nw;
  return per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8
         : per <= 16 ? 16 : 8;
}

// lane i's class if it is a member (valid, class in [0, C)), else -1
__device__ __forceinline__ int ring_member(const int* __restrict__ cls,
                                           const uint8_t* __restrict__ valid,
                                           int i, int C) {
  const int k = cls[i];
  return valid[i] && k >= 0 && k < C ? k : -1;
}

// row slot of class rank q >= 0 in a ring whose row starts at start
// (front or back mod cap, in [0, cap)): one compare below cap ranks, the
// modulo past them
__device__ __forceinline__ int ring_slot(int start, int q, int cap) {
  const unsigned s = (unsigned)start + (unsigned)q;
  return q < cap ? (int)(s >= (unsigned)cap ? s - cap : s)
                 : (int)(s % (unsigned)cap);
}

// The warp path's ranks: lane i's class k (-1 past n or for a
// non-member), its rank among its class's lanes, and on lane c the
// member count of class c.  One match, one ballot and a shuffle pair
// for each class present.
struct WarpRanks {
  int k, r, total;
};

__device__ __forceinline__ WarpRanks warp_ranks(
    const int* __restrict__ cls, const uint8_t* __restrict__ valid, int n,
    int C) {
  const int lane = threadIdx.x;
  WarpRanks w;
  w.k = lane < n ? ring_member(cls, valid, lane, C) : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, w.k);
  w.r = __popc(peers & ((1u << lane) - 1u));
  w.total = 0;
  // each class's first member hands its class's count to lane k
  unsigned lead = __ballot_sync(0xffffffffu, w.k >= 0 && w.r == 0);
  while (lead) {  // warp-uniform
    const int j = __ffs(lead) - 1;
    lead &= lead - 1u;
    const int kj = __shfl_sync(0xffffffffu, w.k, j);
    const int cj = __shfl_sync(0xffffffffu, __popc(peers), j);
    if (lane == kj) w.total = cj;
  }
  return w;
}

__global__ void __launch_bounds__(32)
ring_txn_pop_warp_kernel(const int* __restrict__ store, const int* front,
                         const int* back, const int* __restrict__ cls,
                         const uint8_t* __restrict__ valid, int n, int C,
                         int cap, int limit, int* __restrict__ vals,
                         int* new_front) {
  count_launch(g_ring_launches, LS_POP_WARP);
  const int lane = threadIdx.x;
  const int f = lane < C ? front[lane] : 0;
  const int avail = lane < C ? sub32(back[lane], f) : 0;
  const WarpRanks w = warp_ranks(cls, valid, n, C);
  const int src = w.k < 0 ? 0 : w.k;
  const int fk = __shfl_sync(0xffffffffu, f, src);
  const int ak = __shfl_sync(0xffffffffu, avail, src);
  if (lane < n)
    vals[lane] = w.k >= 0 && (!limit || w.r < ak)
                     ? store[(long long)w.k * cap +
                             ring_slot(fmodi(fk, cap), w.r, cap)]
                     : -1;
  if (lane < C)
    new_front[lane] =
        add32(f, limit ? max(0, min(w.total, avail)) : w.total);
}

__global__ void __launch_bounds__(32)
ring_txn_push_warp_kernel(int* __restrict__ store, const int* back,
                          const int* __restrict__ cls,
                          const int* __restrict__ vals,
                          const uint8_t* __restrict__ valid, int n, int C,
                          int cap, int* new_back) {
  count_launch(g_ring_launches, LS_PUSH_WARP);
  const int lane = threadIdx.x;
  const int b = lane < C ? back[lane] : 0;
  const WarpRanks w = warp_ranks(cls, valid, n, C);
  const int bk = __shfl_sync(0xffffffffu, b, w.k < 0 ? 0 : w.k);
  if (w.k >= 0)
    store[(long long)w.k * cap + ring_slot(fmodi(bk, cap), w.r, cap)] =
        vals[lane];
  if (lane < C) new_back[lane] = add32(b, w.total);
}

// The block path's shared words: block_class_scan's table, each class's
// member count and class-major base, the staged counters (the pop's
// inventory, the row start: front or back mod cap), and each warp's row
// of its per-class counts, then of its next in-warp or class ranks.
struct RingShared {
  int tab[kClassTab];
  int count[MAX_CLASSES], base[MAX_CLASSES];
  int avail[MAX_CLASSES], start[MAX_CLASSES];
  int row[32 * 33];
};

constexpr int kPastRun = -2;

// The block path's ranks: each warp walks a contiguous run of 32-lane
// groups, U at a time (ring_unroll), so ranks follow lane order as in
// rank_lanes, and hands each batch's ranks to apply(g, m, q) at once, so
// that the batch's loads and gathers are in flight together: m[u] is
// lane (g + u) * 32 + lane's class (-1 for a non-member, kPastRun past n
// or the warp's run), q[u] its rank within its class.  A group's lanes
// of one class find each other with one __match_any_sync; each lane's
// rank among its warp's earlier lanes of its class is its warp row's
// entry plus its peers below it, and the class's first lane moves the
// row on.  block_class_scan turns the warp rows' counts into each
// warp's first rank of each class (count[c] and base[c] for warp 0's
// threads c).  A warp run of at most U groups (U = 4 at 4096 lanes
// on 1024 threads) keeps its classes and in-warp ranks in registers across
// the scan, which then only adds each class's warp start; a longer run
// counts its classes first (each class's first lane adding its peers)
// and ranks them in a second pass after the scan.
template <int U, class ClassOf, class Apply>
__device__ __forceinline__ void rank_ring(int n, int C, ClassOf cls_of,
                                          Apply apply, RingShared& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, groups = (n + 31) >> 5;
  const int per = (groups + nw - 1) / nw;
  const int g0 = min(groups, wid * per), g1 = min(groups, g0 + per);
  const unsigned below = (1u << lane) - 1u;
  int* row = sh.row + wid * 33;
  auto load = [&](int g, int* m) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = (g + u) * 32 + lane;
      m[u] = (g + u < g1 && i < n) ? cls_of(i) : kPastRun;
    }
  };
  // this lane's rank among the warp's earlier lanes of its class; the
  // class's row entry moves past the group's lanes of it
  auto step = [&](int m) {
    const unsigned peers = __match_any_sync(0xffffffffu, m);
    const int at = m < 0 ? 0 : row[m];
    __syncwarp();
    if (m >= 0 && !(peers & below)) row[m] = at + __popc(peers);
    __syncwarp();
    return at + __popc(peers & below);
  };
  if (lane < C) row[lane] = 0;
  __syncwarp();
  const bool one = per <= U;  // block-uniform
  int first[U], q[U];
  load(g0, first);
  if (one) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      q[u] = g0 + u < g1 ? step(first[u]) : 0;  // warp-uniform test
  } else {
    for (int g = g0; g < g1; g += U) {
      int m[U];
      if (g == g0) {
#pragma unroll
        for (int u = 0; u < U; ++u) m[u] = first[u];
      } else {
        load(g, m);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g + u >= g1) break;  // warp-uniform
        const unsigned peers = __match_any_sync(0xffffffffu, m[u]);
        if (m[u] >= 0 && !(peers & below))
          atomicAdd(&row[m[u]], __popc(peers));
      }
    }
  }
  __syncwarp();
  const int next = block_class_scan(lane < C ? row[lane] : 0, C, sh.count,
                                    sh.base, sh.tab);
  const int start = lane < C ? next - sh.base[lane] : 0;
  if (one) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      q[u] += __shfl_sync(0xffffffffu, start, first[u] < 0 ? 0 : first[u]);
    apply(g0, first, q);
    return;
  }
  if (lane < C) row[lane] = start;
  __syncwarp();
  for (int g = g0; g < g1; g += U) {
    int m[U];
    if (g == g0) {
#pragma unroll
      for (int u = 0; u < U; ++u) m[u] = first[u];
    } else {
      load(g, m);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      q[u] = g + u < g1 ? step(m[u]) : 0;  // warp-uniform test
    apply(g, m, q);
  }
}

template <int U>
__global__ void __launch_bounds__(1024)
ring_txn_pop_block_kernel(const int* __restrict__ store, const int* front,
                          const int* back, const int* __restrict__ cls,
                          const uint8_t* __restrict__ valid, int n, int C,
                          int cap, int limit, int* __restrict__ vals,
                          int* new_front) {
  __shared__ RingShared sh;
  count_launch(g_ring_launches, LS_POP_BLOCK);
  const int t = threadIdx.x, lane = t & 31;
  int f = 0, avail = 0;
  if (t < C) {  // block_class_scan's first barrier orders these
    f = front[t];
    avail = sub32(back[t], f);
    sh.avail[t] = avail;
    sh.start[t] = fmodi(f, cap);
  }
  rank_ring<U>(
      n, C, [=](int i) { return ring_member(cls, valid, i, C); },
      [=](int g, const int* m, const int* q) {
        int v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {  // the gathers, together
          const int c = m[u];
          v[u] = -1;
          if (c >= 0 && (!limit || q[u] < sh.avail[c]))
            v[u] = store[(long long)c * cap +
                         ring_slot(sh.start[c], q[u], cap)];
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (m[u] != kPastRun) vals[(g + u) * 32 + lane] = v[u];
      },
      sh);
  if (t < C) {  // thread c (warp 0) wrote count[c] itself: no barrier
    const int m = sh.count[t];
    new_front[t] = add32(f, limit ? max(0, min(m, avail)) : m);
  }
}

template <int U>
__global__ void __launch_bounds__(1024)
ring_txn_push_block_kernel(int* __restrict__ store, const int* back,
                           const int* __restrict__ cls,
                           const int* __restrict__ vals,
                           const uint8_t* __restrict__ valid, int n, int C,
                           int cap, int* new_back) {
  __shared__ RingShared sh;
  count_launch(g_ring_launches, LS_PUSH_BLOCK);
  const int t = threadIdx.x, lane = t & 31;
  const int b = t < C ? back[t] : 0;
  if (t < C) sh.start[t] = fmodi(b, cap);  // ordered by the class scan
  rank_ring<U>(
      n, C, [=](int i) { return ring_member(cls, valid, i, C); },
      [=](int g, const int* m, const int* q) {
        int v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)  // the values, together
          if (m[u] >= 0) v[u] = vals[(g + u) * 32 + lane];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = m[u];
          if (c >= 0)
            store[(long long)c * cap +
                  ring_slot(sh.start[c], q[u], cap)] = v[u];
        }
      },
      sh);
  if (t < C) new_back[t] = add32(b, sh.count[t]);  // thread t's own word
}

__global__ void __launch_bounds__(1024)
ring_txn_pop_class_kernel(const int* __restrict__ store, const int* front,
                          const int* back, const int* __restrict__ cls,
                          const uint8_t* __restrict__ valid, int n, int C,
                          int cap, int limit, int* __restrict__ vals,
                          int* new_front) {
  __shared__ int s_warp[32];
  count_launch(g_ring_launches, LS_POP_CLASS);
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
ring_txn_push_class_kernel(int* __restrict__ store, const int* back,
                           const int* __restrict__ cls,
                           const int* __restrict__ vals,
                           const uint8_t* __restrict__ valid, int n, int cap,
                           int* new_back) {
  __shared__ int s_warp[32];
  count_launch(g_ring_launches, LS_PUSH_CLASS);
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

template <int U>
static void pop_block(const int* store, const int* front, const int* back,
                      const int* cls, const uint8_t* valid, int n, int C,
                      int cap, int limit, int* vals, int* new_front,
                      cudaStream_t s) {
  ring_txn_pop_block_kernel<U><<<1, ring_block_threads(n, C), 0, s>>>(
      store, front, back, cls, valid, n, C, cap, limit, vals, new_front);
}

template <int U>
static void push_block(int* store, const int* back, const int* cls,
                       const int* vals, const uint8_t* valid, int n, int C,
                       int cap, int* new_back, cudaStream_t s) {
  ring_txn_push_block_kernel<U><<<1, ring_block_threads(n, C), 0, s>>>(
      store, back, cls, vals, valid, n, C, cap, new_back);
}

extern "C" int ring_txn_pop_launch(const int* store, const int* front,
                                   const int* back, const int* cls,
                                   const uint8_t* valid, int n, int C,
                                   int cap, int limit, int* vals,
                                   int* new_front, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int u = ring_unroll(n, C);
  const auto block = u == 1   ? pop_block<1>
                     : u == 2 ? pop_block<2>
                     : u == 4 ? pop_block<4>
                     : u == 8 ? pop_block<8>
                              : pop_block<16>;
  switch (ring_path(n, C)) {
    case RING_WARP:
      ring_txn_pop_warp_kernel<<<1, 32, 0, s>>>(
          store, front, back, cls, valid, n, C, cap, limit, vals, new_front);
      break;
    case RING_BLOCK:
      block(store, front, back, cls, valid, n, C, cap, limit, vals,
            new_front, s);
      break;
    default:
      ring_txn_pop_class_kernel<<<C, block_threads(n), 0, s>>>(
          store, front, back, cls, valid, n, C, cap, limit, vals, new_front);
  }
  return (int)cudaGetLastError();
}

extern "C" int ring_txn_push_launch(int* store, const int* back,
                                    const int* cls, const int* vals,
                                    const uint8_t* valid, int n, int C,
                                    int cap, int* new_back, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int u = ring_unroll(n, C);
  const auto block = u == 1   ? push_block<1>
                     : u == 2 ? push_block<2>
                     : u == 4 ? push_block<4>
                     : u == 8 ? push_block<8>
                              : push_block<16>;
  switch (ring_path(n, C)) {
    case RING_WARP:
      ring_txn_push_warp_kernel<<<1, 32, 0, s>>>(store, back, cls, vals,
                                                  valid, n, C, cap, new_back);
      break;
    case RING_BLOCK:
      block(store, back, cls, vals, valid, n, C, cap, new_back, s);
      break;
    default:
      ring_txn_push_class_kernel<<<C, block_threads(n), 0, s>>>(
          store, back, cls, vals, valid, n, cap, new_back);
  }
  return (int)cudaGetLastError();
}

// Each pop and push launch by path (kRingLaunches words, in RingLaunch
// order); reset clears them after the read.
extern "C" int ring_txn_launch_stats(unsigned long long* out, int reset) {
  int err = (int)cudaMemcpyFromSymbol(out, g_ring_launches,
                                      sizeof(g_ring_launches));
  if (!err && reset) {
    const unsigned long long zero[kRingLaunches] = {};
    err = (int)cudaMemcpyToSymbol(g_ring_launches, zero, sizeof(zero));
  }
  return err;
}

extern "C" int ring_window_launch(const int* store, const int* front,
                                  const int* counts, int C, int cap, int m,
                                  int* out, void* stream) {
  dim3 grid((m + RING_WINDOW_THREADS - 1) / RING_WINDOW_THREADS, C);
  ring_window_kernel<<<grid, RING_WINDOW_THREADS, 0, (cudaStream_t)stream>>>(
      store, front, counts, cap, m, out);
  return (int)cudaGetLastError();
}
