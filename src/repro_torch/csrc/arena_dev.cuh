// Device-side arena vocabulary shared by the port's allocator kernels
// (alloc_txn.cu, defrag_txn.cu): the layout descriptor, the reference's
// indexing semantics (floor division and modulo, gathers that read a
// fill value and scatters that drop out of range after an index in
// [-n, 0) wraps to i + n), the size-class map, a block's thread count
// for n lanes, a block-wide exclusive scan, and the serial queue
// operations one thread drives with the ctl block staged in shared
// memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct ArenaDesc {
  int total_words;     // heap words
  int num_chunks;
  int wpc;             // words per chunk
  int bw;              // bitmap words per chunk
  int num_classes;
  int min_page_log2;   // log2(min page bytes)
  int chunk_bytes;
  int min_page_words;  // page_words(0)
  int max_ppc;         // pages_per_chunk(0)
  int spc;             // queue slots per vl segment
  int pool_off;        // mem offsets of the regions
  int bitmap_off;
  int free_off;
  int class_off;
  int ctl_words;
  int core_ctl_words;
  int wrap_capacity;
  int walk_bins;       // overflow-walk depth bins of the telemetry
};

#define MAX_CTL 256
#define MAX_CLASSES 32

__device__ __forceinline__ int fdiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

__device__ __forceinline__ int fmodi(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ int wrapi(long long i, int n) {
  return (int)(i < 0 ? i + n : i);
}

// heap gather with fill / scatter with drop
__device__ __forceinline__ int heap_get(const int* heap, long long i, int n,
                                        int fill) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? heap[i] : fill;
}

__device__ __forceinline__ void heap_set(int* heap, long long i, int n,
                                         int v) {
  if (i < 0) i += n;
  if (i >= 0 && i < n) heap[i] = v;
}

// plain indexing of a per-chunk table: wrap, then clamp
__device__ __forceinline__ int clamp_chunk(int c, int nc) {
  if (c < 0) c += nc;
  return c < 0 ? 0 : (c >= nc ? nc - 1 : c);
}

__device__ __forceinline__ int size_class(const ArenaDesc& d, int raw) {
  int s = raw < (1 << d.min_page_log2) ? (1 << d.min_page_log2) : raw;
  int bits = 32 - __clz(s - 1);
  int c = bits - d.min_page_log2;
  return (raw < 0 || s > d.chunk_bytes) ? d.num_classes : c;
}

// launch geometry of a block over n lanes (or words): one thread each,
// up to 1024, a multiple of 32
static inline int block_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// Exclusive block-wide scan of one int per thread; blockDim.x is a
// multiple of 32.  *total receives the block sum.
__device__ int block_excl_scan(int v, int* total, int* s_warp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < nw ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) s_warp[lane] = w;
  }
  __syncthreads();
  int before = wid > 0 ? s_warp[wid - 1] : 0;
  *total = s_warp[nw - 1];
  __syncthreads();
  return before + x - v;
}

// ---- serial queue operations (one thread, ctl staged in shared) ---------

struct Chain {
  const ArenaDesc& d;
  int* mem;
  int* ctl;  // shared copy

  __device__ int& front(int c) { return ctl[c]; }
  __device__ int& back(int c) { return ctl[d.num_classes + c]; }
  __device__ int& head(int c) { return ctl[2 * d.num_classes + c]; }
  __device__ int& tail(int c) { return ctl[3 * d.num_classes + c]; }
  __device__ int& pool_front() { return ctl[4 * d.num_classes]; }
  __device__ int& pool_back() { return ctl[4 * d.num_classes + 1]; }

  __device__ int pool_pop() {  // no inventory check, as the reference
    int pf = pool_front();
    int id = mem[d.pool_off + fmodi(pf, d.num_chunks)];
    pool_front() = pf + 1;
    return id;
  }

  __device__ void pool_push(int id) {
    int pb = pool_back();
    mem[d.pool_off + fmodi(pb, d.num_chunks)] = id;
    pool_back() = pb + 1;
  }

  // vl dequeue of one value from class c (m = 1: one chain hop)
  __device__ int vl_dequeue1(int c) {
    const int wpc = d.wpc, spc = d.spc, W = d.total_words;
    int h = head(c), f = front(c);
    int nxt = h >= 0 ? heap_get(mem, (long long)h * wpc, W, -1) : -1;
    long long word = (long long)h * wpc + 1 + fmodi(f, spc);
    int val = heap_get(mem, word, W, -1);
    int n_free = fdiv(f + 1, spc) - fdiv(f, spc);
    if (n_free > 0) pool_push(h);
    head(c) = n_free > 0 ? nxt : h;
    front(c) = f + 1;
    return val;
  }

  // vl enqueue of one value into class c (m = 1)
  __device__ void vl_enqueue1(int c, int val) {
    const int wpc = d.wpc, spc = d.spc, W = d.total_words;
    int b = back(c), tl = tail(c);
    int n_new = fdiv(b + 1, spc) - fdiv(b, spc);
    int nc = -1;
    if (n_new > 0) {
      nc = pool_pop();
      heap_set(mem, (long long)nc * wpc, W, -1);
      heap_set(mem, (long long)tl * wpc, W, nc);
    }
    heap_set(mem, (long long)tl * wpc + 1 + fmodi(b, spc), W, val);
    if (n_new > 0) tail(c) = nc;
    back(c) = b + 1;
  }
};
