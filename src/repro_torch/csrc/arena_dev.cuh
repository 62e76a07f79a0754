// Device-side arena vocabulary shared by the port's allocator kernels
// (alloc_txn.cu, defrag_txn.cu): the layout descriptor of any of the six
// variants (kind page or chunk, queue family ring, va or vl), the
// reference's indexing semantics (floor division and modulo, 32-bit
// wrapping counter arithmetic, gathers that read a fill value and
// scatters that drop out of range after an index in [-n, 0) wraps to
// i + n), the size-class map, a block's thread count for n lanes, a
// block-wide exclusive scan, and the serial queue operations one thread
// drives with the ctl block staged in shared memory.
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
  int spc;             // queue slots per segment of the family (va: wpc,
                       // vl: wpc - 1 for the next pointer; ring: wpc)
  int pool_off;        // mem offsets of the regions (bitmap, free counts
  int bitmap_off;      // and chunk classes: chunk kinds only, else -1)
  int free_off;
  int class_off;
  int ctl_words;
  int core_ctl_words;
  int wrap_capacity;
  int walk_bins;       // overflow-walk depth bins of the telemetry
  int kind;            // KIND_PAGE or KIND_CHUNK
  int family;          // FAM_RING, FAM_VA or FAM_VL
  int queue_off;       // ring: the (C, queue_cap) store; va/vl: the
                       // (C, max_segs) segment directory
  int queue_cap;       // ring slots per class
  int max_segs;        // directory slots per class
};

enum { KIND_PAGE = 0, KIND_CHUNK = 1 };
enum { FAM_RING = 0, FAM_VA = 1, FAM_VL = 2 };

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

// counter arithmetic that wraps at 32 bits, as int32 tensors do
__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// heap word `off` of queue segment chunk `seg`: int32 arithmetic, as the
// reference computes seg * wpc + off
__device__ __forceinline__ int seg_word(int seg, int wpc, int off) {
  return add32(mul32(seg, wpc), off);
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
//
// The one-value dequeue and enqueue of each family, as the reference's
// bulk operations do them for a single lane (rank 0, m = 1).

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
  __device__ int count(int c) { return sub32(back(c), front(c)); }
  __device__ int pool_count() { return sub32(pool_back(), pool_front()); }
  // ring store slot (class c, position p) or va directory slot (c, s)
  __device__ int& ring(int c, int p) {
    return mem[d.queue_off + c * d.queue_cap + fmodi(p, d.queue_cap)];
  }
  __device__ int& dir(int c, int s) {
    return mem[d.queue_off + c * d.max_segs + fmodi(s, d.max_segs)];
  }

  __device__ int pool_pop() {  // no inventory check, as the reference
    int pf = pool_front();
    int id = mem[d.pool_off + fmodi(pf, d.num_chunks)];
    pool_front() = add32(pf, 1);
    return id;
  }

  __device__ void pool_push(int id) {
    int pb = pool_back();
    mem[d.pool_off + fmodi(pb, d.num_chunks)] = id;
    pool_back() = add32(pb, 1);
  }

  // vl dequeue of one value from class c (m = 1: one chain hop)
  __device__ int vl_dequeue1(int c) {
    const int wpc = d.wpc, spc = d.spc, W = d.total_words;
    int h = head(c), f = front(c);
    int nxt = h >= 0 ? heap_get(mem, seg_word(h, wpc, 0), W, -1) : -1;
    int val = heap_get(mem, seg_word(h, wpc, 1 + fmodi(f, spc)), W, -1);
    int n_free = fdiv(add32(f, 1), spc) - fdiv(f, spc);
    if (n_free > 0) pool_push(h);
    head(c) = n_free > 0 ? nxt : h;
    front(c) = add32(f, 1);
    return val;
  }

  // vl enqueue of one value into class c (m = 1)
  __device__ void vl_enqueue1(int c, int val) {
    const int wpc = d.wpc, spc = d.spc, W = d.total_words;
    int b = back(c), tl = tail(c);
    int n_new = fdiv(add32(b, 1), spc) - fdiv(b, spc);
    int nc = -1;
    if (n_new > 0) {
      nc = pool_pop();
      heap_set(mem, seg_word(nc, wpc, 0), W, -1);
      heap_set(mem, seg_word(tl, wpc, 0), W, nc);
    }
    heap_set(mem, seg_word(tl, wpc, 1 + fmodi(b, spc)), W, val);
    if (n_new > 0) tail(c) = nc;
    back(c) = add32(b, 1);
  }

  // va dequeue: the value through the directory; a fully consumed
  // segment goes back to the pool
  __device__ int va_dequeue1(int c) {
    const int spc = d.spc;
    int f = front(c);
    int seg = dir(c, fdiv(f, spc));
    int val = heap_get(mem, seg_word(seg, d.wpc, fmodi(f, spc)),
                       d.total_words, -1);
    if (fdiv(add32(f, 1), spc) - fdiv(f, spc) > 0) pool_push(seg);
    front(c) = add32(f, 1);
    return val;
  }

  // va enqueue: a segment popped into the next directory slot when the
  // write window crosses into it, then the value through the directory
  __device__ void va_enqueue1(int c, int val) {
    const int spc = d.spc;
    int b = back(c);
    if (fdiv(add32(b, 1), spc) - fdiv(b, spc) > 0)
      dir(c, fdiv(b, spc) + 1) = pool_pop();
    heap_set(mem, seg_word(dir(c, fdiv(b, spc)), d.wpc, fmodi(b, spc)),
             d.total_words, val);
    back(c) = add32(b, 1);
  }

  __device__ int dequeue1(int c) {
    if (d.family == FAM_RING) {
      int f = front(c);
      front(c) = add32(f, 1);
      return ring(c, f);
    }
    return d.family == FAM_VA ? va_dequeue1(c) : vl_dequeue1(c);
  }

  __device__ void enqueue1(int c, int val) {
    if (d.family == FAM_RING) {
      int b = back(c);
      ring(c, b) = val;
      back(c) = add32(b, 1);
    } else if (d.family == FAM_VA) {
      va_enqueue1(c, val);
    } else {
      vl_enqueue1(c, val);
    }
  }
};
