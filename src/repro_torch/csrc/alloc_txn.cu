// Ouroboros bulk allocator transactions on the device-resident arena,
// for the (kind=chunk, family=vl) variant: one kernel launch per
// transaction.
//
// Replaces: src/repro/kernels/alloc_txn.py::arena_alloc_txn and
// ::arena_free_txn (and their region-blocked twins in
// alloc_txn_blocked.py), whose bodies are transactions.alloc_math /
// free_math.  The plain PyTorch version is
// src/repro_torch/core/transactions.py::alloc_math / free_math; the
// two must leave identical mem/ctl words and offsets.
//
// What bounds it on the H100: latency, not bandwidth or arithmetic.  A
// transaction touches a few kilobytes, but it is a chain of dependent
// queue operations (vl dequeue with its chain walk and segment shrink,
// pool pop, bitmap claim, re-enqueue with segment grow) whose order
// fixes every later word, so its time is the length of that chain in
// dependent global-memory round trips.
//
// Design: one thread block per transaction.  Work with no order
// dependence runs block-wide: size class per lane (__clz), per-class
// ranks by block scan into a rank->lane table in shared memory, free's
// bit clears (atomics commute, so the result equals the reference's
// scatter-add), the ascending revived-chunk list (a shared bitset
// compacted by scan), and the telemetry counts.  The ctl block is
// staged in shared memory and written back once.  Heap, bitmap and
// queue words stay in global memory; thread 0 drives the serial chain,
// free's re-enqueue value writes included, in exactly the reference's
// order.  The
// layout comes in as a small struct of ints built once from the
// ArenaLayout, so a transaction makes no host reads.
//
// Semantics kept from the reference, deliberately: pool pops do not
// check the inventory; integer division and modulo floor; gathers out
// of range read a fill value and scatters out of range are dropped,
// after an index in [-n, 0) wraps to i + n; bitmap words change by
// wrapping add and subtract.

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

// ---- telemetry (ctl before -> after, plus per-class lane counts) --------

__device__ void tele_apply(const ArenaDesc& d, const int* s_old, int* s_ctl,
                           const int* d_alloc, const int* d_free,
                           const int* d_fail, int d_walk0) {
  const int C = d.num_classes, capw = d.wrap_capacity, nc = d.num_chunks;
  const int t0 = d.core_ctl_words;
  unsigned* t = reinterpret_cast<unsigned*>(s_ctl);
  for (int c = 0; c < C; ++c) {
    int f0 = s_old[c], f1 = s_ctl[c];
    int b0 = s_old[C + c], b1 = s_ctl[C + c];
    int wrap = (fdiv(f1, capw) - fdiv(f0, capw))
             + (fdiv(b1, capw) - fdiv(b0, capw));
    t[t0 + c] += (unsigned)d_alloc[c];
    t[t0 + C + c] += (unsigned)d_free[c];
    t[t0 + 2 * C + c] += (unsigned)d_fail[c];
    t[t0 + 3 * C + c] += (unsigned)wrap;
  }
  int pf0 = s_old[4 * C], pf1 = s_ctl[4 * C];
  int pb0 = s_old[4 * C + 1], pb1 = s_ctl[4 * C + 1];
  t[t0 + 4 * C] += (unsigned)(pf1 - pf0);
  t[t0 + 4 * C + 1] += (unsigned)(pb1 - pb0);
  t[t0 + 4 * C + 2] += (unsigned)((fdiv(pf1, nc) - fdiv(pf0, nc))
                                  + (fdiv(pb1, nc) - fdiv(pb0, nc)));
  t[t0 + 4 * C + 3] += (unsigned)d_walk0;
}

// ---- alloc ---------------------------------------------------------------

__global__ void alloc_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                                 const int* sizes, const uint8_t* mask,
                                 int n, int* out) {
  __shared__ int s_ctl[MAX_CTL], s_old[MAX_CTL];
  __shared__ int s_count[MAX_CLASSES], s_warp[32];
  __shared__ int s_served[MAX_CLASSES], s_failed[MAX_CLASSES];
  extern __shared__ int table[];  // n: rank -> lane, class-major

  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  for (int i = tid; i < d.ctl_words; i += nt) s_ctl[i] = s_old[i] = ctl[i];
  for (int i = tid; i < C; i += nt) s_served[i] = s_failed[i] = 0;
  for (int i = tid; i < n; i += nt) out[i] = -1;

  // per-class ranks, lanes in order, by block scan
  const int per = (n + nt - 1) / nt;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int start = 0;
  for (int c = 0; c < C; ++c) {
    int local = 0;
    for (int i = lo; i < hi; ++i)
      local += (mask[i] && size_class(d, sizes[i]) == c);
    int total;
    int r = start + block_excl_scan(local, &total, s_warp);
    for (int i = lo; i < hi; ++i)
      if (mask[i] && size_class(d, sizes[i]) == c) table[r++] = i;
    if (tid == 0) s_count[c] = total;
    start += total;
  }
  __syncthreads();

  // the serial chain, class-major, in the reference's order
  if (tid == 0) {
    Chain ch{d, mem, s_ctl};
    unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
    int* free_count = mem + d.free_off;
    int* chunk_class = mem + d.class_off;
    const int nc = d.num_chunks, bw = d.bw;
    int base = 0;
    for (int c = 0; c < C; ++c) {
      const int cnt = s_count[c];
      const int ppc = d.max_ppc >> c, pw = d.min_page_words << c;
      int served = 0;
      while (served < cnt) {
        int chunk;
        if (ch.back(c) - ch.front(c) > 0) {
          chunk = ch.vl_dequeue1(c);
        } else {
          if (ch.pool_back() - ch.pool_front() <= 0) break;  // exhausted
          chunk = ch.pool_pop();
          if (chunk >= 0 && chunk < nc) {
            for (int w = 0; w < bw; ++w) bitmap[chunk * bw + w] = 0u;
            free_count[chunk] = ppc;
            chunk_class[chunk] = c;
          }
        }
        const bool in_range = chunk >= 0 && chunk < nc;
        const int row = clamp_chunk(chunk, nc);
        const int f = free_count[row];
        const int t = min(cnt - served, f);
        int k = 0;
        for (int w = 0; w < bw && k < t; ++w) {
          const int lo_bit = w * 32;
          const int rem = ppc - lo_bit;
          unsigned range = rem >= 32 ? 0xffffffffu
                           : (rem <= 0 ? 0u : ((1u << rem) - 1u));
          unsigned freeb = ~bitmap[row * bw + w] & range;
          unsigned take = 0u;
          while (freeb && k < t) {
            const int b = __ffs(freeb) - 1;
            freeb &= freeb - 1u;
            take |= 1u << b;
            const int page = lo_bit + b;
            out[table[base + served + k]] = chunk * d.wpc + page * pw;
            ++k;
          }
          if (in_range && take) bitmap[chunk * bw + w] += take;
        }
        if (in_range) free_count[chunk] -= k;
        if (free_count[row] > 0) ch.vl_enqueue1(c, chunk);
        served += t;
      }
      base += cnt;
    }
  }
  __syncthreads();

  // telemetry: per-class served / failed lanes
  for (int i = tid; i < n; i += nt) {
    if (!mask[i]) continue;
    const int c = size_class(d, sizes[i]);
    if (c >= C) continue;
    if (out[i] >= 0) atomicAdd(&s_served[c], 1);
    else atomicAdd(&s_failed[c], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int walk0 = 0;
    for (int c = 0; c < C; ++c) walk0 += s_served[c];
    int zero[MAX_CLASSES] = {0};
    tele_apply(d, s_old, s_ctl, s_served, zero, s_failed, walk0);
  }
  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt) ctl[i] = s_ctl[i];
}

// ---- free ----------------------------------------------------------------

__global__ void free_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                                const int* offs, const int* sizes,
                                const uint8_t* mask, int n) {
  __shared__ int s_ctl[MAX_CTL], s_old[MAX_CTL];
  __shared__ int s_count[MAX_CLASSES], s_warp[32], s_freed[MAX_CLASSES];
  __shared__ int s_nnew[MAX_CLASSES], s_rev;
  // dynamic: bitset (ceil(nc/32)) | rev ids (n) | rev class (n) |
  //          rev rank (n) | new segment chunks (C * m)
  extern __shared__ int dyn[];
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int nc = d.num_chunks, wpc = d.wpc, spc = d.spc;
  const int nwords = (nc + 31) / 32;
  const int m = n / spc + 1;
  unsigned* bitset = reinterpret_cast<unsigned*>(dyn);
  int* rev_id = dyn + nwords;
  int* rev_cls = rev_id + n;
  int* rev_rank = rev_cls + n;
  int* newc = rev_rank + n;

  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  const int* chunk_class = mem + d.class_off;

  for (int i = tid; i < d.ctl_words; i += nt) s_ctl[i] = s_old[i] = ctl[i];
  for (int i = tid; i < C; i += nt) s_freed[i] = 0;
  for (int i = tid; i < nwords; i += nt) bitset[i] = 0u;
  for (int i = tid; i < C * m; i += nt) newc[i] = -1;
  __syncthreads();

  // phase A: which touched chunks were full (free counts before any
  // clear), and the freed-lane telemetry
  for (int i = tid; i < n; i += nt) {
    const int c = size_class(d, sizes[i]);
    if (!mask[i] || c >= C || offs[i] < 0) continue;
    atomicAdd(&s_freed[c], 1);
    const int chunk = fdiv(offs[i], wpc);
    if (chunk < nc && free_count[chunk] == 0)
      atomicOr(&bitset[chunk >> 5], 1u << (chunk & 31));
  }
  __syncthreads();

  // phase B: clear the bits (wrapping subtract) and return the pages
  for (int i = tid; i < n; i += nt) {
    const int c = size_class(d, sizes[i]);
    if (!mask[i] || c >= C || offs[i] < 0) continue;
    const int chunk = fdiv(offs[i], wpc);
    if (chunk >= nc) continue;
    const int pw = d.min_page_words << c;
    const int page = fdiv(fmodi(offs[i], wpc), pw);
    atomicAdd(&free_count[chunk], 1);
    if (page / 32 < d.bw)
      atomicAdd(&bitmap[chunk * d.bw + page / 32], 0u - (1u << (page & 31)));
  }

  // revived chunks in ascending id order: compact the bitset by scan
  {
    const int per = (nwords + nt - 1) / nt;
    const int lo = min(nwords, tid * per), hi = min(nwords, lo + per);
    int local = 0;
    for (int w = lo; w < hi; ++w) local += __popc(bitset[w]);
    int total;
    int pos = block_excl_scan(local, &total, s_warp);
    for (int w = lo; w < hi; ++w) {
      unsigned bits = bitset[w];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        const int id = w * 32 + b;
        rev_id[pos] = id;
        rev_cls[pos] = chunk_class[id];
        ++pos;
      }
    }
    if (tid == 0) s_rev = total;
  }
  __syncthreads();
  const int R = s_rev;

  // per-class ranks of the revived list (a class outside [0, C) ranks in
  // class cls mod C without being counted, as the reference's one-hot)
  {
    const int per = (R + nt - 1) / nt;
    const int lo = min(R, tid * per), hi = min(R, lo + per);
    for (int c = 0; c < C; ++c) {
      int local = 0;
      for (int j = lo; j < hi; ++j) local += (rev_cls[j] == c);
      int total;
      int r = block_excl_scan(local, &total, s_warp);
      for (int j = lo; j < hi; ++j) {
        if (fmodi(rev_cls[j], C) == c) rev_rank[j] = r;
        if (rev_cls[j] == c) ++r;
      }
      if (tid == 0) s_count[c] = total;
    }
  }
  __syncthreads();

  // grow: pop new segments class-major, terminate them, link them
  if (tid == 0) {
    Chain ch{d, mem, s_ctl};
    const int W = d.total_words;
    for (int c = 0; c < C; ++c) {
      const int b = ch.back(c);
      s_nnew[c] = fdiv(b + s_count[c], spc) - fdiv(b, spc);
      for (int j = 0; j < s_nnew[c]; ++j) newc[c * m + j] = ch.pool_pop();
    }
    for (int c = 0; c < C; ++c)
      for (int j = 0; j < s_nnew[c]; ++j)
        heap_set(mem, (long long)newc[c * m + j] * wpc, W, -1);
    for (int j = 0; j < m; ++j)
      for (int c = 0; c < C; ++c)
        if (j < s_nnew[c]) {
          const int prev = j == 0 ? ch.tail(c) : newc[c * m + j - 1];
          heap_set(mem, (long long)prev * wpc, W, newc[c * m + j]);
        }
    // values: lane j of the revived list goes to slot back + rank.  Two
    // lanes may share a word (pops from an exhausted pool repeat a
    // chunk; a class outside [0, C) shares a rank), which the
    // reference's scatter resolves by lane order, so they are written
    // in that order.
    for (int j = 0; j < R; ++j) {
      const int cm = fmodi(rev_cls[j], C);
      const int b = s_old[C + cm], tl = s_old[3 * C + cm];
      const int v = b + rev_rank[j];
      const int seg_rel = fdiv(v, spc) - fdiv(b, spc);
      int seg_chunk;
      if (seg_rel == 0) {
        seg_chunk = tl;
      } else {
        long long col = wrapi(seg_rel - 1, m);
        seg_chunk = (col >= 0 && col < m) ? newc[cm * m + col] : 0;
      }
      heap_set(mem, (long long)seg_chunk * wpc + 1 + fmodi(v, spc), W,
               rev_id[j]);
    }
    for (int c = 0; c < C; ++c) {
      if (s_nnew[c] > 0) s_ctl[3 * C + c] = newc[c * m + s_nnew[c] - 1];
      s_ctl[C + c] += s_count[c];
    }
    int zero[MAX_CLASSES] = {0};
    tele_apply(d, s_old, s_ctl, zero, s_freed, zero, 0);
  }
  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt) ctl[i] = s_ctl[i];
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

static int block_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

static int launch_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" size_t alloc_txn_smem_bytes(ArenaDesc d, int n) {
  (void)d;
  return (size_t)n * sizeof(int);
}

extern "C" size_t free_txn_smem_bytes(ArenaDesc d, int n) {
  const int nwords = (d.num_chunks + 31) / 32;
  const int m = n / d.spc + 1;
  return ((size_t)nwords + 3 * (size_t)n + (size_t)d.num_classes * m)
         * sizeof(int);
}

extern "C" int alloc_txn_launch(ArenaDesc d, int* mem, int* ctl,
                                const int* sizes, const uint8_t* mask, int n,
                                int* out, void* stream) {
  const size_t smem = alloc_txn_smem_bytes(d, n);
  int err = launch_smem((const void*)alloc_txn_kernel, smem);
  if (err) return err;
  alloc_txn_kernel<<<1, block_threads(n), smem, (cudaStream_t)stream>>>(
      d, mem, ctl, sizes, mask, n, out);
  return (int)cudaGetLastError();
}

extern "C" int free_txn_launch(ArenaDesc d, int* mem, int* ctl,
                               const int* offs, const int* sizes,
                               const uint8_t* mask, int n, void* stream) {
  const size_t smem = free_txn_smem_bytes(d, n);
  int err = launch_smem((const void*)free_txn_kernel, smem);
  if (err) return err;
  free_txn_kernel<<<1, block_threads(n), smem, (cudaStream_t)stream>>>(
      d, mem, ctl, offs, sizes, mask, n);
  return (int)cudaGetLastError();
}
