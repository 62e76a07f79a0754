// One defragmentation migration wave on the device-resident arena, for
// the chunk kinds over every queue family (chunk, va_chunk, vl_chunk):
// one kernel launch per wave, in place on mem/ctl, with no host reads (a
// later tick can capture it in a CUDA graph) — on a single arena
// (defrag_txn) or on a sharded one (sharded_defrag_txn).  Page kinds bind
// no chunks: their plans are empty and their waves launch nothing.
//
// Replaces: src/repro/kernels/defrag_txn.py::arena_defrag_txn (and its
// region-blocked twin arena_defrag_txn_blocked), whose body is
// core/defrag.py::migrate_math; and ::sharded_arena_defrag_txn (and
// sharded_arena_defrag_txn_blocked), whose body is
// core/defrag.py::sharded_migrate_math.  The plain versions are the
// functions of the same names in src/repro_torch/core/defrag.py; each
// pair must leave every mem/ctl word identical.  The plan (src, dst,
// sizes) is computed before the launch (defrag.plan_math,
// sharded_plan_math or shards.rebalance_plan_math), which guarantees
// that source extents and destination slots are disjoint: a direct
// copy then equals the reference's extract-into-a-carry-buffer-then-
// insert.
//
// What bounds it on the H100: latency, not bandwidth.  A wave moves at
// most M extents of a few hundred bytes, but the queue rebuild is a
// chain of dependent pool pops and segment links whose order fixes
// every later word, and thread 0 writes one queue value per live chunk.
//
// Design: one thread block of 1024 threads (__launch_bounds__ keeps each
// kernel within the 64 registers a thread that this allows).  Block-wide,
// in the reference's order and with barriers between the stages: (1) copy
// the extents' words and clear the source bits / return their pages
// (atomics commute, as in free_txn); then, on the arena: (2) claim
// destination chunks that are still unbound (a bitset; the per-lane
// bindings on thread 0 in lane order, so a repeated chunk's last lane
// wins as in the reference's scatter); (3) set the destination bits; (4)
// unbind fully-free chunks, parallel over chunks; (5) rebuild the whole
// pool ring (unbound ids at ranks from a block scan, NULL elsewhere),
// NULL the whole queue region (the ring's (C, cap) store, or the va/vl
// directory), and compact each class's live chunks into an ascending
// list by block scans.  Then (6) the class queues, class-major, exactly
// as the reference rebuilds them: a ring takes each class's list at slots
// 0..k-1, written in parallel (the slots are distinct); a virtualized
// queue has thread 0 pop one fresh segment per class (vl: its word 0 set
// NULL; va: entered at directory slot 0), head = tail = it, then one bulk
// enqueue of the class's live chunks (grow pops, then vl's NULL words and
// links or va's directory slots, then the values).  The ctl block is
// staged in shared memory; only its core words are written back, so the
// telemetry words pass through.  The per-chunk
// tables (chunk state, claimed bitset, live lists, new segments) live in
// dynamic shared memory when they fit, else in a device workspace the
// wrapper allocates (`ws`, null for shared memory), through the same
// body (one kernel instance per address space, so the shared-memory
// case keeps shared-memory addressing), so a wave takes an arena of any
// chunk count.
//
// Sharded arenas (mem (S, Mw), ctl (S, Cw); global offset = s * Ws +
// local): a rebuild pops fresh segments from the rebuilt pool and
// writes segment words into the heap, possibly into a chunk that this
// wave's extraction just emptied on a donor shard whose pages a
// rebalance moves elsewhere.  So stage (1) runs first for every lane of
// every shard (each source read, and each destination written, before
// any shard's rebuild writes), and then stages (2)-(6) run for each
// shard in shard order, with the lanes whose destination it owns.
// Every shard is rebuilt, with or without moves, as the reference's
// insert_rebuild_math is.  A single arena is the case S = 1.

#include "arena_dev.cuh"

// Lane i moves iff src >= 0, dst >= 0 and its size has a class.
__device__ __forceinline__ bool move_lane(const ArenaDesc& d, const int* src,
                                          const int* dst, const int* sizes,
                                          int i, int* cls) {
  if (src[i] < 0 || dst[i] < 0) return false;
  *cls = size_class(d, sizes[i]);
  return *cls < d.num_classes;
}

struct WaveShared {
  int ctl[MAX_CTL], warp[32];
  int base[MAX_CLASSES], cnt[MAX_CLASSES];
};

// 1. extract + insert over every shard: copy each extent's words from
// its source shard to its destination shard, clear its source bits and
// return its page to the source chunk's free count.  An offset's shard
// is offset / Ws; a source outside [0, S) shards reads zeros, a
// destination outside them is dropped, as the reference's gather fill
// and scatter drop.
__device__ void wave_extract(const ArenaDesc& d, int* mem, int S,
                             long long Mw, const int* src, const int* dst,
                             const int* sizes, int M) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int wpc = d.wpc, Ws = d.total_words, bw = d.bw;
  const long long n_copy = (long long)M * wpc;
  for (long long k = tid; k < n_copy; k += nt) {
    const int i = (int)(k / wpc), j = (int)(k % wpc);
    int c;
    if (!move_lane(d, src, dst, sizes, i, &c) || j >= (d.min_page_words << c))
      continue;
    const int ss = fdiv(src[i], Ws), ds = fdiv(dst[i], Ws);
    if (ds >= S) continue;
    const int v = ss < S ? heap_get(mem + ss * Mw,
                                    (long long)(src[i] - ss * Ws) + j, Ws, 0)
                         : 0;
    heap_set(mem + ds * Mw, (long long)(dst[i] - ds * Ws) + j, Ws, v);
  }
  for (int i = tid; i < M; i += nt) {
    int c;
    if (!move_lane(d, src, dst, sizes, i, &c)) continue;
    const int ss = fdiv(src[i], Ws);
    if (ss >= S) continue;
    int* m = mem + ss * Mw;
    const int local = src[i] - ss * Ws;
    const int pw = d.min_page_words << c;
    const int chunk = fdiv(local, wpc), page = fdiv(fmodi(local, wpc), pw);
    atomicAdd(&m[d.free_off + chunk], 1);
    if (page / 32 < bw)
      atomicAdd(reinterpret_cast<unsigned*>(m + d.bitmap_off) + chunk * bw
                    + page / 32,
                0u - (1u << (page & 31)));
  }
}

// 2.-6. on one arena (mem, ctl: shard s's rows), for the lanes whose
// destination shard is s.  dyn: defrag_txn_table_bytes of shared or
// global memory.
__device__ __forceinline__ void wave_insert_rebuild(
    const ArenaDesc& d, int* mem, int* ctl, int s, const int* src,
    const int* dst, const int* sizes, int M, WaveShared& sh, int* dyn) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int nc = d.num_chunks, wpc = d.wpc, bw = d.bw, spc = d.spc;
  const int W = d.total_words, nwords = (nc + 31) / 32;
  // tables: chunk state (nc) | claimed bitset (ceil(nc/32)) |
  //          live lists, class-major (nc) | new segment chunks (nc/spc+2)
  int* s_state = dyn;
  unsigned* claimed = reinterpret_cast<unsigned*>(dyn + nc);
  int* live = dyn + nc + nwords;
  int* newc = live + nc;

  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  int* chunk_class = mem + d.class_off;

  // lane i's local destination on this shard, or -1
  auto dst_here = [&](int i, int* c) -> int {
    if (!move_lane(d, src, dst, sizes, i, c) || fdiv(dst[i], W) != s)
      return -1;
    return dst[i] - s * W;
  };

  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt) sh.ctl[i] = ctl[i];
  for (int i = tid; i < nwords; i += nt) claimed[i] = 0u;
  __syncthreads();

  // 2. claim destination chunks that are still unbound: bitmap reset,
  // full free count, bound to the move's class
  for (int i = tid; i < M; i += nt) {
    int c;
    const int off = dst_here(i, &c);
    if (off < 0) continue;
    const int chunk = fdiv(off, wpc);
    if (chunk_class[chunk] < 0)
      atomicOr(&claimed[chunk >> 5], 1u << (chunk & 31));
  }
  __syncthreads();
  for (int ch = tid; ch < nc; ch += nt)
    if (claimed[ch >> 5] >> (ch & 31) & 1u)
      for (int w = 0; w < bw; ++w) bitmap[ch * bw + w] = 0u;
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < M; ++i) {
      int c;
      const int off = dst_here(i, &c);
      if (off < 0) continue;
      const int chunk = fdiv(off, wpc);
      if (claimed[chunk >> 5] >> (chunk & 31) & 1u) {
        free_count[chunk] = d.max_ppc >> c;
        chunk_class[chunk] = c;
      }
    }
  }
  __syncthreads();

  // 3. set the destination bits and take the pages from the free counts
  for (int i = tid; i < M; i += nt) {
    int c;
    const int off = dst_here(i, &c);
    if (off < 0) continue;
    const int pw = d.min_page_words << c;
    const int chunk = fdiv(off, wpc), page = fdiv(fmodi(off, wpc), pw);
    atomicAdd(&free_count[chunk], -1);
    if (page / 32 < bw)
      atomicAdd(&bitmap[chunk * bw + page / 32], 1u << (page & 31));
  }
  __syncthreads();

  // 4. unbind fully-free chunks; state: -1 unbound, class if it has free
  // pages (it goes back into its class queue), -2 bound and full
  for (int ch = tid; ch < nc; ch += nt) {
    int cc = chunk_class[ch];
    const int f = free_count[ch];
    const int full = d.max_ppc >> (cc < 0 ? 0 : (cc >= C ? C - 1 : cc));
    if (cc >= 0 && f == full) {
      cc = -1;
      chunk_class[ch] = -1;
    }
    s_state[ch] = cc < 0 ? -1 : (f > 0 ? cc : -2);
  }
  __syncthreads();

  // 5. a fresh pool ring: every unbound id in ascending order, NULL
  // after them; a NULL queue region (ring store or directory); the live
  // lists per class
  {
    const int per = (nc + nt - 1) / nt;
    const int lo = min(nc, tid * per), hi = min(nc, lo + per);
    int local = 0;
    for (int ch = lo; ch < hi; ++ch) local += s_state[ch] == -1;
    int total;
    int pos = block_excl_scan(local, &total, sh.warp);
    for (int ch = lo; ch < hi; ++ch)
      if (s_state[ch] == -1) mem[d.pool_off + pos++] = ch;
    for (int k = total + tid; k < nc; k += nt) mem[d.pool_off + k] = -1;
    if (tid == 0) {
      sh.ctl[4 * C] = 0;          // pool front
      sh.ctl[4 * C + 1] = total;  // pool back
    }
    const int qwords = C * (d.family == FAM_RING ? d.queue_cap : d.max_segs);
    for (int k = tid; k < qwords; k += nt) mem[d.queue_off + k] = -1;
    int start = 0;
    for (int c = 0; c < C; ++c) {
      int n = 0;
      for (int ch = lo; ch < hi; ++ch) n += s_state[ch] == c;
      int cnt;
      int r = start + block_excl_scan(n, &cnt, sh.warp);
      for (int ch = lo; ch < hi; ++ch)
        if (s_state[ch] == c) live[r++] = ch;
      if (tid == 0) {
        sh.base[c] = start;
        sh.cnt[c] = cnt;
      }
      start += cnt;
    }
  }
  __syncthreads();

  // 6. class-major queue rebuild, in the reference's order
  if (d.family == FAM_RING) {
    for (int c = 0; c < C; ++c)
      for (int r = tid; r < sh.cnt[c]; r += nt)
        mem[d.queue_off + c * d.queue_cap + fmodi(r, d.queue_cap)] =
            live[sh.base[c] + r];
    if (tid == 0)
      for (int c = 0; c < C; ++c) {
        sh.ctl[c] = 0;               // front
        sh.ctl[C + c] = sh.cnt[c];   // back
      }
  } else if (tid == 0) {
    Chain q{d, mem, sh.ctl};
    for (int c = 0; c < C; ++c) {
      q.front(c) = q.back(c) = 0;
      q.head(c) = q.tail(c) = -1;
    }
    for (int c = 0; c < C; ++c) {
      const int seg0 = q.pool_pop();
      if (d.family == FAM_VL) {
        const long long w0 = (long long)seg0 * wpc;
        if (w0 >= 0 && w0 < W) mem[w0] = -1;
      } else {
        q.dir(c, 0) = seg0;
      }
      q.head(c) = q.tail(c) = seg0;
      // one bulk enqueue of the class's live chunks (back = 0)
      const int L = sh.cnt[c];
      const int* ids = live + sh.base[c];
      const int n_new = fdiv(L, spc);
      for (int j = 0; j < n_new; ++j) newc[j] = q.pool_pop();
      if (d.family == FAM_VL) {
        for (int j = 0; j < n_new; ++j)
          heap_set(mem, seg_word(newc[j], wpc, 0), W, -1);
        for (int j = 0; j < n_new; ++j)
          heap_set(mem, seg_word(j == 0 ? seg0 : newc[j - 1], wpc, 0), W,
                   newc[j]);
        for (int r = 0; r < L; ++r) {
          const int sg = r / spc;
          const int seg = sg == 0 ? seg0 : newc[sg - 1];
          heap_set(mem, seg_word(seg, wpc, 1 + r % spc), W, ids[r]);
        }
        if (n_new > 0) q.tail(c) = newc[n_new - 1];
      } else {
        for (int j = 0; j < n_new; ++j) q.dir(c, 1 + j) = newc[j];
        for (int r = 0; r < L; ++r)
          heap_set(mem, seg_word(q.dir(c, r / spc), wpc, r % spc), W,
                   ids[r]);
      }
      q.back(c) = L;
    }
  }
  __syncthreads();
  for (int i = tid; i < d.core_ctl_words; i += nt) ctl[i] = sh.ctl[i];
}

// One instance per home of the per-chunk tables: kWs puts them in the
// device workspace ws, else in dynamic shared memory (the same body; the
// shared-memory instance keeps shared-memory addressing and carries no
// code of the other).
template <bool kWs>
__global__ void __launch_bounds__(1024)
defrag_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                  const int* src, const int* dst,
                  const int* sizes, int M, int* ws) {
  __shared__ WaveShared sh;
  extern __shared__ int dyn[];
  wave_extract(d, mem, 1, 0, src, dst, sizes, M);
  wave_insert_rebuild(d, mem, ctl, 0, src, dst, sizes, M, sh,
                      kWs ? ws : dyn);
}

// mem/ctl (S, Mw) / (S, Cw) row-major; src/dst GLOBAL offsets.
template <bool kWs>
__global__ void __launch_bounds__(1024)
sharded_defrag_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                          int S, int Mw, int Cw,
                          const int* src, const int* dst,
                          const int* sizes, int M,
                          int* ws) {
  __shared__ WaveShared sh;
  extern __shared__ int dyn[];
  wave_extract(d, mem, S, Mw, src, dst, sizes, M);
  for (int s = 0; s < S; ++s) {
    int* m = mem + (long long)s * Mw;
    int* c = ctl + (long long)s * Cw;
    wave_insert_rebuild(d, m, c, s, src, dst, sizes, M, sh, kWs ? ws : dyn);
  }
}

// ---- launch geometry (also used by the emulation harness) -------------
//
// defrag_txn_table_bytes: the bytes of a wave's per-chunk tables.
// defrag_txn_workspace_bytes: 0 when they fit in smem_limit bytes of
// dynamic shared memory, else the bytes of device workspace the caller
// passes as ws (a launch with ws uses no dynamic shared memory).

extern "C" size_t defrag_txn_table_bytes(ArenaDesc d) {
  const size_t nwords = (d.num_chunks + 31) / 32;
  return (2 * (size_t)d.num_chunks + nwords + d.num_chunks / d.spc + 2)
         * sizeof(int);
}

extern "C" size_t defrag_txn_workspace_bytes(ArenaDesc d,
                                             size_t smem_limit) {
  const size_t t = defrag_txn_table_bytes(d);
  return t <= smem_limit ? 0 : t;
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

static int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" int defrag_txn_launch(ArenaDesc d, int* mem, int* ctl,
                                 const int* src, const int* dst,
                                 const int* sizes, int M, int* ws,
                                 void* stream) {
  const size_t smem = ws ? 0 : defrag_txn_table_bytes(d);
  const auto k = ws ? defrag_txn_kernel<true> : defrag_txn_kernel<false>;
  int err = set_smem((const void*)k, smem);
  if (err) return err;
  k<<<1, 1024, smem, (cudaStream_t)stream>>>(
      d, mem, ctl, src, dst, sizes, M, ws);
  return (int)cudaGetLastError();
}

extern "C" int sharded_defrag_txn_launch(ArenaDesc d, int* mem, int* ctl,
                                         int S, int Mw, int Cw,
                                         const int* src, const int* dst,
                                         const int* sizes, int M, int* ws,
                                         void* stream) {
  const size_t smem = ws ? 0 : defrag_txn_table_bytes(d);
  const auto k = ws ? sharded_defrag_txn_kernel<true>
                    : sharded_defrag_txn_kernel<false>;
  int err = set_smem((const void*)k, smem);
  if (err) return err;
  k<<<1, 1024, smem, (cudaStream_t)stream>>>(
      d, mem, ctl, S, Mw, Cw, src, dst, sizes, M, ws);
  return (int)cudaGetLastError();
}
