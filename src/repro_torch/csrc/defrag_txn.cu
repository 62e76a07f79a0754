// One defragmentation migration wave on the device-resident arena, for
// the chunk kinds over every queue family (chunk, va_chunk, vl_chunk):
// two kernel launches per wave, in place on mem/ctl, with no host reads
// (a later tick can capture them in a CUDA graph) — on a single arena
// (defrag_txn) or on a sharded one (sharded_defrag_txn).  Page kinds
// bind no chunks: their plans are empty and their waves launch nothing.
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
// most M extents of a few hundred bytes; the queue rebuild's pool pops
// and segment links form a chain whose order fixes every later word.
//
// Design.  (1) defrag_extract_kernel, a block a lane over the card,
// copies each moving extent's page words (min_page_words << c of them)
// from its source shard to its destination shard and returns its
// source page (atomics commute, as in free_txn); its launch boundary
// puts every source read and destination write before any rebuild.
// (2)-(6) one block of 1024 threads per arena (__launch_bounds__ keeps
// each kernel within the 64 registers a thread that this allows), block
// s rebuilding shard s with the lanes whose destination it owns, in
// the reference's order with barriers between the stages: (2) claim
// destination chunks that are still unbound (a bitset; the last lane
// to land in a chunk binds it, by a per-chunk atomicMax of the lane
// index, as the reference's scatter resolves repeated indices); (3) set
// the destination bits; (4) unbind fully-free chunks, parallel over
// chunks; (5) rebuild the whole pool ring (unbound ids at ranks from a
// block scan, NULL elsewhere), NULL the whole queue region (the ring's
// (C, cap) store, or the va/vl directory), and rank each class's live
// chunks into ascending class-major lists in one pass (rank_lanes: per
// warp class counts, one scan for every class).  Then (6) the class
// queues, class-major, exactly as the reference rebuilds them: a ring
// takes each class's list at slots 0..k-1, written in parallel (the
// slots are distinct); a virtualized queue has thread 0 pop one fresh
// segment per class (vl: its word 0 set NULL; va: entered at directory
// slot 0), head = tail = it, then the grow pops and vl's NULL words and
// links or va's directory slots, recording each class's segments, and
// the block writes the live chunks' values at their (segment, slot) in
// parallel while the rebuilt pool holds every pop (distinct in-heap
// chunks), else thread 0 writes them in order (a dry pool's NULL
// segments wrap into the last chunk).  Device counters
// (defrag_txn_rebuild_stats) count the rebuilds and values of each path.
// The ctl block is staged in shared memory; only its core words are
// written back, so the telemetry words pass through.  The per-chunk
// tables (chunk state, claimed bitset, live lists, segments) live in
// dynamic shared memory when they fit, else in a device workspace the
// wrapper allocates (`ws`, null for shared memory; one table set per
// block), through the same body (one kernel instance per address
// space, so the shared-memory case keeps shared-memory addressing), so
// a wave takes an arena of any chunk count.
//
// Sharded arenas (mem (S, Mw), ctl (S, Cw); global offset = s * Ws +
// local): a rebuild pops fresh segments from the rebuilt pool and
// writes segment words into the heap, possibly into a chunk that this
// wave's extraction just emptied on a donor shard whose pages a
// rebalance moves elsewhere.  So the extraction runs first for every
// lane of every shard, and then each shard's rebuild, with the lanes
// whose destination it owns; after the extraction the rebuilds touch
// only their own shard's rows, so they run side by side.  Every shard
// is rebuilt, with or without moves, as the reference's
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
  int base[MAX_CLASSES], cnt[MAX_CLASSES], segb[MAX_CLASSES];
  int tab[kClassTab];  // rank_lanes' class scan
  int serial;
};

static_assert(sizeof(WaveShared) <= kStaticSmemBytes,
              "wave kernels' static shared memory");

// What the queue rebuilds of every wave (single or sharded: one per
// arena) since the last reset did, summed over launches: thread 0 adds
// its rebuild's counts, and defrag_txn_rebuild_stats reads and clears
// them.
enum WaveStat {
  WS_PAR_REBUILDS,  // rebuilds whose queue values the block wrote in parallel
  WS_PAR_VALUES,    // the values they wrote
  WS_SER_REBUILDS,  // rebuilds thread 0 wrote in order (the pool ran dry)
  WS_SER_VALUES,    // the values it wrote
  kWaveStats
};
__device__ unsigned long long g_wave_stats[kWaveStats];

// Each kernel's launches since the last reset (count_launch), read and
// cleared by defrag_txn_launch_stats: a wave's kernels as they ran.
enum WaveLaunch {
  LS_DEFRAG_EXTRACT,
  LS_DEFRAG_TXN,
  LS_SHARDED_DEFRAG_TXN,
  kWaveLaunches
};
__device__ unsigned long long g_wave_launches[kWaveLaunches];

// 1. extract + insert over every shard, a block a lane (a grid stride
// over the lanes): copy the extent's min_page_words << c words from its
// source shard to its destination shard, then clear its source bit and
// return its page to the source chunk's free count (atomics commute).
// An offset's shard is offset / Ws; a source outside [0, S) shards reads
// zeros, a destination outside them is dropped, as the reference's
// gather fill and scatter drop.  Its own launch, so every source is read
// and every destination written before any rebuild writes.
constexpr int kExtractThreads = 128;
constexpr int kExtractMaxBlocks = 1056;  // 8 blocks on each of 132 SMs

__global__ void __launch_bounds__(kExtractThreads)
defrag_extract_kernel(ArenaDesc d, int* mem, int S, long long Mw,
                      const int* src, const int* dst, const int* sizes,
                      int M) {
  const int Ws = d.total_words, wpc = d.wpc, bw = d.bw;
  count_launch(g_wave_launches, LS_DEFRAG_EXTRACT);
  for (int i = blockIdx.x; i < M; i += gridDim.x) {
    int c;
    if (!move_lane(d, src, dst, sizes, i, &c)) continue;  // uniform
    const int pw = d.min_page_words << c;
    const int ss = fdiv(src[i], Ws), ds = fdiv(dst[i], Ws);
    if (ds < S)
      for (int j = threadIdx.x; j < pw; j += blockDim.x) {
        const int v = ss < S ? heap_get(mem + ss * Mw,
                                        (long long)(src[i] - ss * Ws) + j,
                                        Ws, 0)
                             : 0;
        heap_set(mem + ds * Mw, (long long)(dst[i] - ds * Ws) + j, Ws, v);
      }
    if (threadIdx.x == 0 && ss < S) {
      int* m = mem + ss * Mw;
      const int local = src[i] - ss * Ws;
      const int chunk = fdiv(local, wpc), page = fdiv(fmodi(local, wpc), pw);
      atomicAdd(&m[d.free_off + chunk], 1);
      if (page / 32 < bw)
        atomicAdd(reinterpret_cast<unsigned*>(m + d.bitmap_off) + chunk * bw
                      + page / 32,
                  0u - (1u << (page & 31)));
    }
  }
}

// The per-chunk tables of one rebuild: chunk state (nc) | claimed bitset
// (ceil(nc/32)) | live lists, class-major (nc) | the queue segments each
// class takes, class-major (C + nc/spc + 1).
__host__ __device__ inline size_t wave_table_ints(const ArenaDesc& d) {
  return 2 * (size_t)d.num_chunks + (d.num_chunks + 31) / 32
         + (size_t)d.num_classes + d.num_chunks / d.spc + 1;
}

// 2.-6. on one arena (mem, ctl: shard s's rows), for the lanes whose
// destination shard is s.  dyn: wave_table_ints of shared or global
// memory.
__device__ __forceinline__ void wave_insert_rebuild(
    const ArenaDesc& d, int* mem, int* ctl, int s, const int* src,
    const int* dst, const int* sizes, int M, WaveShared& sh, int* dyn) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int nc = d.num_chunks, wpc = d.wpc, bw = d.bw, spc = d.spc;
  const int W = d.total_words, nwords = (nc + 31) / 32;
  int* s_state = dyn;
  unsigned* claimed = reinterpret_cast<unsigned*>(dyn + nc);
  int* live = dyn + nc + nwords;
  int* segs = live + nc;

  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  int* chunk_class = mem + d.class_off;

  // lane i's local destination on this shard, or -1
  auto dst_here = [&](int i, int* c) -> int {
    if (!move_lane(d, src, dst, sizes, i, c) || fdiv(dst[i], W) != s)
      return -1;
    return dst[i] - s * W;
  };
  auto is_claimed = [&](int chunk) {
    return (claimed[chunk >> 5] >> (chunk & 31)) & 1u;
  };

  for (int i = tid; i < d.ctl_words; i += nt) sh.ctl[i] = ctl[i];
  for (int i = tid; i < nwords; i += nt) claimed[i] = 0u;
  for (int ch = tid; ch < nc; ch += nt) s_state[ch] = -1;
  __syncthreads();

  // 2. claim destination chunks that are still unbound: bitmap reset,
  // full free count, bound to the move's class.  Several lanes may land
  // in one chunk: the last one's class wins, as in the reference's
  // scatter (the highest lane index, by atomicMax in s_state).
  for (int i = tid; i < M; i += nt) {
    int c;
    const int off = dst_here(i, &c);
    if (off < 0) continue;
    const int chunk = fdiv(off, wpc);
    if (chunk_class[chunk] < 0) {
      atomicOr(&claimed[chunk >> 5], 1u << (chunk & 31));
      atomicMax(&s_state[chunk], i);
    }
  }
  __syncthreads();
  for (int ch = tid; ch < nc; ch += nt)
    if (is_claimed(ch))
      for (int w = 0; w < bw; ++w) bitmap[ch * bw + w] = 0u;
  for (int i = tid; i < M; i += nt) {
    int c;
    const int off = dst_here(i, &c);
    if (off < 0) continue;
    const int chunk = fdiv(off, wpc);
    if (is_claimed(chunk) && s_state[chunk] == i) {
      free_count[chunk] = d.max_ppc >> c;
      chunk_class[chunk] = c;
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
  // lists, class-major, ascending within a class, every class's counts
  // from one ranking pass (rank_lanes)
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
    auto cls_of = [&](int ch) {  // a class outside [0, C) is in no list
      const int v = s_state[ch];
      return v >= 0 && v < C ? v : -1;
    };
    rank_lanes(nc, C, cls_of, [&](int ch, int c, int r) {
      if (c >= 0) live[r] = ch;
    }, sh.cnt, sh.base, sh.tab);
  }
  __syncthreads();

  // 6. class-major queue rebuild, in the reference's order
  int values = 0;
  for (int c = 0; c < C; ++c) values += sh.cnt[c];
  if (d.family == FAM_RING) {
    for (int c = 0; c < C; ++c)
      for (int r = tid; r < sh.cnt[c]; r += nt)
        mem[d.queue_off + c * d.queue_cap + fmodi(r, d.queue_cap)] =
            live[sh.base[c] + r];
    if (tid == 0) {
      for (int c = 0; c < C; ++c) {
        sh.ctl[c] = 0;               // front
        sh.ctl[C + c] = sh.cnt[c];   // back
      }
      atomicAdd(&g_wave_stats[WS_PAR_REBUILDS], 1ull);
      atomicAdd(&g_wave_stats[WS_PAR_VALUES], (unsigned long long)values);
    }
  } else {
    // a virtualized queue: per class one fresh segment (vl: its word 0
    // NULL; va: directory slot 0), head = tail = it, then one bulk
    // enqueue of the class's live chunks (back = 0: grow pops, vl's NULL
    // words and links or va's directory slots, then the values).  When
    // the rebuilt pool holds every pop, the pops are distinct in-heap
    // chunks (ascending unbound ids), so no two values share a word (a va
    // class's 1 + L / spc segments fit its directory's max_segs = nc /
    // spc + 2 slots without wrapping): thread 0 takes the pops and links,
    // recording each class's segments, and the block writes the values at
    // their (segment, slot).  Else pops past the pool's inventory hand
    // out NULL segments whose writes wrap into the last chunk, and thread
    // 0 writes everything in the reference's order.
    if (tid == 0) {
      Chain q{d, mem, sh.ctl};
      int pops = 0;
      for (int c = 0; c < C; ++c) pops += 1 + fdiv(sh.cnt[c], spc);
      sh.serial = pops > q.pool_count();
      for (int c = 0; c < C; ++c) {
        q.front(c) = q.back(c) = 0;
        q.head(c) = q.tail(c) = -1;
      }
      int sb = 0;
      for (int c = 0; c < C; ++c) {
        const int seg0 = q.pool_pop();
        if (d.family == FAM_VL) {
          const long long w0 = (long long)seg0 * wpc;
          if (w0 >= 0 && w0 < W) mem[w0] = -1;
        } else {
          q.dir(c, 0) = seg0;
        }
        q.head(c) = q.tail(c) = seg0;
        const int L = sh.cnt[c];
        const int* ids = live + sh.base[c];
        const int n_new = fdiv(L, spc);
        int* newc = segs + sb + 1;
        segs[sb] = seg0;
        sh.segb[c] = sb;
        for (int j = 0; j < n_new; ++j) newc[j] = q.pool_pop();
        if (d.family == FAM_VL) {
          for (int j = 0; j < n_new; ++j)
            heap_set(mem, seg_word(newc[j], wpc, 0), W, -1);
          for (int j = 0; j < n_new; ++j)
            heap_set(mem, seg_word(j == 0 ? seg0 : newc[j - 1], wpc, 0), W,
                     newc[j]);
          if (sh.serial)  // segment-major: value r at (r / spc, r % spc)
            for (int sg = 0, r = 0; r < L; ++sg) {
              const int seg = sg == 0 ? seg0 : newc[sg - 1];
              for (int k = 0; k < spc && r < L; ++k, ++r)
                heap_set(mem, seg_word(seg, wpc, 1 + k), W, ids[r]);
            }
          if (n_new > 0) q.tail(c) = newc[n_new - 1];
        } else {
          for (int j = 0; j < n_new; ++j) q.dir(c, 1 + j) = newc[j];
          if (sh.serial)  // the directory lies outside the heap words
            for (int sg = 0, r = 0; r < L; ++sg) {
              const int seg = q.dir(c, sg);
              for (int k = 0; k < spc && r < L; ++k, ++r)
                heap_set(mem, seg_word(seg, wpc, k), W, ids[r]);
            }
        }
        q.back(c) = L;
        // the dry path reuses one class's segment slots: nothing reads them
        if (!sh.serial) sb += 1 + n_new;
      }
      const int k = sh.serial ? WS_SER_REBUILDS : WS_PAR_REBUILDS;
      atomicAdd(&g_wave_stats[k], 1ull);
      atomicAdd(&g_wave_stats[k + 1], (unsigned long long)values);
    }
    __syncthreads();
    if (!sh.serial) {  // uniform
      const int slot0 = d.family == FAM_VL ? 1 : 0;
      for (int c = 0; c < C; ++c) {
        const int* ids = live + sh.base[c];
        const int* seg = segs + sh.segb[c];
        for (int r = tid; r < sh.cnt[c]; r += nt)
          heap_set(mem, seg_word(seg[r / spc], wpc, slot0 + r % spc), W,
                   ids[r]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < d.core_ctl_words; i += nt) ctl[i] = sh.ctl[i];
}

// One instance per home of the per-chunk tables: kWs puts them in the
// device workspace ws, else in dynamic shared memory (the same body; the
// shared-memory instance keeps shared-memory addressing and carries no
// code of the other).  The extents moved first (defrag_extract_kernel).
template <bool kWs>
__global__ void __launch_bounds__(1024)
defrag_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                  const int* src, const int* dst,
                  const int* sizes, int M, int* ws) {
  __shared__ WaveShared sh;
  extern __shared__ int dyn[];
  count_launch(g_wave_launches, LS_DEFRAG_TXN);
  wave_insert_rebuild(d, mem, ctl, 0, src, dst, sizes, M, sh,
                      kWs ? ws : dyn);
}

// One block per shard: block s rebuilds shard s with the lanes whose
// destination it owns; a workspace holds one table set per block
// (ws_ints ints each).  mem/ctl (S, Mw) / (S, Cw) row-major; src/dst
// GLOBAL offsets.  The extents moved first, over every shard
// (defrag_extract_kernel).
template <bool kWs>
__global__ void __launch_bounds__(1024)
sharded_defrag_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                          int Mw, int Cw,
                          const int* src, const int* dst,
                          const int* sizes, int M,
                          int* ws, long long ws_ints) {
  __shared__ WaveShared sh;
  extern __shared__ int dyn[];
  const int s = blockIdx.x;
  count_launch(g_wave_launches, LS_SHARDED_DEFRAG_TXN);
  wave_insert_rebuild(d, mem + (long long)s * Mw, ctl + (long long)s * Cw, s,
                      src, dst, sizes, M, sh, kWs ? ws + s * ws_ints : dyn);
}

// ---- launch geometry (also used by the emulation harness) -------------
//
// defrag_txn_table_bytes: the bytes of one rebuild's per-chunk tables.
// defrag_txn_workspace_bytes: 0 when they fit in smem_limit bytes of
// dynamic shared memory, else the bytes of device workspace the caller
// passes as ws, one table set for each of a wave's S rebuilds (a launch
// with ws uses no dynamic shared memory).
// defrag_extract_blocks: the extract kernel's grid for M lanes (0: no
// launch).

extern "C" size_t defrag_txn_table_bytes(ArenaDesc d) {
  return wave_table_ints(d) * sizeof(int);
}

extern "C" size_t defrag_txn_workspace_bytes(ArenaDesc d, int S,
                                             size_t smem_limit) {
  const size_t t = defrag_txn_table_bytes(d);
  return t <= smem_limit ? 0 : t * (size_t)S;
}

extern "C" int defrag_extract_blocks(int M) {
  return M < kExtractMaxBlocks ? (M > 0 ? M : 0) : kExtractMaxBlocks;
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

// A device counter array's words (summed since the last reset) into
// out; cleared after the read when reset is non-zero.  Synchronous with
// the device: the caller's launches first.
template <size_t N>
static int read_stats(unsigned long long (&sym)[N], unsigned long long* out,
                      int reset) {
  int err = (int)cudaMemcpyFromSymbol(out, sym, sizeof(sym));
  if (!err && reset) {
    const unsigned long long zero[N] = {};
    err = (int)cudaMemcpyToSymbol(sym, zero, sizeof(zero));
  }
  return err;
}

// The rebuild statistics (kWaveStats words, in WaveStat order).
extern "C" int defrag_txn_rebuild_stats(unsigned long long* out, int reset) {
  return read_stats(g_wave_stats, out, reset);
}

// Each kernel's launches (kWaveLaunches words, in WaveLaunch order).
extern "C" int defrag_txn_launch_stats(unsigned long long* out, int reset) {
  return read_stats(g_wave_launches, out, reset);
}

static int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static int extract_launch(ArenaDesc d, int* mem, int S, long long Mw,
                          const int* src, const int* dst, const int* sizes,
                          int M, cudaStream_t stream) {
  const int blocks = defrag_extract_blocks(M);
  if (!blocks) return 0;
  defrag_extract_kernel<<<blocks, kExtractThreads, 0, stream>>>(
      d, mem, S, Mw, src, dst, sizes, M);
  return (int)cudaGetLastError();
}

extern "C" int defrag_txn_launch(ArenaDesc d, int* mem, int* ctl,
                                 const int* src, const int* dst,
                                 const int* sizes, int M, int* ws,
                                 void* stream) {
  const size_t smem = ws ? 0 : defrag_txn_table_bytes(d);
  const auto k = ws ? defrag_txn_kernel<true> : defrag_txn_kernel<false>;
  int err = set_smem((const void*)k, smem);
  if (err) return err;
  err = extract_launch(d, mem, 1, 0, src, dst, sizes, M,
                       (cudaStream_t)stream);
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
  const size_t table = defrag_txn_table_bytes(d);
  const size_t smem = ws ? 0 : table;
  const auto k = ws ? sharded_defrag_txn_kernel<true>
                    : sharded_defrag_txn_kernel<false>;
  int err = set_smem((const void*)k, smem);
  if (err) return err;
  err = extract_launch(d, mem, S, Mw, src, dst, sizes, M,
                       (cudaStream_t)stream);
  if (err) return err;
  k<<<S, 1024, smem, (cudaStream_t)stream>>>(
      d, mem, ctl, Mw, Cw, src, dst, sizes, M, ws,
      (long long)(table / sizeof(int)));
  return (int)cudaGetLastError();
}
