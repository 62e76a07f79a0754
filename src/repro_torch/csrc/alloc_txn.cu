// Ouroboros bulk allocator transactions on the device-resident arena,
// for the (kind=chunk, family=vl) variant: one kernel launch per
// transaction, on a single arena or on a sharded one.
//
// Replaces: src/repro/kernels/alloc_txn.py::arena_alloc_txn and
// ::arena_free_txn (and their region-blocked twins in
// alloc_txn_blocked.py), whose bodies are transactions.alloc_math /
// free_math; and ::sharded_arena_alloc_txn / ::sharded_arena_free_txn
// (and alloc_txn_blocked.py's sharded_*_blocked), whose bodies are
// transactions.sharded_alloc_math / sharded_free_math.  The plain
// PyTorch versions are the functions of the same names in
// src/repro_torch/core/transactions.py; each pair must leave identical
// mem/ctl words and offsets.
//
// What bounds it on the H100: latency, not bandwidth or arithmetic.  A
// transaction touches a few kilobytes, but it is a chain of dependent
// queue operations (vl dequeue with its chain walk and segment shrink,
// pool pop, bitmap claim, re-enqueue with segment grow) whose order
// fixes every later word, so its time is the length of that chain in
// dependent global-memory round trips.
//
// Design: one thread block per transaction.  Work with no order
// dependence runs block-wide: size class per lane (__clz), each lane's
// per-class rank by block scan, free's bit clears (atomics commute, so
// the result equals the reference's scatter-add), the ascending
// revived-chunk list (a bitset compacted by scan), and the telemetry
// counts.  The ctl block is staged in shared memory and written back
// once.  Heap, bitmap and queue words stay in global memory; thread 0
// drives the serial chain, free's re-enqueue value writes included, in
// exactly the reference's order.  The alloc chain writes each grant to
// its rank's slot of a rank -> offset table, and the lanes read theirs
// after it, so the chain issues stores only.  The layout comes in as a
// small struct of ints built once from the ArenaLayout, so a
// transaction makes no host reads.
//
// Lane tables (alloc's rank -> offset table, the sharded alloc's local
// offsets and selection, free's chunk bitset, revived-chunk lists and
// new segments) live in dynamic shared memory when they fit, else in a
// device workspace the wrapper allocates with torch.empty: the kernels
// take one pointer, `ws`, and use shared memory when it is null.  The
// body is the same either way, so a transaction takes any lane count;
// each kernel has one instance per address space, picked at launch, so
// the shared-memory case keeps shared-memory loads and stores instead of
// generic ones and carries no code of the other.
//
// Sharded arenas (mem (S, Mw), ctl (S, Cw); global offset = s * Ws +
// local).  The alloc is a schedule, attempt-major then shard-minor: at
// step (a, s) shard s serves the still-unserved lanes whose
// (home + a) % S == s.  Within one attempt the shards' lane sets are
// disjoint and their slabs independent, but attempt a + 1 on shard s
// depends on attempt a on shard s - 1, so sharded_alloc_txn is one
// block that runs the (a, s) steps in order, each through the same
// transaction body as alloc_txn (alloc_body) on shard s's rows, its ctl
// block restaged in shared memory, and the served lanes' telemetry in
// walk bin min(a, d.walk_bins - 1).  A step that selects no lane
// changes no word (its chain serves nothing and its telemetry deltas
// are 0), so it is skipped.  A free lane belongs to the one shard that
// owns its offset, so sharded_free_txn runs one block per shard, all
// independent, each through free_txn's body (free_body) on its slab.
//
// Semantics kept from the reference, deliberately: pool pops do not
// check the inventory; integer division and modulo floor; gathers out
// of range read a fill value and scatters out of range are dropped,
// after an index in [-n, 0) wraps to i + n; bitmap words change by
// wrapping add and subtract.

#include "arena_dev.cuh"

// ---- telemetry (ctl before -> after, plus per-class lane counts) --------

__device__ void tele_apply(const ArenaDesc& d, const int* s_old, int* s_ctl,
                           const int* d_alloc, const int* d_free,
                           const int* d_fail, int d_walk, int walk_bin) {
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
  t[t0 + 4 * C + 3 + walk_bin] += (unsigned)d_walk;
}

// ---- alloc ---------------------------------------------------------------

struct AllocShared {
  int ctl[MAX_CTL], old[MAX_CTL];
  int count[MAX_CLASSES], warp[32];
  int served[MAX_CLASSES], failed[MAX_CLASSES];
};

// One alloc transaction on one arena (mem, ctl) for the lanes with
// sel[i] != 0, block-wide; out[i] receives the local word offset, -1 for
// a failed or unselected lane.  grant: n ints of shared or global memory
// (rank -> granted offset, ranks class-major, lanes in order within a
// class).  Served lanes count in walk bin walk_bin.
__device__ __forceinline__ void alloc_body(
    const ArenaDesc& d, int* mem, int* ctl, const int* sizes,
    const uint8_t* sel, int n, int* out, int walk_bin, AllocShared& sh,
    int* grant) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt)
    sh.ctl[i] = sh.old[i] = ctl[i];
  for (int i = tid; i < C; i += nt) sh.served[i] = sh.failed[i] = 0;
  for (int i = tid; i < n; i += nt) grant[i] = -1;

  // out[i] = the lane's rank, by block scan (-1: not selected, or no class)
  const int per = (n + nt - 1) / nt;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  for (int i = lo; i < hi; ++i) out[i] = -1;
  int start = 0;
  for (int c = 0; c < C; ++c) {
    int local = 0;
    for (int i = lo; i < hi; ++i)
      local += (sel[i] && size_class(d, sizes[i]) == c);
    int total;
    int r = start + block_excl_scan(local, &total, sh.warp);
    for (int i = lo; i < hi; ++i)
      if (sel[i] && size_class(d, sizes[i]) == c) out[i] = r++;
    if (tid == 0) sh.count[c] = total;
    start += total;
  }
  __syncthreads();

  // the serial chain, class-major, in the reference's order
  if (tid == 0) {
    Chain ch{d, mem, sh.ctl};
    unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
    int* free_count = mem + d.free_off;
    int* chunk_class = mem + d.class_off;
    const int nc = d.num_chunks, bw = d.bw;
    int base = 0;
    for (int c = 0; c < C; ++c) {
      const int cnt = sh.count[c];
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
            grant[base + served + k] = chunk * d.wpc + (lo_bit + b) * pw;
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

  // each ranked lane takes its grant; per-class served / failed lanes
  for (int i = tid; i < n; i += nt) {
    if (out[i] < 0) continue;
    const int g = grant[out[i]];
    out[i] = g;
    const int c = size_class(d, sizes[i]);
    if (g >= 0) atomicAdd(&sh.served[c], 1);
    else atomicAdd(&sh.failed[c], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int served = 0;
    for (int c = 0; c < C; ++c) served += sh.served[c];
    int zero[MAX_CLASSES] = {0};
    tele_apply(d, sh.old, sh.ctl, sh.served, zero, sh.failed, served,
               walk_bin);
  }
  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt) ctl[i] = sh.ctl[i];
}

// Each kernel has one instance per home of its lane tables: kWs puts
// them in the device workspace ws, else in dynamic shared memory.  The
// body is the same; the shared-memory instance keeps shared-memory
// addressing and carries no code of the other.
template <bool kWs>
__global__ void __launch_bounds__(1024)
alloc_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                 const int* sizes, const uint8_t* mask,
                 int n, int* out, int* ws) {
  __shared__ AllocShared sh;
  extern __shared__ int dyn[];  // the lane tables, unless ws holds them
  // grant: n ints, rank -> granted offset
  alloc_body(d, mem, ctl, sizes, mask, n, out, 0, sh, kWs ? ws : dyn);
}

// The (walk + 1, S) overflow-walk schedule in one block.  mem/ctl are
// (S, Mw) / (S, Cw) row-major; out receives GLOBAL offsets.
// tables: grant (n ints) | local offsets (n ints) | selection (n bytes)
__device__ __forceinline__ void sharded_alloc_schedule(
    const ArenaDesc& d, int* mem, int* ctl, int S, int Mw, int Cw,
    const int* sizes, const uint8_t* mask, const int* home, int n, int walk,
    int* out, AllocShared& sh, int& s_nsel, int* tables) {
  int* grant = tables;
  int* local = grant + n;
  uint8_t* sel = reinterpret_cast<uint8_t*>(grant + 2 * n);
  const int tid = threadIdx.x, nt = blockDim.x, Ws = d.total_words;
  for (int i = tid; i < n; i += nt) out[i] = -1;
  for (int a = 0; a <= walk; ++a) {
    for (int s = 0; s < S; ++s) {
      __syncthreads();
      if (tid == 0) s_nsel = 0;
      __syncthreads();
      int mine = 0;
      for (int i = tid; i < n; i += nt) {
        sel[i] = mask[i] && fmodi(home[i] + a, S) == s && out[i] < 0;
        mine += sel[i];
      }
      if (mine) atomicAdd(&s_nsel, mine);
      __syncthreads();
      if (s_nsel == 0) continue;  // uniform: read after the barrier
      alloc_body(d, mem + (long long)s * Mw, ctl + (long long)s * Cw, sizes,
                 sel, n, local, min(a, d.walk_bins - 1), sh, grant);
      __syncthreads();
      for (int i = tid; i < n; i += nt)
        if (sel[i] && local[i] >= 0) out[i] = s * Ws + local[i];
    }
  }
}

template <bool kWs>
__global__ void __launch_bounds__(1024)
sharded_alloc_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                         int S, int Mw, int Cw,
                         const int* sizes,
                         const uint8_t* mask,
                         const int* home, int n, int walk,
                         int* out, int* ws) {
  __shared__ AllocShared sh;
  __shared__ int s_nsel;
  extern __shared__ int dyn[];  // the lane tables, unless ws holds them
  sharded_alloc_schedule(d, mem, ctl, S, Mw, Cw, sizes, mask, home, n,
                         walk, out, sh, s_nsel, kWs ? ws : dyn);
}

// ---- free ----------------------------------------------------------------

// The lanes of one free transaction as one arena sees them: all of them
// (a single arena), or those whose global offset shard s owns, at their
// local offsets (a sharded arena).
struct FreeLanes {
  const int* offs;
  const uint8_t* mask;
  int s, Ws;
  bool sharded;
  __device__ bool sel(int i) const {
    if (!mask[i]) return false;
    return !sharded || (offs[i] >= 0 && fdiv(offs[i], Ws) == s);
  }
  __device__ int off(int i) const {
    return sharded ? offs[i] - s * Ws : offs[i];
  }
};

struct FreeShared {
  int ctl[MAX_CTL], old[MAX_CTL];
  int count[MAX_CLASSES], warp[32], freed[MAX_CLASSES];
  int nnew[MAX_CLASSES], rev;
};

// One free transaction on one arena (mem, ctl), block-wide.  tables:
// free_txn_table_bytes of shared or global memory.
__device__ __forceinline__ void free_body(const ArenaDesc& d, int* mem,
                                          int* ctl, FreeLanes L,
                                          const int* sizes, int n,
                                          FreeShared& sh, int* tables) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int nc = d.num_chunks, wpc = d.wpc, spc = d.spc;
  const int nwords = (nc + 31) / 32;
  const int m = n / spc + 1;
  // tables: bitset (ceil(nc/32)) | rev ids (n) | rev class (n) |
  //         rev rank (n) | new segment chunks (C * m)
  unsigned* bitset = reinterpret_cast<unsigned*>(tables);
  int* rev_id = tables + nwords;
  int* rev_cls = rev_id + n;
  int* rev_rank = rev_cls + n;
  int* newc = rev_rank + n;

  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  const int* chunk_class = mem + d.class_off;

  for (int i = tid; i < d.ctl_words; i += nt)
    sh.ctl[i] = sh.old[i] = ctl[i];
  for (int i = tid; i < C; i += nt) sh.freed[i] = 0;
  for (int i = tid; i < nwords; i += nt) bitset[i] = 0u;
  for (int i = tid; i < C * m; i += nt) newc[i] = -1;
  __syncthreads();

  // phase A: which touched chunks were full (free counts before any
  // clear), and the freed-lane telemetry
  for (int i = tid; i < n; i += nt) {
    const int c = size_class(d, sizes[i]);
    if (!L.sel(i) || c >= C) continue;
    const int off = L.off(i);
    if (off < 0) continue;
    atomicAdd(&sh.freed[c], 1);
    const int chunk = fdiv(off, wpc);
    if (chunk < nc && free_count[chunk] == 0)
      atomicOr(&bitset[chunk >> 5], 1u << (chunk & 31));
  }
  __syncthreads();

  // phase B: clear the bits (wrapping subtract) and return the pages
  for (int i = tid; i < n; i += nt) {
    const int c = size_class(d, sizes[i]);
    if (!L.sel(i) || c >= C) continue;
    const int off = L.off(i);
    if (off < 0) continue;
    const int chunk = fdiv(off, wpc);
    if (chunk >= nc) continue;
    const int pw = d.min_page_words << c;
    const int page = fdiv(fmodi(off, wpc), pw);
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
    int pos = block_excl_scan(local, &total, sh.warp);
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
    if (tid == 0) sh.rev = total;
  }
  __syncthreads();
  const int R = sh.rev;

  // per-class ranks of the revived list (a class outside [0, C) ranks in
  // class cls mod C without being counted, as the reference's one-hot)
  {
    const int per = (R + nt - 1) / nt;
    const int lo = min(R, tid * per), hi = min(R, lo + per);
    for (int c = 0; c < C; ++c) {
      int local = 0;
      for (int j = lo; j < hi; ++j) local += (rev_cls[j] == c);
      int total;
      int r = block_excl_scan(local, &total, sh.warp);
      for (int j = lo; j < hi; ++j) {
        if (fmodi(rev_cls[j], C) == c) rev_rank[j] = r;
        if (rev_cls[j] == c) ++r;
      }
      if (tid == 0) sh.count[c] = total;
    }
  }
  __syncthreads();

  // grow: pop new segments class-major, terminate them, link them
  if (tid == 0) {
    Chain ch{d, mem, sh.ctl};
    const int W = d.total_words;
    for (int c = 0; c < C; ++c) {
      const int b = ch.back(c);
      sh.nnew[c] = fdiv(b + sh.count[c], spc) - fdiv(b, spc);
      for (int j = 0; j < sh.nnew[c]; ++j) newc[c * m + j] = ch.pool_pop();
    }
    for (int c = 0; c < C; ++c)
      for (int j = 0; j < sh.nnew[c]; ++j)
        heap_set(mem, (long long)newc[c * m + j] * wpc, W, -1);
    for (int j = 0; j < m; ++j)
      for (int c = 0; c < C; ++c)
        if (j < sh.nnew[c]) {
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
      const int b = sh.old[C + cm], tl = sh.old[3 * C + cm];
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
      if (sh.nnew[c] > 0) sh.ctl[3 * C + c] = newc[c * m + sh.nnew[c] - 1];
      sh.ctl[C + c] += sh.count[c];
    }
    int zero[MAX_CLASSES] = {0};
    tele_apply(d, sh.old, sh.ctl, zero, sh.freed, zero, 0, 0);
  }
  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt) ctl[i] = sh.ctl[i];
}

template <bool kWs>
__global__ void __launch_bounds__(1024)
free_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                const int* offs, const int* sizes,
                const uint8_t* mask, int n, int* ws) {
  __shared__ FreeShared sh;
  extern __shared__ int dyn[];
  const FreeLanes L{offs, mask, 0, 0, false};
  free_body(d, mem, ctl, L, sizes, n, sh, kWs ? ws : dyn);
}

// One block per shard: block s frees the lanes whose offsets it owns.
// A workspace holds one table set per block (ws_ints ints each).
template <bool kWs>
__global__ void __launch_bounds__(1024)
sharded_free_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                        int Mw, int Cw, const int* offs,
                        const int* sizes,
                        const uint8_t* mask, int n, int* ws,
                        long long ws_ints) {
  __shared__ FreeShared sh;
  extern __shared__ int dyn[];
  const int s = blockIdx.x;
  int* m = mem + (long long)s * Mw;
  int* c = ctl + (long long)s * Cw;
  const FreeLanes L{offs, mask, s, d.total_words, true};
  free_body(d, m, c, L, sizes, n, sh, kWs ? ws + s * ws_ints : dyn);
}

// ---- launch geometry (also used by the emulation harness) -------------
//
// *_table_bytes: the bytes of a transaction's lane tables (per block).
// *_workspace_bytes: 0 when they fit in smem_limit bytes of dynamic
// shared memory, else the bytes of device workspace the caller passes as
// ws (one table set per block).  A launch with ws uses no dynamic shared
// memory; one without puts the tables there.

extern "C" size_t alloc_txn_table_bytes(ArenaDesc d, int n) {
  (void)d;
  return (size_t)n * sizeof(int);
}

extern "C" size_t free_txn_table_bytes(ArenaDesc d, int n) {
  const int nwords = (d.num_chunks + 31) / 32;
  const int m = n / d.spc + 1;
  return ((size_t)nwords + 3 * (size_t)n + (size_t)d.num_classes * m)
         * sizeof(int);
}

extern "C" size_t sharded_alloc_txn_table_bytes(ArenaDesc d, int n) {
  (void)d;
  size_t b = 2 * (size_t)n * sizeof(int) + (size_t)n;
  return (b + 3) & ~(size_t)3;
}

static size_t workspace_bytes(size_t table, size_t smem_limit, int blocks) {
  return table <= smem_limit ? 0 : table * (size_t)blocks;
}

extern "C" size_t alloc_txn_workspace_bytes(ArenaDesc d, int n,
                                            size_t smem_limit) {
  return workspace_bytes(alloc_txn_table_bytes(d, n), smem_limit, 1);
}

extern "C" size_t free_txn_workspace_bytes(ArenaDesc d, int n, int blocks,
                                           size_t smem_limit) {
  return workspace_bytes(free_txn_table_bytes(d, n), smem_limit, blocks);
}

extern "C" size_t sharded_alloc_txn_workspace_bytes(ArenaDesc d, int n,
                                                    size_t smem_limit) {
  return workspace_bytes(sharded_alloc_txn_table_bytes(d, n), smem_limit, 1);
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

static int launch_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int alloc_txn_launch(ArenaDesc d, int* mem, int* ctl,
                                const int* sizes, const uint8_t* mask, int n,
                                int* out, int* ws, void* stream) {
  const size_t smem = ws ? 0 : alloc_txn_table_bytes(d, n);
  const auto k = ws ? alloc_txn_kernel<true> : alloc_txn_kernel<false>;
  int err = launch_smem((const void*)k, smem);
  if (err) return err;
  k<<<1, block_threads(n), smem, (cudaStream_t)stream>>>(
      d, mem, ctl, sizes, mask, n, out, ws);
  return (int)cudaGetLastError();
}

extern "C" int free_txn_launch(ArenaDesc d, int* mem, int* ctl,
                               const int* offs, const int* sizes,
                               const uint8_t* mask, int n, int* ws,
                               void* stream) {
  const size_t smem = ws ? 0 : free_txn_table_bytes(d, n);
  const auto k = ws ? free_txn_kernel<true> : free_txn_kernel<false>;
  int err = launch_smem((const void*)k, smem);
  if (err) return err;
  k<<<1, block_threads(n), smem, (cudaStream_t)stream>>>(
      d, mem, ctl, offs, sizes, mask, n, ws);
  return (int)cudaGetLastError();
}

extern "C" int sharded_alloc_txn_launch(ArenaDesc d, int* mem, int* ctl,
                                        int S, int Mw, int Cw,
                                        const int* sizes,
                                        const uint8_t* mask,
                                        const int* home, int n, int walk,
                                        int* out, int* ws, void* stream) {
  const size_t smem = ws ? 0 : sharded_alloc_txn_table_bytes(d, n);
  const auto k = ws ? sharded_alloc_txn_kernel<true>
                    : sharded_alloc_txn_kernel<false>;
  int err = launch_smem((const void*)k, smem);
  if (err) return err;
  k<<<1, block_threads(n), smem, (cudaStream_t)stream>>>(
      d, mem, ctl, S, Mw, Cw, sizes, mask, home, n, walk, out, ws);
  return (int)cudaGetLastError();
}

extern "C" int sharded_free_txn_launch(ArenaDesc d, int* mem, int* ctl,
                                       int S, int Mw, int Cw,
                                       const int* offs, const int* sizes,
                                       const uint8_t* mask, int n, int* ws,
                                       void* stream) {
  const size_t table = free_txn_table_bytes(d, n);
  const size_t smem = ws ? 0 : table;
  const auto k = ws ? sharded_free_txn_kernel<true>
                    : sharded_free_txn_kernel<false>;
  int err = launch_smem((const void*)k, smem);
  if (err) return err;
  k<<<S, block_threads(n), smem, (cudaStream_t)stream>>>(
      d, mem, ctl, Mw, Cw, offs, sizes, mask, n, ws,
      (long long)(table / sizeof(int)));
  return (int)cudaGetLastError();
}
