// Ouroboros bulk allocator transactions on the device-resident arena, for
// all six variants (kind page or chunk, queue family ring, va or vl): one
// kernel launch per transaction, on a single arena or on a sharded one.
//
// Replaces: src/repro/kernels/alloc_txn.py::arena_alloc_txn and
// ::arena_free_txn (and their region-blocked twins in
// alloc_txn_blocked.py), whose bodies are transactions.alloc_math /
// free_math; and ::sharded_arena_alloc_txn / ::sharded_arena_free_txn
// (and alloc_txn_blocked.py's sharded_*_blocked), whose bodies are
// transactions.sharded_alloc_math / sharded_free_math.  The plain
// PyTorch versions are the functions of the same names in
// src/repro_torch/core/transactions.py (page_alloc.alloc / free for page
// kinds, chunk_alloc.alloc / free for chunk kinds); each pair must leave
// identical mem/ctl words and offsets.
//
// What bounds it on the H100: latency, not bandwidth or arithmetic.  A
// transaction touches a few kilobytes to a few hundred, but a chunk
// kind's is a chain of dependent queue operations (dequeue with its
// segment shrink, pool pop, bitmap claim, re-enqueue with segment grow)
// whose order fixes every later word, so its time is the length of that
// chain in dependent global-memory round trips; a page kind's lanes each
// gather one queue value, independent of each other.
//
// Design: one thread block per transaction.  The layout, kind and
// family come in as a small struct of ints built once from the
// ArenaLayout, so a transaction makes no host reads.  Work with no order
// dependence runs block-wide: size class per lane (__clz), each lane's
// per-class rank by block scan, free's bit clears (atomics commute, so
// the result equals the reference's scatter-add), the ascending
// revived-chunk list (a bitset compacted by scan), and the telemetry
// counts.  The ctl block is staged in shared memory and written back
// once.  Heap, bitmap and queue words stay in global memory.
//
// Chunk kinds: thread 0 drives the serial chain, class-major, in exactly
// the reference's order, through the family's one-value dequeue and
// enqueue (arena_dev.cuh); the chain writes each grant to its rank's slot
// of a rank -> offset table, and the lanes read theirs after it, so the
// chain issues stores only.  Free's revived chunks re-enter their queues
// through the family's bulk enqueue (ring slots; va directory grow; vl
// chain grow), written by thread 0 in lane order.
//
// Page kinds: alloc grants each class the rank prefix that fits its
// inventory (rank < back - front); every granted lane gathers its value
// on its own (ring: the store slot front + rank; va: through the
// directory; vl: through a table of m + 1 chain hops per class, walked by
// one thread per class), then thread 0 returns the consumed segments to
// the pool class-major, segment-minor.  Free has thread 0 pop and enter
// the new segments (va: directory slots; vl: terminated, then linked
// j-major), then the lanes write their values at back + rank through the
// grown directory or chain, in parallel, unless two lanes could write one
// word (a ring class wider than its capacity, a counter crossing 2^31,
// or two touched segments that are one chunk: pops from an exhausted
// pool repeat chunks, a directory wraps max_segs): then thread 0 writes
// them all in lane order, as the reference's scatter resolves them.
//
// Lane tables (alloc's rank -> offset table or page-vl chain table, the
// sharded alloc's local offsets and selection, free's chunk bitset,
// ranks, revived-chunk lists and new segments) live in dynamic shared
// memory when they fit, else in a device workspace the wrapper allocates
// with torch.empty: the kernels take one pointer, `ws`, and use shared
// memory when it is null.  The body is the same either way, so a
// transaction takes any lane count; each kernel has one instance per
// address space, picked at launch, so the shared-memory case keeps
// shared-memory loads and stores instead of generic ones and carries no
// code of the other.
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
// changes no word (it serves nothing and its telemetry deltas are 0),
// so it is skipped.  A free lane belongs to the one shard that owns its
// offset, so sharded_free_txn runs one block per shard, all
// independent, each through free_txn's body (free_body) on its slab.
//
// Semantics kept from the reference, deliberately: pool pops do not
// check the inventory; integer division and modulo floor; counters and
// queue word indices wrap at 32 bits; gathers out of range read a fill
// value and scatters out of range are dropped, after an index in
// [-n, 0) wraps to i + n; bitmap words change by wrapping add and
// subtract.

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
  t[t0 + 4 * C] += (unsigned)pf1 - (unsigned)pf0;
  t[t0 + 4 * C + 1] += (unsigned)pb1 - (unsigned)pb0;
  t[t0 + 4 * C + 2] += (unsigned)((fdiv(pf1, nc) - fdiv(pf0, nc))
                                  + (fdiv(pb1, nc) - fdiv(pb0, nc)));
  t[t0 + 4 * C + 3 + walk_bin] += (unsigned)d_walk;
}

// ---- lane ranks -----------------------------------------------------------

// rank[i] = base[c] + the number of earlier lanes of class c, for the
// lanes that cls_of(i) puts in a class c in [0, C), -1 for the others;
// count[c] and base[c] (classes concatenated in class order) are written
// by thread 0.  Each thread takes a contiguous run of lanes, so ranks
// follow lane order.  The caller synchronises before reading count/base.
template <class ClassOf>
__device__ __forceinline__ void rank_lanes(int n, int C, ClassOf cls_of,
                                           int* rank, int* count, int* base,
                                           int* s_warp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int per = (n + nt - 1) / nt;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  for (int i = lo; i < hi; ++i) rank[i] = -1;
  int start = 0;
  for (int c = 0; c < C; ++c) {
    int local = 0;
    for (int i = lo; i < hi; ++i) local += cls_of(i) == c;
    int total;
    int r = start + block_excl_scan(local, &total, s_warp);
    for (int i = lo; i < hi; ++i)
      if (cls_of(i) == c) rank[i] = r++;
    if (tid == 0) {
      count[c] = total;
      base[c] = start;
    }
    start += total;
  }
}

// ---- queue grow and the value write of a bulk enqueue -----------------------

// The grow step of a family's bulk enqueue of count[c] values a class
// (thread 0, ctl staged): va/vl pop the new segments class-major,
// segment-minor (at most m a class) into newc (C, m); va enters them in
// the directory slots after back's segment; vl terminates them all, then
// links them j-major after the tail.  The ring needs none.
__device__ __forceinline__ void grow_segments(const ArenaDesc& d, Chain& ch,
                                              const int* count, int* nnew,
                                              int* newc, int m) {
  const int C = d.num_classes, spc = d.spc, W = d.total_words;
  if (d.family == FAM_RING) return;
  for (int c = 0; c < C; ++c) {
    const int b = ch.back(c);
    nnew[c] = min(fdiv(add32(b, count[c]), spc) - fdiv(b, spc), m);
    for (int j = 0; j < nnew[c]; ++j) newc[c * m + j] = ch.pool_pop();
  }
  if (d.family == FAM_VA) {
    for (int c = 0; c < C; ++c)
      for (int j = 0; j < nnew[c]; ++j)
        ch.dir(c, fdiv(ch.back(c), spc) + 1 + j) = newc[c * m + j];
    return;
  }
  for (int c = 0; c < C; ++c)
    for (int j = 0; j < nnew[c]; ++j)
      heap_set(ch.mem, seg_word(newc[c * m + j], d.wpc, 0), W, -1);
  for (int j = 0; j < m; ++j)
    for (int c = 0; c < C; ++c)
      if (j < nnew[c]) {
        const int prev = j == 0 ? ch.tail(c) : newc[c * m + j - 1];
        heap_set(ch.mem, seg_word(prev, d.wpc, 0), W, newc[c * m + j]);
      }
}

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
  int count[MAX_CLASSES], base[MAX_CLASSES], warp[32], freed[MAX_CLASSES];
  int nnew[MAX_CLASSES], rev, serial;
};

// Write one enqueued value at slot back + r of class cm (back and tail
// as staged before the transaction, in sh.old): the ring slot, or the
// heap word through the grown directory (va) or the tail and new
// segments (vl).  The family is a template argument, so a loop over the
// values carries no family branch: with one, thread 0's loop over a
// 298,656-lane free's 18,666 revived chunks ran 29% slower.
template <int FAM>
__device__ __forceinline__ void put_value(const ArenaDesc& d, int* mem,
                                          const FreeShared& sh,
                                          const int* newc, int m, int cm,
                                          int r, int val) {
  const int C = d.num_classes, spc = d.spc, W = d.total_words;
  const int b = sh.old[C + cm], v = add32(b, r);
  if constexpr (FAM == FAM_RING) {
    mem[d.queue_off + cm * d.queue_cap + fmodi(v, d.queue_cap)] = val;
  } else if constexpr (FAM == FAM_VA) {
    const int seg = mem[d.queue_off + cm * d.max_segs
                        + fmodi(fdiv(v, spc), d.max_segs)];
    heap_set(mem, seg_word(seg, d.wpc, fmodi(v, spc)), W, val);
  } else {
    const int rel = fdiv(v, spc) - fdiv(b, spc);
    int seg;
    if (rel == 0) {
      seg = sh.old[3 * C + cm];
    } else {
      const int col = rel - 1 < 0 ? rel - 1 + m : rel - 1;
      seg = (col >= 0 && col < m) ? newc[cm * m + col] : 0;
    }
    heap_set(mem, seg_word(seg, d.wpc, 1 + fmodi(v, spc)), W, val);
  }
}

// The values of a bulk enqueue (after its grow): a chunk kind's R
// revived chunks on thread 0 in lane order; a page kind's freed lanes in
// parallel, or on thread 0 in lane order when two could share a word
// (sh.serial).
template <int FAM>
__device__ __forceinline__ void put_values(const ArenaDesc& d, int* mem,
                                           const FreeShared& sh,
                                           const int* newc, int m,
                                           FreeLanes L, const int* sizes,
                                           const int* rank, const int* rev_id,
                                           const int* rev_cls, int R) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  if (d.kind == KIND_CHUNK) {
    if (tid == 0)
      for (int j = 0; j < R; ++j)
        put_value<FAM>(d, mem, sh, newc, m, fmodi(rev_cls[j], C), rank[j],
                       rev_id[j]);
    return;
  }
  auto put = [&](int j) {
    if (rank[j] < 0) return;
    const int c = size_class(d, sizes[j]);
    put_value<FAM>(d, mem, sh, newc, m, c, rank[j] - sh.base[c], L.off(j));
  };
  if (!sh.serial) {
    for (int j = tid; j < R; j += nt) put(j);
  } else if (tid == 0) {
    for (int j = 0; j < R; ++j) put(j);
  }
}

// Counters after a bulk enqueue: back advances by the class's count, a vl
// tail moves to its last new segment.
__device__ __forceinline__ void enqueue_done(const ArenaDesc& d, Chain& ch,
                                             const int* count, const int* nnew,
                                             const int* newc, int m) {
  for (int c = 0; c < d.num_classes; ++c) {
    if (d.family == FAM_VL && nnew[c] > 0)
      ch.tail(c) = newc[c * m + nnew[c] - 1];
    ch.back(c) = add32(ch.back(c), count[c]);
  }
}

// ---- alloc ---------------------------------------------------------------

struct AllocShared {
  int ctl[MAX_CTL], old[MAX_CTL];
  int count[MAX_CLASSES], base[MAX_CLASSES], take[MAX_CLASSES], warp[32];
  int served[MAX_CLASSES], failed[MAX_CLASSES];
};

// Scratch ints of one alloc transaction's body: the chunk kinds' rank ->
// offset table, or the page-vl chain table (C, n / spc + 2).
__host__ __device__ inline size_t alloc_scratch_ints(const ArenaDesc& d,
                                                     int n) {
  if (d.kind == KIND_CHUNK) return (size_t)n;
  if (d.family == FAM_VL)
    return (size_t)d.num_classes * (size_t)(n / d.spc + 2);
  return 0;
}

// Chunk kinds: thread 0's serial chain, class-major, in the reference's
// order; grant: the rank -> granted offset table (n ints, -1 filled).
__device__ __forceinline__ void chunk_grants(const ArenaDesc& d, int* mem,
                                             AllocShared& sh, int* grant) {
  Chain ch{d, mem, sh.ctl};
  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  int* chunk_class = mem + d.class_off;
  const int nc = d.num_chunks, bw = d.bw, C = d.num_classes;
  for (int c = 0; c < C; ++c) {
    const int cnt = sh.count[c], base = sh.base[c];
    const int ppc = d.max_ppc >> c, pw = d.min_page_words << c;
    int served = 0;
    while (served < cnt) {
      int chunk;
      if (ch.count(c) > 0) {
        chunk = ch.dequeue1(c);
      } else {
        if (ch.pool_count() <= 0) break;  // exhausted
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
      if (free_count[row] > 0) ch.enqueue1(c, chunk);
      served += t;
    }
  }
}

// Page kinds: each class grants the rank prefix below its inventory
// (back - front); each granted lane (out[i]: its class-major rank, turned
// into its value here) gathers its value on its own; thread 0 then
// returns the consumed segments to the pool and advances the counters.
// chain: the page-vl chain table (C, m + 1).
__device__ __forceinline__ void page_grants(const ArenaDesc& d, int* mem,
                                            const int* sizes, int n,
                                            int* out, AllocShared& sh,
                                            int* chain) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int spc = d.spc, wpc = d.wpc, W = d.total_words;
  const int m = n / spc + 1;
  if (tid < C) {
    sh.take[tid] = max(0, min(sh.count[tid],
                              sub32(sh.ctl[C + tid], sh.ctl[tid])));
    if (d.family == FAM_VL) {  // m + 1 hops from the head
      int* row = chain + tid * (m + 1);
      int h = sh.ctl[2 * C + tid];
      row[0] = h;
      for (int k = 1; k <= m; ++k) {
        h = h >= 0 ? heap_get(mem, seg_word(h, wpc, 0), W, -1) : -1;
        row[k] = h;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    if (out[i] < 0) continue;
    const int c = size_class(d, sizes[i]);
    const int r = out[i] - sh.base[c];
    if (r >= sh.take[c]) {
      out[i] = -1;
      continue;
    }
    const int f0 = sh.ctl[c], v = add32(f0, r);
    int val;
    if (d.family == FAM_RING) {
      val = mem[d.queue_off + c * d.queue_cap + fmodi(v, d.queue_cap)];
    } else if (d.family == FAM_VA) {
      const int seg = mem[d.queue_off + c * d.max_segs
                          + fmodi(fdiv(v, spc), d.max_segs)];
      val = heap_get(mem, seg_word(seg, wpc, fmodi(v, spc)), W, -1);
    } else {
      int rel = fdiv(v, spc) - fdiv(f0, spc);
      if (rel < 0) rel += m + 1;
      const int seg = (rel >= 0 && rel <= m) ? chain[c * (m + 1) + rel] : 0;
      val = heap_get(mem, seg_word(seg, wpc, 1 + fmodi(v, spc)), W, -1);
    }
    out[i] = val;
  }
  __syncthreads();
  if (tid == 0) {
    Chain ch{d, mem, sh.ctl};
    for (int c = 0; c < C; ++c) {
      const int f0 = ch.front(c), k = sh.take[c];
      if (d.family != FAM_RING) {
        const int n_free = fdiv(add32(f0, k), spc) - fdiv(f0, spc);
        const int* row = chain + c * (m + 1);
        for (int j = 0; j < min(n_free, m); ++j)
          ch.pool_push(d.family == FAM_VA ? ch.dir(c, fdiv(f0, spc) + j)
                                          : row[j]);
        if (d.family == FAM_VL) {  // plain indexing: wrap, then clamp
          const int col = n_free < 0 ? n_free + m + 1 : n_free;
          ch.head(c) = row[col < 0 ? 0 : (col > m ? m : col)];
        }
      }
      ch.front(c) = add32(f0, k);
    }
  }
}

// One alloc transaction on one arena (mem, ctl) for the lanes with
// sel[i] != 0, block-wide; out[i] receives the local word offset, -1 for
// a failed or unselected lane.  scratch: alloc_scratch_ints(d, n) ints of
// shared or global memory.  Served lanes count in walk bin walk_bin.
__device__ __forceinline__ void alloc_body(
    const ArenaDesc& d, int* mem, int* ctl, const int* sizes,
    const uint8_t* sel, int n, int* out, int walk_bin, AllocShared& sh,
    int* scratch) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt)
    sh.ctl[i] = sh.old[i] = ctl[i];
  for (int i = tid; i < C; i += nt) sh.served[i] = sh.failed[i] = 0;
  if (d.kind == KIND_CHUNK)
    for (int i = tid; i < n; i += nt) scratch[i] = -1;
  auto cls_of = [&](int i) {
    if (!sel[i]) return -1;
    const int c = size_class(d, sizes[i]);
    return c < C ? c : -1;
  };
  rank_lanes(n, C, cls_of, out, sh.count, sh.base, sh.warp);
  __syncthreads();

  if (d.kind == KIND_CHUNK) {
    if (tid == 0) chunk_grants(d, mem, sh, scratch);
  } else {
    page_grants(d, mem, sizes, n, out, sh, scratch);
  }
  __syncthreads();

  // each ranked lane's grant (a chunk kind's through the rank -> offset
  // table), and the per-class served / failed lanes
  for (int i = tid; i < n; i += nt) {
    const int c = cls_of(i);
    if (c < 0) continue;
    if (d.kind == KIND_CHUNK) out[i] = scratch[out[i]];
    if (out[i] >= 0) atomicAdd(&sh.served[c], 1);
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
  alloc_body(d, mem, ctl, sizes, mask, n, out, 0, sh, kWs ? ws : dyn);
}

// The (walk + 1, S) overflow-walk schedule in one block.  mem/ctl are
// (S, Mw) / (S, Cw) row-major; out receives GLOBAL offsets.
// tables: scratch (alloc_scratch_ints) | local offsets (n ints) |
//         selection (n bytes)
__device__ __forceinline__ void sharded_alloc_schedule(
    const ArenaDesc& d, int* mem, int* ctl, int S, int Mw, int Cw,
    const int* sizes, const uint8_t* mask, const int* home, int n, int walk,
    int* out, AllocShared& sh, int& s_nsel, int* tables) {
  int* scratch = tables;
  int* local = scratch + alloc_scratch_ints(d, n);
  uint8_t* sel = reinterpret_cast<uint8_t*>(local + n);
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
                 sel, n, local, min(a, d.walk_bins - 1), sh, scratch);
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

// Page kinds, thread 0, after the grow: could two lanes' value writes hit
// one word?  Yes when a ring class takes more values than its capacity
// or its slots cross 2^31, or when two touched segments (a va
// directory's slots from back's on; a vl tail and new segments) are one
// chunk, or one lies outside the heap's chunks.  seen: a bitset of
// ceil(nc / 32) zeroed words.
__device__ __forceinline__ bool page_free_may_collide(
    const ArenaDesc& d, Chain& ch, const int* count, const int* nnew,
    const int* newc, int m, unsigned* seen) {
  const int nc = d.num_chunks, spc = d.spc;
  auto mark = [&](int seg) {
    if (seg < 0 || seg >= nc) return true;
    const unsigned bit = 1u << (seg & 31);
    if (seen[seg >> 5] & bit) return true;
    seen[seg >> 5] |= bit;
    return false;
  };
  for (int c = 0; c < d.num_classes; ++c) {
    if (count[c] <= 0) continue;
    const int b = ch.back(c);
    if ((long long)b + count[c] - 1 > 0x7fffffffLL) return true;
    if (d.family == FAM_RING) {
      if (count[c] > d.queue_cap) return true;
    } else if (d.family == FAM_VA) {
      for (int sg = fdiv(b, spc); sg <= fdiv(b + count[c] - 1, spc); ++sg)
        if (mark(ch.dir(c, sg))) return true;
    } else {
      if (mark(ch.tail(c))) return true;
      for (int j = 0; j < nnew[c]; ++j)
        if (mark(newc[c * m + j])) return true;
    }
  }
  return false;
}

// A chunk kind's free up to its enqueue, block-wide: clear the freed
// pages' bits and return them to the free counts, then list the chunks
// it revived (full before, touched now) in ascending id order, each with
// its class and its rank among the revived chunks of class cls mod C (a
// class outside [0, C) ranks there without being counted, as the
// reference's one-hot).  bitset: ceil(nc / 32) zeroed words.  Returns
// the number of revived chunks.
__device__ __forceinline__ int revive_chunks(const ArenaDesc& d, int* mem,
                                             FreeLanes L, const int* sizes,
                                             int n, FreeShared& sh,
                                             unsigned* bitset, int* rev_id,
                                             int* rev_cls, int* rank) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int nc = d.num_chunks, wpc = d.wpc, nwords = (nc + 31) / 32;
  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  const int* chunk_class = mem + d.class_off;

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

  // per-class ranks of the revived list
  const int per = (R + nt - 1) / nt;
  const int lo = min(R, tid * per), hi = min(R, lo + per);
  for (int c = 0; c < C; ++c) {
    int local = 0;
    for (int j = lo; j < hi; ++j) local += (rev_cls[j] == c);
    int total;
    int r = block_excl_scan(local, &total, sh.warp);
    for (int j = lo; j < hi; ++j) {
      if (fmodi(rev_cls[j], C) == c) rank[j] = r;
      if (rev_cls[j] == c) ++r;
    }
    if (tid == 0) sh.count[c] = total;
  }
  __syncthreads();
  return R;
}

// One free transaction on one arena (mem, ctl), block-wide.  tables:
// free_txn_table_bytes of shared or global memory.
__device__ __forceinline__ void free_body(const ArenaDesc& d, int* mem,
                                          int* ctl, FreeLanes L,
                                          const int* sizes, int n,
                                          FreeShared& sh, int* tables) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int nwords = (d.num_chunks + 31) / 32;
  const int m = n / d.spc + 1;
  // tables: bitset (ceil(nc/32)) | rev ids (n) | rev class (n) |
  //         rank (n) | new segment chunks (C * m)
  unsigned* bitset = reinterpret_cast<unsigned*>(tables);
  int* rev_id = tables + nwords;
  int* rev_cls = rev_id + n;
  int* rank = rev_cls + n;
  int* newc = rank + n;

  for (int i = tid; i < d.ctl_words; i += nt)
    sh.ctl[i] = sh.old[i] = ctl[i];
  for (int i = tid; i < C; i += nt) sh.freed[i] = sh.nnew[i] = 0;
  for (int i = tid; i < nwords; i += nt) bitset[i] = 0u;
  for (int i = tid; i < C * m; i += nt) newc[i] = -1;
  __syncthreads();

  // R values to enqueue: a page kind's freed pages (lane j: its page,
  // ranked among the freed lanes of its class), or a chunk kind's
  // revived chunks in ascending id order (entry j: chunk rev_id[j])
  int R;
  if (d.kind == KIND_PAGE) {
    auto cls_of = [&](int i) {
      if (!L.sel(i)) return -1;
      const int c = size_class(d, sizes[i]);
      return (c < C && L.off(i) >= 0) ? c : -1;
    };
    rank_lanes(n, C, cls_of, rank, sh.count, sh.base, sh.warp);
    __syncthreads();
    R = n;
  } else {
    R = revive_chunks(d, mem, L, sizes, n, sh, bitset, rev_id, rev_cls,
                      rank);
  }

  // the family's bulk enqueue: thread 0 grows the queues, then the
  // values are written in parallel unless two could share a word (a
  // chunk kind's always may: pops from an exhausted pool repeat a chunk,
  // a class outside [0, C) shares a rank), when thread 0 writes them in
  // lane order, as the reference's scatter resolves them
  if (tid == 0) {
    Chain ch{d, mem, sh.ctl};
    grow_segments(d, ch, sh.count, sh.nnew, newc, m);
    sh.serial = d.kind == KIND_CHUNK
                || page_free_may_collide(d, ch, sh.count, sh.nnew, newc, m,
                                         bitset);
  }
  __syncthreads();
  if (d.family == FAM_RING)
    put_values<FAM_RING>(d, mem, sh, newc, m, L, sizes, rank, rev_id, rev_cls,
                         R);
  else if (d.family == FAM_VA)
    put_values<FAM_VA>(d, mem, sh, newc, m, L, sizes, rank, rev_id, rev_cls,
                       R);
  else
    put_values<FAM_VL>(d, mem, sh, newc, m, L, sizes, rank, rev_id, rev_cls,
                       R);
  __syncthreads();
  if (tid == 0) {
    Chain ch{d, mem, sh.ctl};
    enqueue_done(d, ch, sh.count, sh.nnew, newc, m);
    int zero[MAX_CLASSES] = {0};
    tele_apply(d, sh.old, sh.ctl, zero,
               d.kind == KIND_PAGE ? sh.count : sh.freed, zero, 0, 0);
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
  return alloc_scratch_ints(d, n) * sizeof(int);
}

extern "C" size_t free_txn_table_bytes(ArenaDesc d, int n) {
  const int nwords = (d.num_chunks + 31) / 32;
  const int m = n / d.spc + 1;
  return ((size_t)nwords + 3 * (size_t)n + (size_t)d.num_classes * m)
         * sizeof(int);
}

extern "C" size_t sharded_alloc_txn_table_bytes(ArenaDesc d, int n) {
  size_t b = (alloc_scratch_ints(d, n) + (size_t)n) * sizeof(int)
             + (size_t)n;
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
