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
// What bounds it on the H100: latency, not bandwidth or arithmetic, in
// every phase but the runs and a wide sharded alloc's partition.  A
// transaction touches a few kilobytes to a few megabytes.  A chunk kind's alloc is a chain of queue operations
// whose order fixes every later word (dequeue with its segment shrink,
// pool pop, bitmap claim, re-enqueue with segment grow): those steps are
// bound by their dependent global-memory round trips.  But most of a
// large grant is runs whose steps depend on their index alone: a
// dequeue run takes queued chunks whole, a whole-chunk run pops fresh
// chunks from the pool and takes all their pages.  A run is bound by its
// bytes (queue or pool ids, each chunk's free count and bitmap words,
// its grants) through one SM, a tile of a block's threads at a time.
// The lane passes (ranks, grants gathered) are bound by bytes too: n
// lanes' sizes, mask and offsets.
//
// Design: one thread block per transaction.  The layout, kind and
// family come in as a small struct of ints built once from the
// ArenaLayout, so a transaction makes no host reads.  Work with no order
// dependence runs block-wide: size class per lane (__clz), each lane's
// per-class rank (rank_lanes: warps walk contiguous runs of lanes, 32
// neighbours a step, a vote for the common one-class step, else ballots
// per class; a block scan per class), free's bit clears (atomics
// commute, so the result equals the reference's scatter-add), the
// ascending revived-chunk list (a bitset compacted by scan), and the
// telemetry counts.  The ctl block is staged in shared memory and
// written back once.  Heap, bitmap and queue words stay in global
// memory.
//
// An alloc whose arena can grant no lane (each class with lanes has an
// empty queue; a chunk kind's pool is empty too) changes no word but
// its failed counts, and skips the grants.
//
// Chunk kinds' alloc (chunk_grants), class-major in the reference's
// order, in phases.  Thread 0 takes every step whose order matters
// (chain_steps): dequeues that end a dequeue run, with the vl/va segment
// shrink and pool push they cause; the partial last chunk, with its
// enqueue and the segment it may pop; the exhausted break.  It records
// each step's claim (rank, offset base, page width, taken bits of one
// bitmap word) instead of writing grants.  The runs belong to the block:
//   - A dequeue run (dequeue_run): the longest prefix of the class queue
//     whose chunk ids rise strictly (no chunk twice), lie in [0, nc),
//     have a free count >= 1 equal to their free bits below ppc, and
//     whose free counts fit the lanes left.  Each of those steps takes
//     its chunk whole and leaves it out of the queue, so the block
//     writes their grants (ranks from a block scan of the free counts),
//     bitmap words and free counts, and thread 0 applies the m dequeues'
//     queue words (front, segments returned to the pool).  A retired
//     admission's chunks come back to the queue in ascending id order,
//     so the next admission takes them in one run.  A try needs
//     kMinDequeueRun entries or more, and after each one thread 0
//     dequeues the entry that ended it before the next.
//   - A whole-chunk run: with the class queue empty, the pool not and a
//     chunk's worth of lanes or more left, the next m = min(pool count,
//     lanes left / ppc) steps pop pool slots (pool_front + k) mod nc and
//     take every page: the block writes each chunk's bitmap words (its
//     ppc bits set), free count 0, class, and its ppc grants, and
//     pool_front advances by m.  Duplicate ids write identical words, as
//     the serial steps would (each resets its chunk first); an id
//     outside [0, nc) would read another chunk's free count (plain
//     indexing clamps), so a run holding one is left to thread 0: that
//     class goes on serially.
// After the chain the block expands the serial steps' records into the
// rank -> offset table, and each lane reads its grant.  Thread 0 adds
// what the chain took (runs and their chunks, serial steps, short and
// empty dequeue tries) to device counters, read and cleared by
// alloc_txn_chain_stats.  Free's revived chunks re-enter their queues
// through the family's bulk enqueue (ring slots; va directory grow; vl
// chain grow), their values written as a page kind's are (below): a
// revived chunk's class outside [0, C) ranks where another chunk does,
// so it is one more reason to write in lane order.  The free's bit
// clears and counts are summed over runs of neighbouring lanes that hit
// one word (a retirement's ascending offsets: 16 lanes a chunk) before
// one atomic a run.  A chunk kind's free too wide for shared memory (its
// lane tables in the workspace: a mamba2 retirement of 298,656 lanes)
// runs those two lane passes first over the whole card, as two launches
// (free_lanes_kernel), then its block(s) the rest: one block walking
// 298,656 lanes twice took most of the free's time.
//
// Page kinds: alloc grants each class the rank prefix that fits its
// inventory (rank < back - front); every granted lane gathers its value
// on its own (ring: the store slot front + rank; va: through the
// directory; vl: through a table of m + 1 chain hops per class, walked by
// one thread per class), then thread 0 returns the consumed segments to
// the pool class-major, segment-minor.  Free (both kinds) has thread 0
// pop and enter the new segments (va: directory slots; vl: terminated,
// then linked j-major), then the threads write the values at back + rank
// through the grown directory or chain, in parallel, unless two values
// could share a word (a ring class wider than its capacity, a counter
// crossing 2^31, two touched segments that are one chunk or one outside
// the heap: pops from an exhausted pool repeat chunks, a directory wraps
// max_segs; a revived chunk's class outside [0, C)): then thread 0
// writes them all in lane order, as the reference's scatter resolves
// them, loading a few entries ahead of its stores.  Device counters
// (free_txn_enqueue_stats) count the enqueues and values of each path.
//
// Lane tables (alloc's rank -> offset table or page-vl chain table, the
// sharded alloc's bucket lists and local offsets, free's chunk bitset,
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
// (home + a) % S == s, each step through the same transaction body as
// alloc_txn (alloc_body) on shard s's rows, its ctl block restaged in
// shared memory, and the served lanes' telemetry in walk bin
// min(a, d.walk_bins - 1).  The lanes are partitioned once by home into
// S bucket lists in lane order (a stable counting sort), and step (a, s)
// touches only bucket (s - a) mod S's unserved lanes, through a
// lane-index map, compacting the failed ones for the next attempt; a
// step whose bucket is empty changes no word and is skipped from the
// bucket's count.  Within one attempt the shards' lane sets are
// disjoint and their slabs independent, and attempt a + 1 on shard s
// depends only on attempt a on shard s - 1: a transaction wider than a
// warp is partitioned over the card, then runs an attempt a launch of S
// blocks, block s taking step (a, s), the kernel boundary ordering the
// attempts; a narrower one (a serving engine's: one bucket) runs the
// partition and every step in turn in one warp.  A free
// lane belongs to the one shard that owns its offset, so
// sharded_free_txn runs one block per shard, all independent, each
// through free_txn's body (free_body) on its slab.
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

// alloc's grant gather: lanes a thread whose loads are in flight at once
constexpr int kLaneUnroll = 4;

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
// local offsets (a sharded arena); with s = -1 those of every one of the
// S shards (the grid's lane passes), each in its shard's slot.
struct FreeLanes {
  const int* offs;
  const uint8_t* mask;
  int s, Ws;
  bool sharded;
  int S;
  __device__ int shard(int i) const { return fdiv(offs[i], Ws); }
  __device__ bool sel(int i) const {
    if (!mask[i]) return false;
    if (!sharded) return true;
    if (offs[i] < 0) return false;
    return s >= 0 ? shard(i) == s : shard(i) < S;
  }
  __device__ int slot(int i) const {
    return sharded && s < 0 ? shard(i) : 0;
  }
  __device__ int off(int i) const {
    return sharded ? offs[i] - (s >= 0 ? s : shard(i)) * Ws : offs[i];
  }
};

struct FreeShared {
  int ctl[MAX_CTL], old[MAX_CTL];
  int count[MAX_CLASSES], base[MAX_CLASSES], warp[32], freed[MAX_CLASSES];
  int nnew[MAX_CLASSES], rev, serial, bad_class;
  int tab[kClassTab];  // rank_lanes' class scan
};

// What the bulk enqueues of every free (single or sharded: one per
// block) since the last reset did, summed over launches: thread 0 adds
// its block's counts at the end of free_body, and free_txn_enqueue_stats
// reads and clears them.
enum FreeStat {
  FS_PAR_ENQUEUES,  // enqueues whose values the block wrote in parallel
  FS_PAR_VALUES,    // the values they wrote
  FS_SER_ENQUEUES,  // enqueues thread 0 wrote in lane order
  FS_SER_VALUES,    // the values it wrote
  kFreeStats
};
__device__ unsigned long long g_free_stats[kFreeStats];

// Each kernel's launches since the last reset (count_launch), read and
// cleared by alloc_txn_launch_stats: a call's kernels as they ran.
enum TxnLaunch {
  LS_ALLOC_TXN,
  LS_FREE_TXN,
  LS_FREE_LANES,
  LS_SHARDED_ALLOC_TXN,
  LS_SHARDED_ALLOC_COUNT,
  LS_SHARDED_ALLOC_PLACE,
  LS_SHARDED_ALLOC_ATTEMPT,
  LS_SHARDED_FREE_TXN,
  kTxnLaunches
};
__device__ unsigned long long g_txn_launches[kTxnLaunches];

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

// thread 0's lane-order loop loads this many entries ahead of its stores
// (a store to mem may alias the lane tables as far as the compiler
// knows, so it would otherwise wait for each entry after the last store)
constexpr int kPutBatch = 4;

// The values of a bulk enqueue (after its grow): a chunk kind's R
// revived chunks (class rev_cls[j] mod C, rank[j], value rev_id[j]) or a
// page kind's freed lanes (ranked lanes only), written in parallel, or
// on thread 0 in lane order when two could share a word (sh.serial).
template <int FAM>
__device__ __forceinline__ void put_values(const ArenaDesc& d, int* mem,
                                           const FreeShared& sh,
                                           const int* newc, int m,
                                           FreeLanes L, const int* sizes,
                                           const int* rank, const int* rev_id,
                                           const int* rev_cls, int R) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const bool chunks = d.kind == KIND_CHUNK;
  // entry j as (class, rank within it, value); class -1: nothing to write
  auto entry = [&](int j, int& c, int& r, int& val) {
    r = val = 0;
    if (chunks) {
      c = fmodi(rev_cls[j], C);
      r = rank[j];
      val = rev_id[j];
    } else if (rank[j] < 0) {
      c = -1;
    } else {
      c = size_class(d, sizes[j]);
      r = rank[j] - sh.base[c];
      val = L.off(j);
    }
  };
  if (!sh.serial) {
    for (int j = tid; j < R; j += nt) {
      int c, r, val;
      entry(j, c, r, val);
      if (c >= 0) put_value<FAM>(d, mem, sh, newc, m, c, r, val);
    }
  } else if (tid == 0) {
    for (int j0 = 0; j0 < R; j0 += kPutBatch) {
      int c[kPutBatch], r[kPutBatch], val[kPutBatch];
#pragma unroll
      for (int u = 0; u < kPutBatch; ++u) {
        c[u] = -1;
        if (j0 + u < R) entry(j0 + u, c[u], r[u], val[u]);
      }
#pragma unroll
      for (int u = 0; u < kPutBatch; ++u)
        if (c[u] >= 0) put_value<FAM>(d, mem, sh, newc, m, c[u], r[u], val[u]);
    }
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

// What the chunk chains of every alloc (single or sharded) since the last
// reset did, summed over launches: thread 0 adds its launch's counts at
// the end of chunk_grants, and alloc_txn_chain_stats reads and clears
// them, so a caller sees the runs a transaction took without working
// out the chain's rules again.
enum ChainStat {
  CS_CHAINS,          // class chains: a class with lanes in a chunk kind's alloc
  CS_SERIAL_STEPS,    // thread 0's steps: dequeues and pool pops
  CS_WHOLE_RUNS,      // whole-chunk runs the block took
  CS_WHOLE_CHUNKS,    // the chunks they took
  CS_DEQ_TRIES,       // dequeue runs tried
  CS_DEQ_CHUNKS,      // the chunks they took
  CS_DEQ_SHORT,       // tries that took fewer than kMinDequeueRun chunks
  CS_DEQ_EMPTY,       // tries that took none
  CS_SERIAL_CLASSES,  // chains left serial by a pool id outside [0, nc)
  kChainStats
};
__device__ unsigned long long g_chain_stats[kChainStats];

struct AllocShared {
  int ctl[MAX_CTL], old[MAX_CTL];
  int count[MAX_CLASSES], base[MAX_CLASSES], take[MAX_CLASSES], warp[32];
  int served[MAX_CLASSES], failed[MAX_CLASSES];
  int cserved, run, nrec;  // the chunk chain's hand-off (chunk_grants)
  int none;                // alloc_body: no lane can be granted
  int cut, qpages, edge[33];  // a dequeue run's tile (dequeue_run)
  unsigned st[kChainStats];  // this launch's chain statistics
  int tab[kClassTab];  // rank_lanes' class scan
};

// A serial chain step's claim in one bitmap word, for the block to expand
// into grants: ranks rank.. get base_off + b * pw for the set bits b of
// take, ascending.
struct StepRec {
  int rank, base_off, pw;
  unsigned take;
};
constexpr int kRecInts = sizeof(StepRec) / sizeof(int);
// a dequeue run is tried over at least this many queue entries (fewer
// stay serial); a guess, not a measured optimum
constexpr int kMinDequeueRun = 16;

// Scratch ints of one alloc transaction's body: the chunk kinds' rank ->
// offset table and step records (n of each: every record claims at
// least one rank) and a dequeue run's vl chain (n / spc + 2), or the
// page-vl chain table (C, n / spc + 2).
__host__ __device__ inline size_t alloc_scratch_ints(const ArenaDesc& d,
                                                     int n) {
  if (d.kind == KIND_CHUNK)
    return (size_t)n * (1 + kRecInts) + (size_t)(n / d.spc + 2);
  if (d.family == FAM_VL)
    return (size_t)d.num_classes * (size_t)(n / d.spc + 2);
  return 0;
}

// The bits of bitmap word w below a chunk's ppc pages.
__device__ __forceinline__ unsigned word_range(int ppc, int w) {
  const int rem = ppc - w * 32;
  return rem >= 32 ? 0xffffffffu : (rem <= 0 ? 0u : ((1u << rem) - 1u));
}

// Thread 0: class c's chain steps from sh.cserved lanes served on, in
// the reference's order, each claim recorded in rec (the block writes
// the grants), until the class is served or the pool is exhausted
// (returns 0), or, unless `serial`, a run the block takes begins:
// - the class queue empty, the pool not, ppc or more lanes left: a
//   whole-chunk run of m = min(pool count, lanes left / ppc) pool chunks
//   (returns m > 0);
// - Q = min(queue count, lanes left) >= kMinDequeueRun, the queue's
//   counters far from 2^31, and not `hold` (set after a dequeue run: the
//   entry that ended it is dequeued here first, so every try makes
//   progress): a dequeue run may take the next Q queue entries (returns
//   -Q; for vl, chain[j] is the j-th segment from the head).
// No step of a run is taken here.
__device__ __forceinline__ int chain_steps(const ArenaDesc& d, int* mem,
                                           AllocShared& sh, int c,
                                           StepRec* rec, int cap,
                                           bool serial, bool& hold,
                                           int* chain) {
  Chain ch{d, mem, sh.ctl};
  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  int* chunk_class = mem + d.class_off;
  const int nc = d.num_chunks, bw = d.bw, spc = d.spc;
  const int cnt = sh.count[c], base = sh.base[c];
  const int ppc = d.max_ppc >> c, pw = d.min_page_words << c;
  int served = sh.cserved, nrec = sh.nrec, run = 0;
  while (served < cnt) {
    int chunk;
    if (ch.count(c) > 0) {
      const int q = min(ch.count(c), cnt - served), f0 = ch.front(c);
      if (!serial && !hold && q >= kMinDequeueRun
          && (long long)f0 + q <= 0x7fffffffLL) {
        if (d.family == FAM_VL) {
          const int hops = fdiv(f0 + q, spc) - fdiv(f0, spc);
          int h = ch.head(c);
          chain[0] = h;
          for (int j = 1; j <= hops; ++j) {
            h = h >= 0 ? heap_get(mem, seg_word(h, d.wpc, 0), d.total_words,
                                  -1) : -1;
            chain[j] = h;
          }
        }
        run = -q;
        break;
      }
      hold = false;
      chunk = ch.dequeue1(c);
    } else {
      if (ch.pool_count() <= 0) break;  // exhausted
      if (!serial && cnt - served >= ppc) {
        run = min(ch.pool_count(), (cnt - served) / ppc);
        break;
      }
      chunk = ch.pool_pop();
      if (chunk >= 0 && chunk < nc) {
        for (int w = 0; w < bw; ++w) bitmap[chunk * bw + w] = 0u;
        free_count[chunk] = ppc;
        chunk_class[chunk] = c;
      }
    }
    ++sh.st[CS_SERIAL_STEPS];
    const bool in_range = chunk >= 0 && chunk < nc;
    const int row = clamp_chunk(chunk, nc);
    const int f = free_count[row];
    const int t = min(cnt - served, f);
    int k = 0;
    for (int w = 0; w < bw && k < t; ++w) {
      unsigned freeb = ~bitmap[row * bw + w] & word_range(ppc, w);
      unsigned take = 0u;
      if (__popc(freeb) <= t - k) {
        take = freeb;
      } else {
        for (int j = k; j < t; ++j) {
          take |= freeb & (0u - freeb);
          freeb &= freeb - 1u;
        }
      }
      if (!take) continue;
      if (nrec < cap)
        rec[nrec] = StepRec{base + served + k,
                            add32(mul32(chunk, d.wpc), mul32(w * 32, pw)),
                            pw, take};
      ++nrec;
      k += __popc(take);
      if (in_range) bitmap[chunk * bw + w] += take;
    }
    if (in_range) free_count[chunk] -= k;
    if (free_count[row] > 0) ch.enqueue1(c, chunk);
    served += t;
  }
  sh.cserved = served;
  sh.nrec = nrec;
  return run;
}

// A dequeue run of class c, block-wide, over the next Q queue entries
// (front f0 + k): its length m is the longest prefix whose chunk ids
// rise strictly (so no chunk repeats), lie in [0, nc), each with a free
// count f >= 1 equal to its free bits below ppc, and whose free counts
// sum to at most the lanes left.  Each such serial step would dequeue
// its chunk and take every free page, leaving it full and out of the
// queue, and no step reads a word another writes: the block writes
// every chunk's grants (its free bits ascending, at ranks from the
// prefix sum of the free counts), bitmap words and free count 0, a tile
// of nt entries at a time.  Thread 0 then applies the m dequeues' queue
// words: front + m, and a va/vl segment returned to the pool each time
// the front crosses one (vl: the head moves along the chain).  Returns
// m; sh.qpages gets the lanes it served.
__device__ __forceinline__ int dequeue_run(const ArenaDesc& d, int* mem,
                                           AllocShared& sh, int c, int Q,
                                           int* grant, const int* chain) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int wid = tid >> 5;
  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  const int nc = d.num_chunks, bw = d.bw, spc = d.spc, wpc = d.wpc;
  const int ppc = d.max_ppc >> c, pw = d.min_page_words << c;
  const int f0 = sh.ctl[c], rem = sh.count[c] - sh.cserved;
  const int first = sh.base[c] + sh.cserved;
  auto val_of = [&](int k) {  // the value dequeue1 would read at f0 + k
    const int v = f0 + k;
    if (d.family == FAM_RING)
      return mem[d.queue_off + c * d.queue_cap + fmodi(v, d.queue_cap)];
    int seg, off;
    if (d.family == FAM_VA) {
      seg = mem[d.queue_off + c * d.max_segs + fmodi(fdiv(v, spc),
                                                     d.max_segs)];
      off = fmodi(v, spc);
    } else {
      seg = chain[fdiv(v, spc) - fdiv(f0, spc)];
      off = 1 + fmodi(v, spc);
    }
    return heap_get(mem, seg_word(seg, wpc, off), d.total_words, -1);
  };
  if (tid == 0) sh.edge[0] = -1;
  int carry = 0, m = 0;
  for (int t0 = 0; t0 < Q; t0 += nt) {
    const int k = t0 + tid;
    int id = -1, f = 0;
    bool ok = k < Q;
    if (ok) {
      id = val_of(k);
      ok = id >= 0 && id < nc;
    }
    if (ok) {
      f = free_count[id];
      int freeb = 0;
      for (int w = 0; w < bw; ++w)
        freeb += __popc(~bitmap[id * bw + w] & word_range(ppc, w));
      ok = f >= 1 && freeb == f;
    }
    const int up = __shfl_up_sync(0xffffffffu, id, 1);
    if (lane == 31) sh.edge[wid + 1] = id;
    if (tid == 0) sh.cut = nt;
    __syncthreads();
    ok = ok && id > (lane ? up : sh.edge[wid]);
    int total;
    const int excl = block_excl_scan(ok ? f : 0, &total, sh.warp);
    ok = ok && carry + excl + f <= rem;
    if (k < Q && !ok) atomicMin(&sh.cut, tid);
    __syncthreads();
    const int cut = min(sh.cut, Q - t0);
    if (tid < cut) {
      int r = first + carry + excl;
      for (int w = 0; w < bw; ++w) {
        const unsigned old = bitmap[id * bw + w];
        unsigned bits = ~old & word_range(ppc, w);
        bitmap[id * bw + w] = old | bits;
        while (bits) {
          grant[r++] = id * wpc + (w * 32 + __ffs(bits) - 1) * pw;
          bits &= bits - 1u;
        }
      }
      free_count[id] = 0;
    }
    if (tid == cut - 1) sh.qpages = carry + excl + f;
    if (tid == nt - 1) sh.edge[0] = id;
    __syncthreads();
    m = t0 + cut;
    if (cut < nt) break;
    carry = sh.qpages;
  }
  if (m == 0 && tid == 0) sh.qpages = 0;
  __syncthreads();
  if (tid == 0 && m > 0) {
    Chain ch{d, mem, sh.ctl};
    const int nfree = d.family == FAM_RING
                          ? 0 : fdiv(f0 + m, spc) - fdiv(f0, spc);
    for (int j = 0; j < nfree; ++j)
      ch.pool_push(d.family == FAM_VA ? ch.dir(c, fdiv(f0, spc) + j)
                                      : chain[j]);
    if (d.family == FAM_VL && nfree > 0) ch.head(c) = chain[nfree];
    ch.front(c) = f0 + m;
  }
  return m;
}

// Chunk kinds, block-wide, class-major in the reference's order.  Thread
// 0 takes every step whose order matters (chain_steps): dequeues whose
// chunks break a dequeue run, with their segment shrinks and pool
// pushes; the partial last chunk, with its enqueue and segment pop; the
// exhausted break.  The runs belong to the block.  A dequeue run
// (dequeue_run) takes queued chunks whole.  A whole-chunk run pops m
// chunks from the pool slots (pool_front + k) mod nc, so the block
// writes each chunk's bitmap words (its ppc bits set), free count 0 and
// class, and its ppc grants, then advances pool_front by m.  Duplicate
// ids in it write identical words, as the serial steps would (each
// resets its chunk first).  An id outside [0, nc) would read another
// chunk's free count (plain indexing clamps), so a run holding one is
// left to thread 0: that class goes on serially.  After a dequeue run
// thread 0 takes one serial dequeue (the entry that ended it) before
// the next is tried.  Last, the block expands the serial steps' records
// and thread 0 adds the launch's chain statistics.
// grant: the rank -> offset table (n ints, -1 filled); rec: n records;
// chain: n / spc + 2 ints.
__device__ __forceinline__ void chunk_grants(const ArenaDesc& d, int* mem,
                                             AllocShared& sh, int* grant,
                                             StepRec* rec, int* chain,
                                             int n) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int nc = d.num_chunks, bw = d.bw, wpc = d.wpc;
  unsigned* bitmap = reinterpret_cast<unsigned*>(mem + d.bitmap_off);
  int* free_count = mem + d.free_off;
  int* chunk_class = mem + d.class_off;
  if (tid == 0) {
    sh.nrec = 0;
    for (int k = 0; k < kChainStats; ++k) sh.st[k] = 0u;
  }
  for (int c = 0; c < C; ++c) {
    if (sh.count[c] <= 0) continue;  // uniform: written before a barrier
    const int ppc = d.max_ppc >> c, pw = d.min_page_words << c;
    bool serial = false, hold = false;  // hold: thread 0's
    if (tid == 0) {
      sh.cserved = 0;
      ++sh.st[CS_CHAINS];
    }
    for (;;) {
      if (tid == 0)
        sh.run = chain_steps(d, mem, sh, c, rec, n, serial, hold, chain);
      __syncthreads();
      const int code = sh.run;
      if (code < 0) {  // a dequeue run
        const int m = dequeue_run(d, mem, sh, c, -code, grant, chain);
        if (tid == 0) {
          sh.cserved += sh.qpages;
          sh.served[c] += sh.qpages;  // in-range chunks: grants >= 0
          hold = true;
          ++sh.st[CS_DEQ_TRIES];
          sh.st[CS_DEQ_CHUNKS] += m;
          sh.st[CS_DEQ_SHORT] += m < kMinDequeueRun;
          sh.st[CS_DEQ_EMPTY] += m == 0;
        }
        __syncthreads();
        continue;
      }
      const int m = code, pf = sh.ctl[4 * C];
      const int first = sh.base[c] + sh.cserved;
      auto id_of = [&](int k) {
        return mem[d.pool_off + fmodi(add32(pf, k), nc)];
      };
      int bad = 0;
      for (int k = tid; k < m; k += nt) {
        const int id = id_of(k);
        bad |= id < 0 || id >= nc;
      }
      // also the barrier between the reads above and thread 0's writes
      if (__syncthreads_or(bad)) {
        serial = true;
        if (tid == 0) ++sh.st[CS_SERIAL_CLASSES];
        continue;
      }
      if (m == 0) break;
      for (int k = tid; k < m; k += nt) {
        const int id = id_of(k);
        for (int w = 0; w < bw; ++w) bitmap[id * bw + w] = word_range(ppc, w);
        free_count[id] = 0;
        chunk_class[id] = c;
      }
      const int lg = __ffs(ppc) - 1;  // ppc is a power of two
      for (int e = tid; e < m * ppc; e += nt)
        grant[first + e] = id_of(e >> lg) * wpc + (e & (ppc - 1)) * pw;
      __syncthreads();
      if (tid == 0) {
        sh.ctl[4 * C] = add32(pf, m);
        sh.cserved += m * ppc;
        sh.served[c] += m * ppc;  // in-range chunks: every grant >= 0
        ++sh.st[CS_WHOLE_RUNS];
        sh.st[CS_WHOLE_CHUNKS] += m;
      }
    }
  }
  __syncthreads();
  const int R = min(sh.nrec, n);
  for (int r = tid; r < R; r += nt) {
    const StepRec s = rec[r];
    unsigned bits = s.take;
    int ok = 0;
    for (int k = s.rank; bits; ++k) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1u;
      const int g = add32(s.base_off, mul32(b, s.pw));
      if (k >= 0 && k < n) grant[k] = g;
      ok += g >= 0;
    }
    // the class of a page width: pw = min_page_words << c
    atomicAdd(&sh.served[__ffs(s.pw / d.min_page_words) - 1], ok);
  }
  if (tid == 0)
    for (int k = 0; k < kChainStats; ++k)
      if (sh.st[k]) atomicAdd(&g_chain_stats[k], sh.st[k]);
}

// Page kinds: each class grants the rank prefix below its inventory
// (back - front); each granted lane (out[i]: its class-major rank, turned
// into its value here) gathers its value on its own; thread 0 then
// returns the consumed segments to the pool and advances the counters.
// chain: the page-vl chain table (C, m + 1).
template <class Lanes>
__device__ __forceinline__ void page_grants(const ArenaDesc& d, int* mem,
                                            Lanes L, int n, int* out,
                                            AllocShared& sh, int* chain) {
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
    const int c = size_class(d, L.size(i));
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

// The lanes a transaction body serves: lane k's size in bytes and
// whether it is selected.  alloc_txn's instance reads the caller's
// arrays; a sharded step's reads the compacted list of its lanes (every
// one selected, in lane order, so the body's ranks are the reference's).
struct MaskLanes {
  const int* sizes;
  const uint8_t* mask;
  __device__ int size(int k) const { return sizes[k]; }
  __device__ bool on(int k) const { return mask[k] != 0; }
};

struct ListLanes {
  const int* sz;
  __device__ int size(int k) const { return sz[k]; }
  __device__ bool on(int) const { return true; }
};

// One alloc transaction on one arena (mem, ctl) for the selected lanes
// of L, block-wide; out[k] receives lane k's local word offset, -1 for a
// failed or unselected lane.  scratch: alloc_scratch_ints(d, n) ints of
// shared or global memory.  Served lanes count in walk bin walk_bin, and
// sh.served[c] holds the lanes of class c served.
template <class Lanes>
__device__ __forceinline__ void alloc_body(
    const ArenaDesc& d, int* mem, int* ctl, Lanes L, int n, int* out,
    int walk_bin, AllocShared& sh, int* scratch) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt)
    sh.ctl[i] = sh.old[i] = ctl[i];
  for (int i = tid; i < C; i += nt) sh.served[i] = sh.failed[i] = 0;
  if (d.kind == KIND_CHUNK)
    for (int i = tid; i < n; i += nt) scratch[i] = -1;
  auto cls_of = [&](int i) {  // both loads issued at once
    const bool on = L.on(i);
    const int c = size_class(d, L.size(i));
    return on && c < C ? c : -1;
  };
  rank_lanes(n, C, cls_of, [&](int i, int, int r) { out[i] = r; }, sh.count,
             sh.base, sh.tab);
  // An arena that can grant no lane (every class with lanes has an
  // empty queue and, for a chunk kind, the pool is empty too: the chain
  // of each such class ends before its first step) changes no word but
  // its failed counts: the grants are skipped.  A sharded alloc's steps
  // on an exhausted shard under pressure take this path.
  if (tid == 0) {
    Chain ch{d, mem, sh.ctl};
    bool none = d.kind != KIND_CHUNK || ch.pool_count() <= 0;
    for (int c = 0; c < C && none; ++c)
      none = sh.count[c] == 0 || ch.count(c) <= 0;
    sh.none = none;
  }
  __syncthreads();

  if (sh.none) {
    for (int i = tid; i < n; i += nt) out[i] = -1;
    if (tid == 0) {
      int chains = 0;  // chunk_grants counts each class with lanes
      for (int c = 0; c < C; ++c) {
        sh.failed[c] = sh.count[c];
        chains += sh.count[c] > 0;
      }
      if (d.kind == KIND_CHUNK && chains)
        atomicAdd(&g_chain_stats[CS_CHAINS], (unsigned long long)chains);
    }
  } else if (d.kind == KIND_CHUNK) {
    chunk_grants(d, mem, sh, scratch, reinterpret_cast<StepRec*>(scratch + n),
                 scratch + (size_t)n * (1 + kRecInts), n);
  } else {
    page_grants(d, mem, L, n, out, sh, scratch);
  }
  __syncthreads();

  if (sh.none) {
    // every lane failed (counted above)
  } else if (d.kind == KIND_CHUNK) {
    // each ranked lane's grant through the rank -> offset table,
    // kLaneUnroll lanes a thread at once (their loads in flight
    // together); chunk_grants counted each class's grants >= 0
    for (int i0 = 0; i0 < n; i0 += nt * kLaneUnroll) {
      int r[kLaneUnroll];
#pragma unroll
      for (int u = 0; u < kLaneUnroll; ++u) {
        const int i = i0 + u * nt + tid;
        r[u] = i < n ? out[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kLaneUnroll; ++u)
        if (r[u] >= 0) out[i0 + u * nt + tid] = scratch[r[u]];
    }
  } else {
    // each ranked lane's value, and the per-class served / failed
    // lanes, counted a warp at a time (one ballot a class and outcome)
    for (int i0 = 0; i0 < n; i0 += nt) {
      const int i = i0 + tid;
      const int c = i < n ? cls_of(i) : -1;
      const bool ok = c >= 0 && out[i] >= 0;
      for (int k = 0; k < C; ++k) {
        const unsigned s = __ballot_sync(0xffffffffu, c == k && ok);
        const unsigned f = __ballot_sync(0xffffffffu, c == k && !ok);
        if ((tid & 31) == 0) {
          if (s) atomicAdd(&sh.served[k], __popc(s));
          if (f) atomicAdd(&sh.failed[k], __popc(f));
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (d.kind == KIND_CHUNK)
      for (int c = 0; c < C; ++c) sh.failed[c] = sh.count[c] - sh.served[c];
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
  count_launch(g_txn_launches, LS_ALLOC_TXN);
  alloc_body(d, mem, ctl, MaskLanes{sizes, mask}, n, out, 0, sh,
             kWs ? ws : dyn);
}

// ---- sharded alloc ----------------------------------------------------------
//
// Step (a, s) of the overflow walk serves on shard s the still-unserved
// selected lanes whose (home + a) mod S is s.  A home h that does not
// wrap at 32 bits within the walk (h <= INT_MAX - walk) puts its lane in
// bucket b = h mod S, served at step (a, (b + a) mod S): each bucket
// visits one shard an attempt.  So the lanes are partitioned once, by a
// stable counting sort over the S buckets (key S: a selected lane whose
// home wraps), into bucket lists in lane order (lane index and size),
// bucket b at base[b]; step (a, s) runs the body over bucket (s - a) mod
// S's list only, writes each lane's global offset or -1, and compacts
// the failed lanes, in order, to the list's front for the next attempt.
// A bucket's empty steps are skipped from its count.  A wrapping home,
// or more shards than a ballot's lanes hold keys (S > kMaxShards), sends
// the whole transaction to per-step lists, each found by a pass over all
// n lanes (run_steps), which rank one key and so take any S.
//
// A transaction of at most a warp's lanes runs in one warp-sized block
// (sharded_alloc_txn_kernel: the partition, then every step in turn).
// A wider one partitions over the card (sharded_alloc_count_kernel,
// sharded_alloc_place_kernel: tiles of kPartLanes lanes, each placing
// its lanes after the earlier tiles' of the same bucket), then runs an
// attempt a launch of S blocks (sharded_alloc_attempt_kernel), block s
// taking step (a, s): within an attempt the shards' lane sets are
// disjoint and their slabs independent, and the kernel boundary orders
// (a, s - 1) before (a + 1, s), so no block waits for another.

constexpr int kMaxShards = 31;       // bucket lists: S buckets + the
                                     // wrapping key <= 32
constexpr int kKeys = kMaxShards + 1;  // a table's stride in keys

// What every sharded alloc since the last reset did, summed over
// launches by thread 0 of the block concerned: read and cleared by
// alloc_txn_shard_stats.
enum ShardStat {
  SS_TXNS,        // sharded alloc transactions
  SS_STEPS,       // (attempt, shard) steps that ran the body
  SS_STEP_LANES,  // the lanes those steps took
  SS_RESCANS,     // transactions on per-step lists (a home wraps, or
                  // S > kMaxShards)
  kShardStats
};
__device__ unsigned long long g_shard_stats[kShardStats];

struct ShardLists {
  int* idx;    // lane indices, bucket-major (n)
  int* sz;     // their sizes (n)
  int* local;  // the body's rank, then local offset, of each entry (n)
};

// A lane's partition key: its bucket, S when its home wraps within the
// walk, -1 when unselected (both loads issued at once).
__device__ __forceinline__ int lane_key(int i, int S, int walk,
                                        const uint8_t* mask,
                                        const int* home) {
  const bool on = mask[i];
  const int h = home[i];
  return on ? (h > 0x7fffffff - walk ? S : fmodi(h, S)) : -1;
}

// Step (a, s), block-wide, over the m entries at the front of a list
// (idx, sz, local): the transaction body on shard s's rows, each lane's
// GLOBAL offset (s * Ws + local) or -1 into out, and the failed entries
// compacted, in order, to the front for the next attempt (a tile of nt
// at a time, after a scan; a step that served all or none writes in one
// pass).  Returns their number.
__device__ __forceinline__ int serve_step(
    const ArenaDesc& d, int* mem, int* ctl, int Mw, int Cw, int a, int s,
    int* out, int* idx, int* sz, int* local, int m, AllocShared& sh,
    int* scratch) {
  const int tid = threadIdx.x, nt = blockDim.x, Ws = d.total_words;
  if (tid == 0) {
    atomicAdd(&g_shard_stats[SS_STEPS], 1ull);
    atomicAdd(&g_shard_stats[SS_STEP_LANES], (unsigned long long)m);
  }
  alloc_body(d, mem + (long long)s * Mw, ctl + (long long)s * Cw,
             ListLanes{sz}, m, local, min(a, d.walk_bins - 1), sh, scratch);
  __syncthreads();
  int fails = m;  // every served lane has a grant >= 0 (alloc_body)
  for (int c = 0; c < d.num_classes; ++c) fails -= sh.served[c];
  if (fails == 0 || fails == m) {
    for (int k = tid; k < m; k += nt) {
      const int g = local[k];
      out[idx[k]] = g >= 0 ? s * Ws + g : -1;
    }
    return fails;
  }
  int carry = 0;
  for (int t0 = 0; t0 < m; t0 += nt) {
    const int k = t0 + tid;
    int i = 0, z = 0, g = 0;
    if (k < m) {
      i = idx[k];
      z = sz[k];
      g = local[k];
      out[i] = g >= 0 ? s * Ws + g : -1;
    }
    const bool fail = k < m && g < 0;
    int total;
    const int r = carry + block_excl_scan(fail, &total, sh.warp);
    if (fail) {
      idx[r] = i;
      sz[r] = z;
    }
    carry += total;
  }
  return carry;
}

// The scratch of bucket b's step among the buckets' slices in the
// workspace: the slices of the buckets before it, sized by their counts
// at the partition (base differences).
__device__ __forceinline__ size_t bucket_scratch_off(const ArenaDesc& d,
                                                     const int* base, int b) {
  size_t off = 0;
  for (int k = 0; k < b; ++k)
    off += alloc_scratch_ints(d, base[k + 1] - base[k]);
  return off;
}

// The steps (a, s), a in [a0, a1] and s in [s0, s1], in order,
// block-wide.  Each runs over its bucket's list (cnt[b] unserved
// entries at base[b]; its failures compacted back and counted in
// cnt[b]) or, when a home wraps, over a list found by a pass over all n
// lanes (selected, unserved, (home + a) mod S == s in 32-bit wrapping
// arithmetic, as the reference computes it) at the lists' front, out
// already -1.  scratch: every step's, or with `slices` bucket b's at
// bucket_scratch_off.  One call site of the body, so a kernel carries
// one copy of it.
__device__ void run_steps(const ArenaDesc& d, int* mem, int* ctl, int S,
                          int Mw, int Cw, const int* sizes,
                          const uint8_t* mask, const int* home, int n,
                          int* out, ShardLists L, AllocShared& sh,
                          int* scratch, bool slices, int* cnt,
                          const int* base, bool wraps, int a0, int a1,
                          int s0, int s1) {
  for (int a = a0; a <= a1; ++a) {
    for (int s = s0; s <= s1; ++s) {
      const int b = fmodi(s - a, S);
      int m, at = 0;
      size_t off = 0;
      if (wraps) {
        __syncthreads();
        auto key = [&](int i) {
          return mask[i] && fmodi(add32(home[i], a), S) == s && out[i] < 0
                     ? 0 : -1;
        };
        rank_lanes(n, 1, key, [&](int i, int c, int r) {
          if (c == 0) {
            L.idx[r] = i;
            L.sz[r] = sizes[i];
          }
        }, sh.count, sh.base, sh.tab);
        __syncthreads();
        m = sh.count[0];
      } else {
        m = cnt[b];
        at = base[b];
        if (slices) off = bucket_scratch_off(d, base, b);
      }
      if (m == 0) continue;  // uniform: written before a barrier
      const int f = serve_step(d, mem, ctl, Mw, Cw, a, s, out, L.idx + at,
                               L.sz + at, L.local + at, m, sh,
                               scratch + off);
      if (!wraps && threadIdx.x == 0) cnt[b] = f;
      __syncthreads();
    }
  }
}

// A transaction of at most a warp's lanes (n <= 32) in one block of 32
// threads, its tables in dynamic shared memory: the partition, a lane a
// thread (a ballot a key gives each lane its rank among its bucket's),
// then every step in turn.  mem/ctl are (S, Mw) / (S, Cw) row-major; out
// receives GLOBAL offsets.
// tables: idx (n) | sz (n) | local (n) | scratch (alloc_scratch_ints)
__global__ void __launch_bounds__(32)
sharded_alloc_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                         int S, int Mw, int Cw,
                         const int* sizes,
                         const uint8_t* mask,
                         const int* home, int n, int walk,
                         int* out) {
  __shared__ AllocShared sh;
  __shared__ int s_cnt[kKeys], s_base[kKeys];
  extern __shared__ int dyn[];  // the lane tables
  const ShardLists L{dyn, dyn + n, dyn + 2 * n};
  const int i = threadIdx.x;
  const bool many = S > kMaxShards;  // uniform: no bucket lists
  count_launch(g_txn_launches, LS_SHARDED_ALLOC_TXN);
  int key = -1, z = 0;
  if (i < n) {  // the three loads issued at once
    key = lane_key(i, S, walk, mask, home);
    z = sizes[i];
  }
  int start = 0, rank = 0;
  for (int k = 0; !many && k <= S; ++k) {  // bucket-major, lane order
    const unsigned b = __ballot_sync(0xffffffffu, key == k);
    if (key == k) rank = start + __popc(b & ((1u << i) - 1u));
    if (i == 0) {
      s_cnt[k] = __popc(b);
      s_base[k] = start;
    }
    start += __popc(b);
  }
  const bool wraps = many || __ballot_sync(0xffffffffu, key == S) != 0u;
  if (i < n) {
    if (key < 0 || wraps) {
      out[i] = -1;
    } else {
      L.idx[rank] = i;
      L.sz[rank] = z;
    }
  }
  if (i == 0) {
    atomicAdd(&g_shard_stats[SS_TXNS], 1ull);
    if (wraps) atomicAdd(&g_shard_stats[SS_RESCANS], 1ull);
  }
  __syncthreads();
  run_steps(d, mem, ctl, S, Mw, Cw, sizes, mask, home, n, out, L, sh,
            dyn + 3 * n, false, s_cnt, s_base, wraps, 0, walk, 0, S - 1);
}

// The partition of a wide transaction, over tiles of kPartLanes lanes.
// lists: cnt (kKeys) | base (kKeys) | wraps (1) | each tile's key
//        counts (tiles x kKeys) | idx (n) | sz (n)
constexpr int kPartThreads = 1024;
constexpr int kPartLanes = 2048;

__host__ __device__ inline int part_tiles(int n) {
  const int t = (n + kPartLanes - 1) / kPartLanes;
  return t > 0 ? t : 1;
}

struct GridLists {
  int *cnt, *base, *wraps, *tiles;
  ShardLists L;
  __device__ GridLists(int* lists, int n, int* local)
      : cnt(lists), base(lists + kKeys), wraps(lists + 2 * kKeys),
        tiles(lists + 2 * kKeys + 1),
        L{tiles + (size_t)part_tiles(n) * kKeys,
          tiles + (size_t)part_tiles(n) * kKeys + n, local} {}
};

// Pass 1: each tile's count of each key (a ballot a key and 32 lanes).
__global__ void __launch_bounds__(kPartThreads)
sharded_alloc_count_kernel(int n, int S, int walk, const uint8_t* mask,
                           const int* home, int* lists) {
  __shared__ int s_cnt[kKeys];
  const int tid = threadIdx.x, t0 = blockIdx.x * kPartLanes;
  const int len = min(kPartLanes, n - t0);
  GridLists G(lists, n, nullptr);
  count_launch(g_txn_launches, LS_SHARDED_ALLOC_COUNT);
  if (tid < kKeys) s_cnt[tid] = 0;
  __syncthreads();
  for (int i0 = 0; i0 < len; i0 += kPartThreads) {  // uniform trips
    const int i = i0 + tid;
    const int k = i < len ? lane_key(t0 + i, S, walk, mask, home) : -1;
    for (int c = 0; c <= S; ++c) {
      const unsigned bits = __ballot_sync(0xffffffffu, k == c);
      if ((tid & 31) == 0 && bits) atomicAdd(&s_cnt[c], __popc(bits));
    }
  }
  __syncthreads();
  if (tid <= S) G.tiles[(size_t)blockIdx.x * kKeys + tid] = s_cnt[tid];
}

// Pass 2: each tile places its lanes: key k's entries of this tile go
// after every entry of the keys below k and those of key k in earlier
// tiles, in lane order within the tile (rank_lanes); unselected lanes'
// out are -1.  Block 0 records every bucket's count and place and
// whether a home wraps; with one, no list is written.
__global__ void __launch_bounds__(kPartThreads)
sharded_alloc_place_kernel(int n, int S, int walk, const int* sizes,
                           const uint8_t* mask, const int* home, int* out,
                           int* lists) {
  __shared__ int s_tab[kClassTab];
  __shared__ int s_cnt[kKeys], s_base[kKeys], s_tot[kKeys], s_before[kKeys];
  const int tid = threadIdx.x, lane = tid & 31, tile = blockIdx.x;
  const int t0 = tile * kPartLanes, len = min(kPartLanes, n - t0);
  GridLists G(lists, n, nullptr);
  count_launch(g_txn_launches, LS_SHARDED_ALLOC_PLACE);
  if (tid < kKeys) s_tot[tid] = s_before[tid] = 0;
  __syncthreads();
  for (int t = tid >> 5; t < part_tiles(n); t += kPartThreads / 32)
    if (lane <= S) {
      const int v = G.tiles[(size_t)t * kKeys + lane];
      atomicAdd(&s_tot[lane], v);
      if (t < tile) atomicAdd(&s_before[lane], v);
    }
  __syncthreads();
  if (tid < 32) {  // key k's first place: the keys below it, then its
                   // entries in earlier tiles
    const int v = lane <= S ? s_tot[lane] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane <= S) {
      if (tile == 0) {
        G.cnt[lane] = v;
        G.base[lane] = x - v;
      }
      s_before[lane] += x - v;
    }
  }
  __syncthreads();
  const bool wraps = s_tot[S] != 0;
  if (tile == 0 && tid == 0) {
    *G.wraps = wraps;
    atomicAdd(&g_shard_stats[SS_TXNS], 1ull);
    if (wraps) atomicAdd(&g_shard_stats[SS_RESCANS], 1ull);
  }
  rank_lanes(len, S + 1,
             [&](int i) { return lane_key(t0 + i, S, walk, mask, home); },
             [&](int i, int b, int r) {
               if (b < 0) {
                 out[t0 + i] = -1;
               } else if (!wraps) {
                 const int at = s_before[b] + r - s_base[b];
                 G.L.idx[at] = t0 + i;
                 G.L.sz[at] = sizes[t0 + i];
               }
             }, s_cnt, s_base, s_tab);
}

// One attempt of a wide transaction, one block per shard: block s takes
// step (a, s) over the lists the partition left (and the failures that
// earlier attempts compacted).  A transaction whose homes wrap runs
// every step on block 0 at attempt 0, and nothing after; so does one of
// S > kMaxShards, for which no partition ran (the launcher's one launch
// of one block).
// body (dynamic shared memory, one block's, for any bucket; or ws):
//      local (n) | scratch, bucket b's slice at bucket_scratch_off in ws
template <bool kWs>
__global__ void __launch_bounds__(1024)
sharded_alloc_attempt_kernel(ArenaDesc d, int* mem, int* ctl,
                             int S, int Mw, int Cw,
                             const int* sizes, const uint8_t* mask,
                             const int* home, int n, int walk, int a,
                             int* out, int* lists, int* ws) {
  __shared__ AllocShared sh;
  extern __shared__ int dyn[];
  const int s = blockIdx.x;
  const bool many = S > kMaxShards;
  int* body = kWs ? ws : dyn;
  GridLists G(lists, n, body);
  count_launch(g_txn_launches, LS_SHARDED_ALLOC_ATTEMPT);
  if (many || *G.wraps) {  // uniform
    if (a != 0 || s != 0) return;
    if (many && threadIdx.x == 0) {
      atomicAdd(&g_shard_stats[SS_TXNS], 1ull);
      atomicAdd(&g_shard_stats[SS_RESCANS], 1ull);
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = -1;
    run_steps(d, mem, ctl, S, Mw, Cw, sizes, mask, home, n, out, G.L, sh,
              body + n, false, G.cnt, G.base, true, 0, walk, 0, S - 1);
    return;
  }
  run_steps(d, mem, ctl, S, Mw, Cw, sizes, mask, home, n, out, G.L, sh,
            body + n, kWs, G.cnt, G.base, false, a, a, s, s);
}

static_assert(sizeof(AllocShared) + 2 * kKeys * sizeof(int)
                  <= kStaticSmemBytes,
              "alloc kernels' static shared memory");
static_assert(sizeof(FreeShared) <= kStaticSmemBytes,
              "free kernels' static shared memory");

// ---- free ----------------------------------------------------------------

// After the grow, thread 0: could two of the enqueue's values share a
// word?  Yes when a ring class takes more values than its capacity or its
// slots cross 2^31, or when two touched segments (a va directory's slots
// from back's on; a vl tail and new segments) are one chunk, or one lies
// outside the heap's chunks.  (A chunk kind's revived chunks are distinct
// and ranked apart within a class; the caller adds the one other way,
// a class outside [0, C).)  seen: a bitset of ceil(nc / 32) zeroed words.
__device__ __forceinline__ bool enqueue_may_collide(
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

// The total of v over this lane's run of neighbouring lanes with the same
// key (a sum, or with kOr a union), handed to the run's last lane: true
// there when key >= 0, so that one atomic a run does what one a lane
// did (the adds commute).  Every lane of the warp calls it.
template <bool kOr>
__device__ __forceinline__ bool warp_run_total(int key, unsigned& v) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  const int start = 31 - __clz((int)(heads & (0xffffffffu >> (31 - lane))));
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = (unsigned)__shfl_up_sync(0xffffffffu, (int)v, o);
    if (lane - o >= start) v = kOr ? (v | y) : (v + y);
  }
  return key >= 0 && (lane == 31 || ((heads >> (lane + 1)) & 1u));
}

// The lane passes of a chunk kind's free, a warp at a time over lanes
// i0 + lane, i0 += stride (both multiples of 32): phase 0 marks in
// bitset the touched chunks that were full (free counts before any
// clear) and counts the freed lanes per class in freed; phase 1 clears
// their bits (wrapping subtract) and returns their pages to the free
// counts.  A lane's arena is mem + slot * Mw, its bitset bitset + slot *
// ws_ints and its counts freed + slot * C, slot 0 but on the grid passes
// of a sharded free.  Each atomic covers a run of neighbouring lanes on
// one word (a retirement's ascending offsets: 16 lanes a chunk).
template <int kPhase>
__device__ __forceinline__ void free_lane_pass(const ArenaDesc& d, int* mem,
                                               long long Mw, FreeLanes L,
                                               const int* sizes, int n,
                                               int i0, int stride, int* freed,
                                               unsigned* bitset,
                                               long long ws_ints) {
  const int C = d.num_classes, nc = d.num_chunks, wpc = d.wpc;
  const int nwords = (nc + 31) / 32, lane = threadIdx.x & 31;
  for (; i0 < n; i0 += stride) {
    const int i = i0 + lane;
    int c = -1, off = 0, slot = 0;
    if (i < n && L.sel(i)) {
      const int k = size_class(d, sizes[i]);
      const int o = L.off(i);
      if (k < C && o >= 0) {
        c = k;
        off = o;
        slot = L.slot(i);
      }
    }
    const int chunk = c >= 0 ? fdiv(off, wpc) : 0;
    if (kPhase == 0) {
      int key = -1, word = -1;
      unsigned one = c >= 0, bit = 0u;
      if (c >= 0) {
        key = slot * C + c;
        if (chunk < nc && mem[slot * Mw + d.free_off + chunk] == 0) {
          word = slot * nwords + (chunk >> 5);
          bit = 1u << (chunk & 31);
        }
      }
      if (warp_run_total<false>(key, one)) atomicAdd(&freed[key], (int)one);
      if (warp_run_total<true>(word, bit))
        atomicOr(&bitset[(word / nwords) * ws_ints + word % nwords], bit);
    } else {
      int key = -1, word = -1;
      unsigned one = 0u, clear = 0u;
      if (c >= 0 && chunk < nc) {
        key = slot * nc + chunk;
        one = 1u;
        const int page = fdiv(fmodi(off, wpc), d.min_page_words << c);
        if (page / 32 < d.bw) {
          word = key * d.bw + page / 32;
          clear = 0u - (1u << (page & 31));
        }
      }
      if (warp_run_total<false>(key, one))
        atomicAdd(&mem[(key / nc) * Mw + d.free_off + key % nc], (int)one);
      if (warp_run_total<false>(word, clear)) {
        const int per = nc * d.bw;
        atomicAdd(reinterpret_cast<unsigned*>(
                      &mem[(word / per) * Mw + d.bitmap_off + word % per]),
                  clear);
      }
    }
  }
}

// A chunk kind's free up to its enqueue, block-wide: the lane passes
// (unless lanes_done: the grid's passes ran them, their bitset and
// counts in the tables), then the chunks it revived (full before,
// touched now) listed in ascending id order, each with its class and its
// rank among the revived chunks of class cls mod C (a class outside
// [0, C) ranks there without being counted, as the reference's one-hot:
// sh.bad_class says whether one did).  bitset: ceil(nc / 32) words,
// zeroed or marked; zeroed again on return.  Returns the number of
// revived chunks.
__device__ __forceinline__ int revive_chunks(const ArenaDesc& d, int* mem,
                                             FreeLanes L, const int* sizes,
                                             int n, FreeShared& sh,
                                             unsigned* bitset, int* rev_id,
                                             int* rev_cls, int* rank,
                                             bool lanes_done) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int lane = tid & 31, nwords = (d.num_chunks + 31) / 32;
  const int* chunk_class = mem + d.class_off;
  if (!lanes_done) {
    free_lane_pass<0>(d, mem, 0, L, sizes, n, tid - lane, nt, sh.freed,
                      bitset, 0);
    __syncthreads();
    free_lane_pass<1>(d, mem, 0, L, sizes, n, tid - lane, nt, nullptr,
                      bitset, 0);
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
      bitset[w] = 0u;  // free again for the collision test's marks
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
  int bad = 0;
  for (int j = lo; j < hi; ++j) bad |= rev_cls[j] < 0 || rev_cls[j] >= C;
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
  bad = __syncthreads_or(bad);
  if (tid == 0) sh.bad_class = bad;
  return R;
}

// One free transaction on one arena (mem, ctl), block-wide.  tables:
// free_txn_table_bytes of shared or global memory.  lanes_done: a chunk
// kind's lane passes already ran on the grid (free_lanes_kernel), their
// counts and revived-chunk bitset in the tables.
__device__ __forceinline__ void free_body(const ArenaDesc& d, int* mem,
                                          int* ctl, FreeLanes L,
                                          const int* sizes, int n,
                                          FreeShared& sh, int* tables,
                                          bool lanes_done) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.num_classes;
  const int nwords = (d.num_chunks + 31) / 32;
  const int m = n / d.spc + 1;
  // tables: freed lanes per class (C; the grid passes') | bitset
  //         (ceil(nc/32)) | rev ids (n) | rev class (n) | rank (n) |
  //         new segment chunks (C * m)
  unsigned* bitset = reinterpret_cast<unsigned*>(tables + C);
  int* rev_id = tables + C + nwords;
  int* rev_cls = rev_id + n;
  int* rank = rev_cls + n;
  int* newc = rank + n;

  for (int i = tid; i < d.ctl_words; i += nt)
    sh.ctl[i] = sh.old[i] = ctl[i];
  for (int i = tid; i < C; i += nt) {
    sh.freed[i] = lanes_done ? tables[i] : 0;
    sh.nnew[i] = 0;
  }
  if (!lanes_done)
    for (int i = tid; i < nwords; i += nt) bitset[i] = 0u;
  for (int i = tid; i < C * m; i += nt) newc[i] = -1;
  if (tid == 0) sh.bad_class = 0;
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
    rank_lanes(n, C, cls_of, [&](int i, int, int r) { rank[i] = r; },
               sh.count, sh.base, sh.tab);
    __syncthreads();
    R = n;
  } else {
    R = revive_chunks(d, mem, L, sizes, n, sh, bitset, rev_id, rev_cls,
                      rank, lanes_done);
  }

  // the family's bulk enqueue: thread 0 grows the queues, then the
  // values are written in parallel unless two could share a word, when
  // thread 0 writes them in lane order, as the reference's scatter
  // resolves them
  if (tid == 0) {
    Chain ch{d, mem, sh.ctl};
    grow_segments(d, ch, sh.count, sh.nnew, newc, m);
    sh.serial = sh.bad_class
                || enqueue_may_collide(d, ch, sh.count, sh.nnew, newc, m,
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
    unsigned long long values = R;
    if (d.kind == KIND_PAGE) {
      values = 0;
      for (int c = 0; c < C; ++c) values += (unsigned)sh.count[c];
    }
    atomicAdd(&g_free_stats[sh.serial ? FS_SER_ENQUEUES : FS_PAR_ENQUEUES],
              1ull);
    atomicAdd(&g_free_stats[sh.serial ? FS_SER_VALUES : FS_PAR_VALUES],
              values);
  }
  __syncthreads();
  for (int i = tid; i < d.ctl_words; i += nt) ctl[i] = sh.ctl[i];
}

template <bool kWs>
__global__ void __launch_bounds__(1024)
free_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                const int* offs, const int* sizes,
                const uint8_t* mask, int n, int* ws, int lanes_done) {
  __shared__ FreeShared sh;
  extern __shared__ int dyn[];
  const FreeLanes L{offs, mask, 0, 0, false, 1};
  count_launch(g_txn_launches, LS_FREE_TXN);
  free_body(d, mem, ctl, L, sizes, n, sh, kWs ? ws : dyn, lanes_done);
}

// One block per shard: block s frees the lanes whose offsets it owns.
// A workspace holds one table set per block (ws_ints ints each).
template <bool kWs>
__global__ void __launch_bounds__(1024)
sharded_free_txn_kernel(ArenaDesc d, int* mem, int* ctl,
                        int Mw, int Cw, const int* offs,
                        const int* sizes,
                        const uint8_t* mask, int n, int* ws,
                        long long ws_ints, int lanes_done) {
  __shared__ FreeShared sh;
  extern __shared__ int dyn[];
  const int s = blockIdx.x;
  int* m = mem + (long long)s * Mw;
  int* c = ctl + (long long)s * Cw;
  const FreeLanes L{offs, mask, s, d.total_words, true, (int)gridDim.x};
  count_launch(g_txn_launches, LS_SHARDED_FREE_TXN);
  free_body(d, m, c, L, sizes, n, sh, kWs ? ws + s * ws_ints : dyn,
            lanes_done);
}

// A chunk kind's lane passes of a free whose tables are in the workspace
// (a transaction too wide for a block's shared memory), spread over the
// card before the transaction's block(s) run the rest: phase 0, then
// phase 1 as a second launch (every chunk's "full before" is read
// before any page returns).  The S shards' lanes at once (one arena:
// S = 1, not sharded; mem rows of Mw words), each shard's counts and
// bitset in its
// table set (ws_ints ints each), zeroed by the launcher; a block sums its
// counts in shared memory and adds them once.
constexpr int kGridThreads = 256;
constexpr int kGridMaxBlocks = 528;    // 4 blocks on each of 132 SMs
constexpr int kGridCounts = 256;       // S * C counts a block can sum

template <int kPhase>
__global__ void __launch_bounds__(kGridThreads)
free_lanes_kernel(ArenaDesc d, int* mem, long long Mw, const int* offs,
                  const int* sizes, const uint8_t* mask, int n, int S,
                  int sharded, int* ws, long long ws_ints) {
  __shared__ int s_freed[kGridCounts];
  const int tid = threadIdx.x, C = d.num_classes;
  const FreeLanes L{offs, mask, -1, d.total_words, sharded != 0, S};
  count_launch(g_txn_launches, LS_FREE_LANES);
  if (kPhase == 0) {
    for (int k = tid; k < S * C; k += kGridThreads) s_freed[k] = 0;
    __syncthreads();
  }
  free_lane_pass<kPhase>(d, mem, Mw, L, sizes, n,
                         blockIdx.x * kGridThreads + tid - (tid & 31),
                         gridDim.x * kGridThreads, s_freed,
                         reinterpret_cast<unsigned*>(ws + C), ws_ints);
  if (kPhase == 0) {
    __syncthreads();
    for (int k = tid; k < S * C; k += kGridThreads)
      if (s_freed[k]) atomicAdd(&ws[(k / C) * ws_ints + k % C], s_freed[k]);
  }
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
  return ((size_t)d.num_classes + nwords + 3 * (size_t)n
          + (size_t)d.num_classes * m) * sizeof(int);
}

// Blocks of a free's grid lane passes (free_lanes_kernel), or 0 when its
// block(s) run them: a chunk kind whose tables are in the workspace.
extern "C" int free_txn_grid_blocks(ArenaDesc d, int n, int S, int ws) {
  if (!ws || d.kind != KIND_CHUNK || n <= 0
      || S * d.num_classes > kGridCounts)
    return 0;
  const int blocks = (n + kGridThreads - 1) / kGridThreads;
  return blocks < kGridMaxBlocks ? blocks : kGridMaxBlocks;
}

// A sharded alloc runs in one warp-sized block (sharded_alloc_txn_kernel,
// the steps in turn) when its lanes fit one warp and its tables fit in
// shared memory, else as the partition's two launches over the card and
// an attempt a launch of S blocks (returns 1).  A serving engine's
// transaction (16-32 lanes, all of one slot's home: one bucket) runs one
// body either way, and the wide form adds walk + 2 launches that do
// little; a wider transaction, its homes hashed over every bucket, runs
// S bodies side by side instead of in turn.  32 is the warp kernel's
// capacity.  A build may define SHARDED_GRID_LANES=0 to send every
// transaction to the grid path, so that the two can be timed on the
// same words (compare_trees.py).
#ifndef SHARDED_GRID_LANES
#define SHARDED_GRID_LANES 32
#endif
constexpr int kShardedGridLanes = SHARDED_GRID_LANES;
static_assert(kShardedGridLanes <= 32, "the warp kernel's lanes");

// one block's tables: the lists (idx, sz, local) and the body's scratch
extern "C" size_t sharded_alloc_txn_table_bytes(ArenaDesc d, int n) {
  return (3 * (size_t)n + alloc_scratch_ints(d, n)) * sizeof(int);
}

extern "C" int sharded_alloc_txn_grid(ArenaDesc d, int n, size_t smem_limit) {
  return n > kShardedGridLanes
         || sharded_alloc_txn_table_bytes(d, n) > smem_limit;
}

// The attempt launches' tables: the lists that carry from one launch to
// the next (always in the workspace), and a block's body tables (local
// and scratch: in its shared memory when one bucket of all n lanes fits
// there, else every bucket's slice in the workspace after the lists;
// the slices of counts summing to n take at most alloc_scratch_ints(d,
// n) + kMaxShards * alloc_scratch_ints(d, 0)).
static size_t sharded_lists_ints(int n) {
  return 2 * (size_t)kKeys + 1 + (size_t)part_tiles(n) * kKeys
         + 2 * (size_t)n;
}

static size_t sharded_body_bytes(ArenaDesc d, int n) {
  return ((size_t)n + alloc_scratch_ints(d, n)) * sizeof(int);
}

static size_t sharded_body_ws_ints(ArenaDesc d, int n) {
  return (size_t)n + alloc_scratch_ints(d, n)
         + (size_t)kMaxShards * alloc_scratch_ints(d, 0);
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
  if (!sharded_alloc_txn_grid(d, n, smem_limit)) return 0;
  size_t ints = sharded_lists_ints(n);
  if (sharded_body_bytes(d, n) > smem_limit) ints += sharded_body_ws_ints(d, n);
  return ints * sizeof(int);
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

// The chain statistics (kChainStats words, in ChainStat order).
extern "C" int alloc_txn_chain_stats(unsigned long long* out, int reset) {
  return read_stats(g_chain_stats, out, reset);
}

// The sharded alloc statistics (kShardStats words, in ShardStat order).
extern "C" int alloc_txn_shard_stats(unsigned long long* out, int reset) {
  return read_stats(g_shard_stats, out, reset);
}

// The free enqueue statistics (kFreeStats words, in FreeStat order).
extern "C" int free_txn_enqueue_stats(unsigned long long* out, int reset) {
  return read_stats(g_free_stats, out, reset);
}

// Each kernel's launches (kTxnLaunches words, in TxnLaunch order).
extern "C" int alloc_txn_launch_stats(unsigned long long* out, int reset) {
  return read_stats(g_txn_launches, out, reset);
}

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

// A chunk kind's grid lane passes before the transaction's block(s),
// when free_txn_grid_blocks says so: the S table sets' counts and bitset
// zeroed, then the two passes.  Returns the number of grid blocks (0:
// none) through *blocks.
static int free_lanes_launch(ArenaDesc d, int* mem, long long Mw, int S,
                             int sharded, const int* offs, const int* sizes,
                             const uint8_t* mask, int n, int* ws,
                             cudaStream_t stream, int* blocks) {
  *blocks = free_txn_grid_blocks(d, n, S, ws != nullptr);
  if (!*blocks) return 0;
  const size_t table = free_txn_table_bytes(d, n);
  const size_t head = (d.num_classes + (d.num_chunks + 31) / 32)
                      * sizeof(int);
  int err = (int)cudaMemset2DAsync(ws, table, 0, head, S, stream);
  if (err) return err;
  const long long ws_ints = (long long)(table / sizeof(int));
  free_lanes_kernel<0><<<*blocks, kGridThreads, 0, stream>>>(
      d, mem, Mw, offs, sizes, mask, n, S, sharded, ws, ws_ints);
  if ((err = (int)cudaGetLastError())) return err;
  free_lanes_kernel<1><<<*blocks, kGridThreads, 0, stream>>>(
      d, mem, Mw, offs, sizes, mask, n, S, sharded, ws, ws_ints);
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
  int grid;
  err = free_lanes_launch(d, mem, 0, 1, 0, offs, sizes, mask, n, ws,
                          (cudaStream_t)stream, &grid);
  if (err) return err;
  k<<<1, block_threads(n), smem, (cudaStream_t)stream>>>(
      d, mem, ctl, offs, sizes, mask, n, ws, grid > 0);
  return (int)cudaGetLastError();
}

// ws: sharded_alloc_txn_workspace_bytes(d, n, smem_limit) bytes (null
// for 0).  Past kMaxShards shards no partition runs: one attempt launch
// of one block takes every step on per-step lists.
extern "C" int sharded_alloc_txn_launch(ArenaDesc d, int* mem, int* ctl,
                                        int S, int Mw, int Cw,
                                        const int* sizes,
                                        const uint8_t* mask,
                                        const int* home, int n, int walk,
                                        int* out, int* ws, size_t smem_limit,
                                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!sharded_alloc_txn_grid(d, n, smem_limit)) {  // n <= 32
    const size_t smem = sharded_alloc_txn_table_bytes(d, n);
    int err = launch_smem((const void*)sharded_alloc_txn_kernel, smem);
    if (err) return err;
    sharded_alloc_txn_kernel<<<1, 32, smem, st>>>(d, mem, ctl, S, Mw, Cw,
                                                   sizes, mask, home, n,
                                                   walk, out);
    return (int)cudaGetLastError();
  }
  const bool body_ws = sharded_body_bytes(d, n) > smem_limit;
  const size_t smem = body_ws ? 0 : sharded_body_bytes(d, n);
  const auto k = body_ws ? sharded_alloc_attempt_kernel<true>
                         : sharded_alloc_attempt_kernel<false>;
  int err = launch_smem((const void*)k, smem);
  if (err) return err;
  int* body = body_ws ? ws + sharded_lists_ints(n) : nullptr;
  if (S > kMaxShards) {
    k<<<1, block_threads(n), smem, st>>>(d, mem, ctl, S, Mw, Cw, sizes, mask,
                                         home, n, walk, 0, out, ws, body);
    return (int)cudaGetLastError();
  }
  const int tiles = part_tiles(n);
  sharded_alloc_count_kernel<<<tiles, kPartThreads, 0, st>>>(n, S, walk, mask,
                                                             home, ws);
  if ((err = (int)cudaGetLastError())) return err;
  sharded_alloc_place_kernel<<<tiles, kPartThreads, 0, st>>>(
      n, S, walk, sizes, mask, home, out, ws);
  if ((err = (int)cudaGetLastError())) return err;
  for (int a = 0; a <= walk; ++a) {
    k<<<S, block_threads(n), smem, st>>>(d, mem, ctl, S, Mw, Cw, sizes, mask,
                                         home, n, walk, a, out, ws, body);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
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
  int grid;
  err = free_lanes_launch(d, mem, Mw, S, 1, offs, sizes, mask, n, ws,
                          (cudaStream_t)stream, &grid);
  if (err) return err;
  k<<<S, block_threads(n), smem, (cudaStream_t)stream>>>(
      d, mem, ctl, Mw, Cw, offs, sizes, mask, n, ws,
      (long long)(table / sizeof(int)), grid > 0);
  return (int)cudaGetLastError();
}
