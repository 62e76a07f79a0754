// Plain C entry points around the emulated kernels (loaded with ctypes
// by tests/test_torch_cuda_emulated.py).  alloc_emu.inc,
// defrag_emu.inc, attention_emu.inc, ssd_emu.inc, ring_emu.inc and
// bitmap_emu.inc are the kernel
// sources with their host launchers cut off, written by the test before
// it compiles this file; the block and shared-memory sizes come from the sources' own
// launch-geometry functions, which precede the host launchers.  The
// kernels' shared header (arena_dev.cuh) comes from the source
// directory.
#include "shim.h"
#include "alloc_emu.inc"
#include "defrag_emu.inc"
#include "attention_emu.inc"
#include "ssd_emu.inc"
#include "ring_emu.inc"
#include "bitmap_emu.inc"

// The transaction and wave kernels' tables: in the launch's dynamic shared
// memory when they fit in smem_limit bytes, else in a workspace standing
// in for the device one (the wrappers pass a lowered limit to reach that
// path at small lane counts); each home has its kernel instance, picked
// as the host launchers pick it.
static int* emu_workspace(std::vector<int>& buf, size_t bytes) {
  if (!bytes) return nullptr;
  buf.assign(bytes / sizeof(int) + 1, 0x5a5a5a5a);
  return buf.data();
}

extern "C" void emu_alloc_txn(ArenaDesc d, int* mem, int* ctl,
                              const int* sizes, const uint8_t* mask, int n,
                              int* out, size_t smem_limit) {
  std::vector<int> buf;
  int* ws = emu_workspace(buf, alloc_txn_workspace_bytes(d, n, smem_limit));
  emu_launch(1, block_threads(n), ws ? 0 : alloc_txn_table_bytes(d, n), [&] {
    (ws ? alloc_txn_kernel<true> : alloc_txn_kernel<false>)(
        d, mem, ctl, sizes, mask, n, out, ws);
  });
}

// The alloc kernels' chain statistics (alloc_txn.cu's g_chain_stats, a
// host array here), as alloc_txn_chain_stats reads them.
extern "C" int emu_alloc_chain_stats(unsigned long long* out, int reset) {
  for (int k = 0; k < kChainStats; ++k) {
    out[k] = g_chain_stats[k];
    if (reset) g_chain_stats[k] = 0;
  }
  return kChainStats;
}

// The sharded alloc kernels' statistics (g_shard_stats, a host array
// here), as alloc_txn_shard_stats reads them.
extern "C" int emu_alloc_shard_stats(unsigned long long* out, int reset) {
  for (int k = 0; k < kShardStats; ++k) {
    out[k] = g_shard_stats[k];
    if (reset) g_shard_stats[k] = 0;
  }
  return kShardStats;
}

// Each allocator and wave kernel's launches (g_txn_launches, then
// g_wave_launches: host arrays here), as alloc_txn_launch_stats and
// defrag_txn_launch_stats read them.
extern "C" int emu_launch_stats(unsigned long long* out, int reset) {
  for (int k = 0; k < kTxnLaunches; ++k) {
    out[k] = g_txn_launches[k];
    if (reset) g_txn_launches[k] = 0;
  }
  for (int k = 0; k < kWaveLaunches; ++k) {
    out[kTxnLaunches + k] = g_wave_launches[k];
    if (reset) g_wave_launches[k] = 0;
  }
  return kTxnLaunches + kWaveLaunches;
}

// The free kernels' enqueue statistics (g_free_stats, a host array
// here), as free_txn_enqueue_stats reads them.
extern "C" int emu_free_enqueue_stats(unsigned long long* out, int reset) {
  for (int k = 0; k < kFreeStats; ++k) {
    out[k] = g_free_stats[k];
    if (reset) g_free_stats[k] = 0;
  }
  return kFreeStats;
}

// A chunk kind's grid lane passes, as free_lanes_launch runs them when
// free_txn_grid_blocks says so (the table sets' heads zeroed first).
static int emu_free_lanes(ArenaDesc d, int* mem, long long Mw, int S,
                          int sharded, const int* offs, const int* sizes,
                          const uint8_t* mask, int n, int* ws) {
  const int blocks = free_txn_grid_blocks(d, n, S, ws != nullptr);
  if (!blocks) return 0;
  const long long ints = (long long)(free_txn_table_bytes(d, n) / sizeof(int));
  for (int s = 0; s < S; ++s)
    std::fill(ws + s * ints,
              ws + s * ints + d.num_classes + (d.num_chunks + 31) / 32, 0);
  emu_launch(blocks, kGridThreads, 0, [&] {
    free_lanes_kernel<0>(d, mem, Mw, offs, sizes, mask, n, S, sharded, ws,
                         ints);
  });
  emu_launch(blocks, kGridThreads, 0, [&] {
    free_lanes_kernel<1>(d, mem, Mw, offs, sizes, mask, n, S, sharded, ws,
                         ints);
  });
  return blocks;
}

extern "C" void emu_free_txn(ArenaDesc d, int* mem, int* ctl,
                             const int* offs, const int* sizes,
                             const uint8_t* mask, int n, size_t smem_limit) {
  std::vector<int> buf;
  int* ws = emu_workspace(buf, free_txn_workspace_bytes(d, n, 1, smem_limit));
  const int grid = emu_free_lanes(d, mem, 0, 1, 0, offs, sizes, mask, n, ws);
  emu_launch(1, block_threads(n), ws ? 0 : free_txn_table_bytes(d, n), [&] {
    (ws ? free_txn_kernel<true> : free_txn_kernel<false>)(
        d, mem, ctl, offs, sizes, mask, n, ws, grid > 0);
  });
}

// One warp-sized block for every step, or the partition's two grids and
// an attempt a launch of S blocks (past kMaxShards shards, one attempt
// launch of one block), as sharded_alloc_txn_launch picks them (a grid's
// blocks run one after another here, which the kernels allow: within a
// launch they share no words).
extern "C" void emu_sharded_alloc_txn(ArenaDesc d, int* mem, int* ctl, int S,
                                      int Mw, int Cw, const int* sizes,
                                      const uint8_t* mask, const int* home,
                                      int n, int walk, int* out,
                                      size_t smem_limit) {
  std::vector<int> buf;
  int* ws = emu_workspace(
      buf, sharded_alloc_txn_workspace_bytes(d, n, smem_limit));
  if (!sharded_alloc_txn_grid(d, n, smem_limit)) {
    emu_launch(1, 32, sharded_alloc_txn_table_bytes(d, n), [&] {
      sharded_alloc_txn_kernel(d, mem, ctl, S, Mw, Cw, sizes, mask, home, n,
                               walk, out);
    });
    return;
  }
  const bool body_ws = sharded_body_bytes(d, n) > smem_limit;
  int* body = body_ws ? ws + sharded_lists_ints(n) : nullptr;
  auto attempt = [&](int blocks, int a) {
    emu_launch(blocks, block_threads(n),
               body_ws ? 0 : sharded_body_bytes(d, n), [&] {
      (body_ws ? sharded_alloc_attempt_kernel<true>
               : sharded_alloc_attempt_kernel<false>)(
          d, mem, ctl, S, Mw, Cw, sizes, mask, home, n, walk, a, out, ws,
          body);
    });
  };
  if (S > kMaxShards) {
    attempt(1, 0);
    return;
  }
  emu_launch(part_tiles(n), kPartThreads, 0, [&] {
    sharded_alloc_count_kernel(n, S, walk, mask, home, ws);
  });
  emu_launch(part_tiles(n), kPartThreads, 0, [&] {
    sharded_alloc_place_kernel(n, S, walk, sizes, mask, home, out, ws);
  });
  for (int a = 0; a <= walk; ++a) attempt(S, a);
}

// One block per shard; the emulation runs a grid's blocks one after
// another, which the kernel allows: its blocks share no words.
extern "C" void emu_sharded_free_txn(ArenaDesc d, int* mem, int* ctl, int S,
                                     int Mw, int Cw, const int* offs,
                                     const int* sizes, const uint8_t* mask,
                                     int n, size_t smem_limit) {
  std::vector<int> buf;
  const size_t table = free_txn_table_bytes(d, n);
  int* ws = emu_workspace(buf, free_txn_workspace_bytes(d, n, S, smem_limit));
  const int grid = emu_free_lanes(d, mem, Mw, S, 1, offs, sizes, mask, n, ws);
  emu_launch(S, block_threads(n), ws ? 0 : table, [&] {
    (ws ? sharded_free_txn_kernel<true> : sharded_free_txn_kernel<false>)(
        d, mem, ctl, Mw, Cw, offs, sizes, mask, n, ws,
        (long long)(table / sizeof(int)), grid > 0);
  });
}

// The extract kernel's grid over the lanes, then the rebuild: one block
// per shard (run one after another here, which the kernel allows: each
// block touches only its shard's rows and its own tables).
static void emu_extract(ArenaDesc d, int* mem, int S, long long Mw,
                        const int* src, const int* dst, const int* sizes,
                        int M) {
  const int blocks = defrag_extract_blocks(M);
  if (!blocks) return;
  emu_launch(blocks, kExtractThreads, 0, [&] {
    defrag_extract_kernel(d, mem, S, Mw, src, dst, sizes, M);
  });
}

extern "C" void emu_sharded_defrag_txn(ArenaDesc d, int* mem, int* ctl, int S,
                                       int Mw, int Cw, const int* src,
                                       const int* dst, const int* sizes,
                                       int M, int threads,
                                       size_t smem_limit) {
  std::vector<int> buf;
  const size_t table = defrag_txn_table_bytes(d);
  int* ws = emu_workspace(buf, defrag_txn_workspace_bytes(d, S, smem_limit));
  emu_extract(d, mem, S, Mw, src, dst, sizes, M);
  emu_launch(S, threads, ws ? 0 : table, [&] {
    (ws ? sharded_defrag_txn_kernel<true>
        : sharded_defrag_txn_kernel<false>)(
        d, mem, ctl, Mw, Cw, src, dst, sizes, M, ws,
        (long long)(table / sizeof(int)));
  });
}

extern "C" void emu_defrag_txn(ArenaDesc d, int* mem, int* ctl,
                               const int* src, const int* dst,
                               const int* sizes, int M, int threads,
                               size_t smem_limit) {
  std::vector<int> buf;
  int* ws = emu_workspace(buf, defrag_txn_workspace_bytes(d, 1, smem_limit));
  emu_extract(d, mem, 1, 0, src, dst, sizes, M);
  emu_launch(1, threads, ws ? 0 : defrag_txn_table_bytes(d), [&] {
    (ws ? defrag_txn_kernel<true> : defrag_txn_kernel<false>)(
        d, mem, ctl, src, dst, sizes, M, ws);
  });
}

// The wave kernels' rebuild statistics (defrag_txn.cu's g_wave_stats, a
// host array here), as defrag_txn_rebuild_stats reads them.
extern "C" int emu_defrag_rebuild_stats(unsigned long long* out, int reset) {
  for (int k = 0; k < kWaveStats; ++k) {
    out[k] = g_wave_stats[k];
    if (reset) g_wave_stats[k] = 0;
  }
  return kWaveStats;
}

// The paged attention entry points (also compiled alone, with a mutated
// kernel source, by attention_harness.cpp).
#include "attention_harness.h"

// The scan's three launches in order, through a workspace as the
// wrapper's, on a card of `sms` SMs.
template <typename T>
static void emu_ssd(const void* x, const float* dt, const float* a,
                    const void* b, const void* c, const float* h0, float* y,
                    float* hf, int B, int L, int H, int P, int G, int N,
                    int Q, int sms) {
  const int nc = L / Q, bf16 = std::is_same<T, __nv_bfloat16>::value;
  size_t o_cum, o_st, total;
  ssd_workspace(B, L, H, P, G, N, Q, &o_cum, &o_st, &total);
  std::vector<float> ws(total + 1, NAN);
  float *cbT = ws.data(), *cum = cbT + o_cum, *st = cbT + o_st;
  const int halves = ssd_state_halves(B, L, H, N, Q, sms);
  emu_launch(ssd_chunk_blocks(B, L, H, G, Q, halves), SSD_THREADS,
             ssd_scan_smem_bytes(1, bf16), [&] {
               ssd_chunk_kernel<T>((const T*)x, dt, a, (const T*)b,
                                   (const T*)c, h0, cbT, cum, st, hf, B, L,
                                   H, P, G, N, Q, halves);
             });
  const long long elems = (long long)B * H * P * N;
  if (nc == 1) {
    // the state kernel wrote h_final
  } else if ((P * N) % 4 == 0) {
    emu_launch((int)((elems / 4 + SSD_THREADS - 1) / SSD_THREADS),
               SSD_THREADS, 0, [&] {
                 ssd_pass_kernel<4>(cum, h0, st, hf, B, nc, H, P * N, Q);
               });
  } else {
    emu_launch((int)((elems + SSD_THREADS - 1) / SSD_THREADS), SSD_THREADS,
               0, [&] {
                 ssd_pass_kernel<1>(cum, h0, st, hf, B, nc, H, P * N, Q);
               });
  }
  emu_launch(B * nc * H, SCAN_THREADS, ssd_scan_smem_bytes(3, bf16), [&] {
    ssd_scan_kernel<T>((const T*)x, dt, (const T*)c, cbT, cum, st, h0, y, L,
                       H, P, G, N, Q);
  });
}

extern "C" void emu_ssd_scan(int bf16, const void* x, const float* dt,
                             const float* a, const void* b, const void* c,
                             const float* h0, float* y, float* hf, int B,
                             int L, int H, int P, int G, int N, int Q,
                             int sms) {
  (bf16 ? emu_ssd<__nv_bfloat16> : emu_ssd<float>)(
      x, dt, a, b, c, h0, y, hf, B, L, H, P, G, N, Q, sms);
}

// The piecewise allocator's steps: the ring pop and push on the path
// ring_path picks, as their launchers do (one warp; one block ranking
// every class, the instance of its ring_unroll batch; or one block per
// class), a (tiles of m, C) grid for the window (the emulation runs a
// 1-D grid of tiles x C blocks and splits each block's index), one block
// for the bitmap kernels.
extern "C" void emu_ring_txn_pop(const int* store, const int* front,
                                 const int* back, const int* cls,
                                 const uint8_t* valid, int n, int C, int cap,
                                 int limit, int* vals, int* new_front) {
  switch (ring_path(n, C)) {
    case RING_WARP:
      emu_launch(1, 32, 0, [&] {
        ring_txn_pop_warp_kernel(store, front, back, cls, valid, n, C, cap,
                                 limit, vals, new_front);
      });
      break;
    case RING_BLOCK:
      emu_launch(1, ring_block_threads(n, C), 0, [&] {
        const int u = ring_unroll(n, C);
        (u == 1   ? ring_txn_pop_block_kernel<1>
         : u == 2 ? ring_txn_pop_block_kernel<2>
         : u == 4 ? ring_txn_pop_block_kernel<4>
         : u == 8 ? ring_txn_pop_block_kernel<8>
                  : ring_txn_pop_block_kernel<16>)(
            store, front, back, cls, valid, n, C, cap, limit, vals,
            new_front);
      });
      break;
    default:
      emu_launch(C, block_threads(n), 0, [&] {
        ring_txn_pop_class_kernel(store, front, back, cls, valid, n, C, cap,
                                  limit, vals, new_front);
      });
  }
}

extern "C" void emu_ring_txn_push(int* store, const int* back,
                                  const int* cls, const int* vals,
                                  const uint8_t* valid, int n, int C, int cap,
                                  int* new_back) {
  switch (ring_path(n, C)) {
    case RING_WARP:
      emu_launch(1, 32, 0, [&] {
        ring_txn_push_warp_kernel(store, back, cls, vals, valid, n, C, cap,
                                  new_back);
      });
      break;
    case RING_BLOCK:
      emu_launch(1, ring_block_threads(n, C), 0, [&] {
        const int u = ring_unroll(n, C);
        (u == 1   ? ring_txn_push_block_kernel<1>
         : u == 2 ? ring_txn_push_block_kernel<2>
         : u == 4 ? ring_txn_push_block_kernel<4>
         : u == 8 ? ring_txn_push_block_kernel<8>
                  : ring_txn_push_block_kernel<16>)(
            store, back, cls, vals, valid, n, C, cap, new_back);
      });
      break;
    default:
      emu_launch(C, block_threads(n), 0, [&] {
        ring_txn_push_class_kernel(store, back, cls, vals, valid, n, cap,
                                   new_back);
      });
  }
}

// The ring pop and push launches by path (g_ring_launches, a host array
// here), as ring_txn_launch_stats reads them.
extern "C" int emu_ring_launch_stats(unsigned long long* out, int reset) {
  for (int k = 0; k < kRingLaunches; ++k) {
    out[k] = g_ring_launches[k];
    if (reset) g_ring_launches[k] = 0;
  }
  return kRingLaunches;
}

extern "C" void emu_ring_window(const int* store, const int* front,
                                const int* counts, int C, int cap, int m,
                                int* out) {
  const int tiles = (m + RING_WINDOW_THREADS - 1) / RING_WINDOW_THREADS;
  emu_launch(tiles * C, RING_WINDOW_THREADS, 0, [&] {
    blockIdx.y = blockIdx.x / tiles;
    blockIdx.x %= tiles;
    ring_window_kernel(store, front, counts, cap, m, out);
  });
}

extern "C" void emu_chunk_txn_claim(const int* row, int bw, int take, int ppc,
                                    int* page_idx, int* new_row, int* nsel) {
  emu_launch(1, block_threads(bw), 0, [&] {
    chunk_txn_claim_kernel(row, bw, take, ppc, page_idx, new_row, nsel);
  });
}

extern "C" void emu_bitmap_select(const int* words, int W, int k, int* out) {
  emu_launch(1, block_threads(W), 0,
             [&] { bitmap_select_kernel(words, W, k, out); });
}
