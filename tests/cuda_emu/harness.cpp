// Plain C entry points around the emulated kernels (loaded with ctypes
// by tests/test_torch_cuda_emulated.py).  alloc_emu.inc,
// defrag_emu.inc and attention_emu.inc are the kernel sources with their
// host launchers cut off, written by the test before it compiles this
// file; the block and shared-memory sizes come from the sources' own
// launch-geometry functions, which precede the host launchers.  The
// kernels' shared header (arena_dev.cuh) comes from the source
// directory.
#include "shim.h"
#include "alloc_emu.inc"
#include "defrag_emu.inc"
#include "attention_emu.inc"

extern "C" void emu_alloc_txn(ArenaDesc d, int* mem, int* ctl,
                              const int* sizes, const uint8_t* mask, int n,
                              int* out) {
  emu_launch(1, block_threads(n), alloc_txn_smem_bytes(d, n), [&] {
    alloc_txn_kernel(d, mem, ctl, sizes, mask, n, out);
  });
}

extern "C" void emu_free_txn(ArenaDesc d, int* mem, int* ctl,
                             const int* offs, const int* sizes,
                             const uint8_t* mask, int n) {
  emu_launch(1, block_threads(n), free_txn_smem_bytes(d, n), [&] {
    free_txn_kernel(d, mem, ctl, offs, sizes, mask, n);
  });
}

extern "C" void emu_sharded_alloc_txn(ArenaDesc d, int* mem, int* ctl, int S,
                                      int Mw, int Cw, const int* sizes,
                                      const uint8_t* mask, const int* home,
                                      int n, int walk, int* out) {
  emu_launch(1, block_threads(n), sharded_alloc_txn_smem_bytes(d, n), [&] {
    sharded_alloc_txn_kernel(d, mem, ctl, S, Mw, Cw, sizes, mask, home, n,
                             walk, out);
  });
}

// One block per shard; the emulation runs a grid's blocks one after
// another, which the kernel allows: its blocks share no words.
extern "C" void emu_sharded_free_txn(ArenaDesc d, int* mem, int* ctl, int S,
                                     int Mw, int Cw, const int* offs,
                                     const int* sizes, const uint8_t* mask,
                                     int n) {
  emu_launch(S, block_threads(n), free_txn_smem_bytes(d, n), [&] {
    sharded_free_txn_kernel(d, mem, ctl, Mw, Cw, offs, sizes, mask, n);
  });
}

extern "C" void emu_sharded_defrag_txn(ArenaDesc d, int* mem, int* ctl, int S,
                                       int Mw, int Cw, const int* src,
                                       const int* dst, const int* sizes,
                                       int M, int threads) {
  emu_launch(1, threads, defrag_txn_smem_bytes(d), [&] {
    sharded_defrag_txn_kernel(d, mem, ctl, S, Mw, Cw, src, dst, sizes, M);
  });
}

extern "C" void emu_defrag_txn(ArenaDesc d, int* mem, int* ctl,
                               const int* src, const int* dst,
                               const int* sizes, int M, int threads) {
  emu_launch(1, threads, defrag_txn_smem_bytes(d), [&] {
    defrag_txn_kernel(d, mem, ctl, src, dst, sizes, M);
  });
}

extern "C" void emu_paged_attention(int bf16, const void* q, const void* k,
                                    const void* v, const int* table,
                                    const int* seq_lens, float* out, int B,
                                    int Hq, int Hkv, int D, int page, int P,
                                    int NP, int wpp, float scale) {
  const size_t smem = paged_attention_smem_bytes(Hq / Hkv, D, page);
  if (bf16)
    emu_launch(B * Hkv, 128, smem, [&] {
      paged_attention_kernel<__nv_bfloat16>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, table, seq_lens, out, Hq, Hkv, D, page, P,
          NP, wpp, scale);
    });
  else
    emu_launch(B * Hkv, 128, smem, [&] {
      paged_attention_kernel<float>((const float*)q, (const float*)k,
                                    (const float*)v, table, seq_lens, out, Hq,
                                    Hkv, D, page, P, NP, wpp, scale);
    });
}
