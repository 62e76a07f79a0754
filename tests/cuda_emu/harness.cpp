// Plain C entry points around the emulated kernels (loaded with ctypes
// by tests/test_torch_cuda_emulated.py).  alloc_emu.inc,
// defrag_emu.inc and attention_emu.inc are the kernel sources with their
// host launchers cut off, written by the test before it compiles this
// file; the block sizes and shared-memory sizes here repeat the
// launchers'.  The kernels' shared header (arena_dev.cuh) comes from the
// source directory.
#include "shim.h"
#include "alloc_emu.inc"
#include "defrag_emu.inc"
#include "attention_emu.inc"

static int block_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

extern "C" void emu_alloc_txn(ArenaDesc d, int* mem, int* ctl,
                              const int* sizes, const uint8_t* mask, int n,
                              int* out) {
  emu_launch(1, block_threads(n), (size_t)n * sizeof(int), [&] {
    alloc_txn_kernel(d, mem, ctl, sizes, mask, n, out);
  });
}

extern "C" void emu_free_txn(ArenaDesc d, int* mem, int* ctl,
                             const int* offs, const int* sizes,
                             const uint8_t* mask, int n) {
  const int nwords = (d.num_chunks + 31) / 32, m = n / d.spc + 1;
  const size_t smem =
      ((size_t)nwords + 3 * (size_t)n + (size_t)d.num_classes * m) *
      sizeof(int);
  emu_launch(1, block_threads(n), smem, [&] {
    free_txn_kernel(d, mem, ctl, offs, sizes, mask, n);
  });
}

extern "C" void emu_defrag_txn(ArenaDesc d, int* mem, int* ctl,
                               const int* src, const int* dst,
                               const int* sizes, int M, int threads) {
  const int nc = d.num_chunks, nwords = (nc + 31) / 32;
  const size_t smem =
      (2 * (size_t)nc + nwords + nc / d.spc + 2) * sizeof(int);
  emu_launch(1, threads, smem, [&] {
    defrag_txn_kernel(d, mem, ctl, src, dst, sizes, M);
  });
}

extern "C" void emu_paged_attention(int bf16, const void* q, const void* k,
                                    const void* v, const int* table,
                                    const int* seq_lens, float* out, int B,
                                    int Hq, int Hkv, int D, int page, int P,
                                    int NP, int wpp, float scale) {
  const int G = Hq / Hkv;
  const size_t smem =
      (size_t)(2 * G * D + 2 * page * D + G * page + 3 * G) * sizeof(float);
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
