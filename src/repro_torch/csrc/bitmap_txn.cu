// The chunk allocator's piecewise bitmap steps: the claim of a chunk's
// first free pages, and the rank-select over a long bitmap.  Bit words
// are int32 holding uint32 patterns; every shift is on unsigned.
//
// Replaces: src/repro/kernels/alloc_txn.py::chunk_txn_claim and
// src/repro/kernels/bitmap_select.py::bitmap_select.  The plain PyTorch
// versions are chunk_txn_claim_ref and bitmap_select_ref in
// src/repro_torch/kernels/ref.py; each pair must give identical words.
//
// What bounds it on the H100: launch latency.  A claim reads bw words
// and writes 33 bw; a select over W words writes 32 W (132 K words for
// the 65536-page arena's whole bitmap, about 0.16 us at 3.35 TB/s).
//
// Design: one block, one thread per word, looping over tiles of
// blockDim words.  Each word's count of candidate bits (free bits below
// ppc for the claim, set bits for the select) goes through a block-wide
// exclusive scan, carried from tile to tile, which gives the rank of the
// word's first candidate among all candidates before it.  The claim's
// thread then walks its word's candidates in ascending order (__ffs): a
// claimed bit of rank r writes its page index at page_idx[r], and the
// ranks at or past the claimed count are filled with -1 after the loop,
// so every output word has one writer.  The select stages the tile's
// words and ranks in shared memory and writes its 32 outputs a word
// with consecutive threads on consecutive output words, so a warp's
// store is one 128-byte line (a thread writing its own word's 32
// outputs would touch 32 lines a store).  A multi-block scan is later
// work.

#include "arena_dev.cuh"

// free bits below ppc of word w of a row
__device__ __forceinline__ unsigned claimable(unsigned occ, int w, int ppc) {
  const int lim = ppc - 32 * w;
  const unsigned in_range =
      lim >= 32 ? 0xffffffffu : (lim <= 0 ? 0u : ((1u << lim) - 1u));
  return ~occ & in_range;
}

__global__ void __launch_bounds__(1024)
chunk_txn_claim_kernel(const int* __restrict__ row, int bw, int take, int ppc,
                       int* __restrict__ page_idx, int* __restrict__ new_row,
                       int* nsel) {
  __shared__ int s_warp[32];
  int carry = 0;
  for (int base = 0; base < bw; base += blockDim.x) {
    const int w = base + threadIdx.x;
    const unsigned occ = w < bw ? (unsigned)row[w] : 0xffffffffu;
    unsigned cand = w < bw ? claimable(occ, w, ppc) : 0u;
    int total;
    int r = carry + block_excl_scan(__popc(cand), &total, s_warp);
    if (w < bw) {
      unsigned add = 0;
      for (; cand && r < take; ++r) {
        const int b = __ffs(cand) - 1;
        cand &= cand - 1;
        add |= 1u << b;
        page_idx[r] = 32 * w + b;
      }
      new_row[w] = (int)(occ | add);
    }
    carry += total;
  }
  const int sel = max(0, min(carry, take));
  for (int j = sel + threadIdx.x; j < 32 * bw; j += blockDim.x)
    page_idx[j] = -1;
  if (threadIdx.x == 0) nsel[0] = sel;
}

__global__ void __launch_bounds__(1024)
bitmap_select_kernel(const int* __restrict__ words, int W, int k,
                     int* __restrict__ out) {
  __shared__ int s_warp[32];
  __shared__ unsigned s_word[1024];
  __shared__ int s_rank[1024];
  int carry = 0;
  for (int base = 0; base < W; base += blockDim.x) {
    const int w = base + threadIdx.x;
    const unsigned x = w < W ? (unsigned)words[w] : 0u;
    int total;
    s_rank[threadIdx.x] = carry + block_excl_scan(__popc(x), &total, s_warp);
    s_word[threadIdx.x] = x;
    __syncthreads();
    // the tile's 32 x words outputs, consecutive threads on consecutive
    // words of out
    const int n = 32 * min((int)blockDim.x, W - base);
    int* o = out + 32LL * base;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned xw = s_word[i >> 5];
      const int b = i & 31;
      const int r = s_rank[i >> 5] + __popc(xw & ((1u << b) - 1u));
      o[i] = ((xw >> b) & 1u) && r < k ? r : -1;
    }
    __syncthreads();
    carry += total;
  }
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

extern "C" int chunk_txn_claim_launch(const int* row, int bw, int take,
                                      int ppc, int* page_idx, int* new_row,
                                      int* nsel, void* stream) {
  chunk_txn_claim_kernel<<<1, block_threads(bw), 0,
                           (cudaStream_t)stream>>>(row, bw, take, ppc,
                                                   page_idx, new_row, nsel);
  return (int)cudaGetLastError();
}

extern "C" int bitmap_select_launch(const int* words, int W, int k, int* out,
                                    void* stream) {
  bitmap_select_kernel<<<1, block_threads(W), 0,
                         (cudaStream_t)stream>>>(words, W, k, out);
  return (int)cudaGetLastError();
}
