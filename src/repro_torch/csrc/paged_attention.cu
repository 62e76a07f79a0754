// Paged GQA decode attention over the Ouroboros-managed KV page heap.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention (the
// Pallas kernel; the reference host loop decodes with the jnp
// paged_attend1, which computes the same function and adds the sliding
// window and ring tables taken here too).  The plain PyTorch version is
// src/repro_torch/kernels/ref.py::paged_attention.
//
// What it computes: for each sequence b and kv head h, the G = Hq/Hkv
// query heads of that group attend over the tokens the page table maps,
// with an online softmax in float32 over the pages in table order:
// scores (q . k) * D^-1/2, tokens at or past seq_len and table holes (-1)
// masked, output acc / (l + 1e-30).  The table holds page ids, or arena
// word offsets when wpp > 0 (page = floor(offset / wpp), so a -1 hole
// stays -1).  window > 0 also masks tokens before seq_len - window; a
// ring table's slot j holds absolute page cur - ((cur - j) mod P), cur
// the page of token seq_len - 1, and its slots that hold no token of the
// last lap are masked (pa_slot_range).  Each table slot's attended
// tokens are one run [lo, hi) of its page, and a slot with none is
// treated as a hole.  q is bf16 or float32; the pages are in q's type,
// or int8 with a float32 scale per (page, slot, kv head) for K and for
// V, an element read as float(k8) * scale (one rounding, before it
// enters any sum, as the plain version reads it).
//
// What bounds it on the H100: the bytes of K and V it reads (each valid
// token's D elements of one kv head, twice, plus two scales in int8) at
// 3.35 TB/s, a fraction of a microsecond at decode sizes (8 sequences
// of up to 512 tokens: about 1 MB); the arithmetic (4 * G * D flops per
// token per kv head) is far below the card's rate.  In practice a call
// at these sizes is bound by latency: three launches, each a few
// dependent round trips to memory.
//
// Exactness: every rounding step is the one the online softmax takes
// page by page, as the plain version and the earlier one-block kernel
// take it: a score is q . k summed over d in order from 0 by fused
// multiply-adds, then scaled; a page's running max is the max of the one
// before and its scores; p = exp(s - m) against that max; its sum and
// p V are summed over the page's tokens in order; l and acc are rescaled
// by exp(m_old - m_new) one page after another.  Another order moves the
// result by float32 roundings, and at serving magnitudes exp() amplifies
// a score's rounding enough to change served tokens (a design that
// rescaled once per split of pages did).  So the pages are split across
// blocks for the work that does not depend on the running max, and the
// fold over pages, which does, is a short loop per output element.
//
// Design: three kernels in one launcher call, over a float32 workspace
// the wrapper allocates (PaWs).  Split s of (b, kv head h) takes the
// pages [s * pps, (s + 1) * pps) of the table, pps = 64 tokens' worth (4
// pages of 16 tokens), so the split kernels' grid is B * Hkv *
// ceil(P / pps) blocks (128 at the serving shapes, B 8, Hkv 2, P 32:
// about one wave of the 132 SMs), needing no host read of seq_lens; a
// split that holds no attended token (past its sequence, before the
// window) loads nothing and only writes its split maximum, -1e30, which
// the values kernels of the later splits read.  A split block has 512 threads,
// so its many short dependent chains (a score's 64 multiply-adds, a p V
// sum's 16) overlap.  Every kernel loads its table entries beside
// seq_len.
//  1. paged_attention_kernel: a split's K rows by cp.async (16 bytes a
//     thread, neighbouring threads on neighbouring addresses; K
//     chunk-major in shared memory, so a warp's 32 tokens read 32
//     neighbouring 16-byte chunks), q widened to float32 and, for int8
//     pages, the split's K scales of its kv head beside them; one
//     thread per (query head, token) score; writes the scores, each
//     page's max and the split's max per query head.
//  2. paged_attention_values_kernel: a split's V rows by cp.async (and
//     its V scales for int8 pages); each
//     page's running max from the earlier splits' maxima and its own
//     pages' (a max is exact in any order); p, its sum per page and p V
//     per page, in order over the page's tokens, one thread per (page,
//     head, d).
//  3. paged_attention_merge_kernel: one block per (b, h), one thread per
//     output element, folds the pages in table order (holes skipped),
//     the page terms loaded PA_FOLD_BATCH pages at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

#define PA_THREADS 512  // split kernels: many tasks in flight a block
#define PA_SPLIT_TOKENS 64  // tokens a split's pages hold (at least one page)
#define PA_FOLD_BATCH 16    // pages whose terms the merge loads at once
#define PA_NEG (-1e30f)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// Pages of int8 carry a float32 scale per (page, slot, kv head).
template <typename T> struct PaQuant { static constexpr bool on = false; };
template <> struct PaQuant<int8_t> { static constexpr bool on = true; };

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

__host__ __device__ inline int pa_pages_per_split(int page) {
  return page >= PA_SPLIT_TOKENS ? 1 : PA_SPLIT_TOKENS / page;
}

__host__ __device__ inline int pa_splits(int page, int P) {
  const int pps = pa_pages_per_split(page);
  return (P + pps - 1) / pps;
}

// The run [*lo, *hi) of table slot j's tokens that a query at seq_len
// seq attends (empty: *lo >= *hi).  The slot's absolute page is j, or in
// a ring table cur - ((cur - j) mod P); its tokens at or past 0, below
// seq and, with a window, at or past seq - window.
__host__ __device__ inline void pa_slot_range(int j, int seq, int page,
                                              int P, int window, int ring,
                                              int* lo, int* hi) {
  int a = j;
  if (ring) {
    const int cur = ((seq > 1 ? seq : 1) - 1) / page;
    int r = (cur - j) % P;
    if (r < 0) r += P;
    a = cur - r;
  }
  const int base = a * page, first = window > 0 ? seq - window : 0;
  *lo = first - base > 0 ? first - base : 0;
  *hi = seq - base < page ? seq - base : page;
  if (a < 0) *hi = 0;
}

// Table slots a fold visits: the slots up to the one holding token
// seq - 1 (at most P); with a window and no ring it starts at the
// window's first page.
__host__ __device__ inline void pa_fold_span(int seq, int page, int P,
                                             int window, int ring,
                                             int* first, int* npages) {
  int n = seq <= 0 ? 0 : (seq + page - 1) / page;
  *npages = n > P ? P : n;
  *first = 0;
  if (!ring && window > 0 && seq > window) *first = (seq - window) / page;
}

// bytes rounded up to 16, so every shared region starts 16-byte aligned
__host__ __device__ inline size_t pa_align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Shared memory of the split kernels.  Kernel 1: K rows (tokens x D of
// the page type, elem bytes each), q in float32 (G x D), the scores (G
// x tokens), the page ids and token runs, and with quant the tokens' K
// scales.  Kernel 2: V rows, p (G x tokens), the running maxima and the
// page maxima (G x pages each), the page ids and token runs, the
// earlier splits' maxima (splits x G), and with quant the V scales.
__host__ __device__ inline size_t pa_smem_k1(int G, int D, int page,
                                             size_t elem, bool quant) {
  const int pps = pa_pages_per_split(page), T = pps * page;
  return pa_align16((size_t)T * D * elem) + pa_align16((size_t)G * D * 4)
         + pa_align16((size_t)G * T * 4) + pa_align16((size_t)3 * pps * 4)
         + (quant ? pa_align16((size_t)T * 4) : 0);
}

__host__ __device__ inline size_t pa_smem_k2(int G, int D, int page,
                                             int P, size_t elem,
                                             bool quant) {
  const int pps = pa_pages_per_split(page), T = pps * page;
  return pa_align16((size_t)T * D * elem) + pa_align16((size_t)G * T * 4)
         + 2 * pa_align16((size_t)G * pps * 4)
         + pa_align16((size_t)3 * pps * 4)
         + pa_align16((size_t)pa_splits(page, P) * G * 4)
         + (quant ? pa_align16((size_t)T * 4) : 0);
}

// The workspace, per (b, h) and page i < P: the page's scores (G x page),
// and per query head its max, the sum of its p and its p V (D); per
// (b, h) and split, the max of its pages' maxima per query head.
struct PaWs {
  float *sc, *pm, *ps, *pv, *sm;
  __host__ __device__ PaWs(float* ws, int B, int Hkv, int G, int D,
                           int page, int P) {
    const size_t pages = (size_t)B * Hkv * P;
    sc = ws;
    pm = sc + pages * G * page;
    ps = pm + pages * G;
    pv = ps + pages * G;
    sm = pv + pages * G * D;
  }
};

// One 16-byte chunk (VEC elements) of a row widened to float32; VEC 1:
// one element (rows whose bytes are not a multiple of 16).  An int8
// element is float(k8) * s, the product rounded once; other types
// ignore s.
template <typename T, int VEC>
__device__ __forceinline__ void widen(const T* p, float* x, float s) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_f(p[i]);
  }
  if constexpr (PaQuant<T>::on) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __fmul_rn(x[i], s);
  }
}

// The scales of a split's tokens for kv head h, one a token slot (0 for
// a hole's), into shared memory; int8 pages only.
template <typename T>
__device__ __forceinline__ void load_scales(float* dst,
                                            const float* __restrict__ src,
                                            const int* pid, int toks,
                                            int page, int Hkv, int h) {
  if constexpr (PaQuant<T>::on) {
    for (int u = threadIdx.x; u < toks; u += blockDim.x) {
      const int id = pid[u / page];
      dst[u] = id >= 0 ? src[(size_t)(id * page + u % page) * Hkv + h]
                       : 0.f;
    }
  }
}

// One chunk of VEC elements into shared memory: a 16-byte cp.async, or
// element by element.
template <typename T, int VEC>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src) {
  if constexpr (VEC * sizeof(T) == 16) {
    __pipeline_memcpy_async(dst, src, 16);
  } else {
    for (int i = 0; i < VEC; ++i) dst[i] = src[i];
  }
}

// A split block's place: (b, h) = blockIdx.x / Hkv, % Hkv, split
// blockIdx.y from page p0, its live page slots (up to the last one that
// holds an attended token; 0: none does), their page ids in pid (-1: a
// hole, or a slot with no attended token) and their token runs in
// [lo, hi) (pid + pps, pid + 2 pps), the table entries loaded beside
// seq_len.  The caller synchronises before reading pid.
struct PaSplit {
  int b, h, bh, p0, seq, live;
};

__device__ __forceinline__ PaSplit pa_split(const int* table,
                                            const int* seq_lens, int Hkv,
                                            int page, int P, int NP,
                                            int wpp, int window, int ring,
                                            int* pid) {
  PaSplit sp;
  sp.bh = blockIdx.x;
  sp.b = sp.bh / Hkv;
  sp.h = sp.bh % Hkv;
  const int pps = pa_pages_per_split(page), tid = threadIdx.x;
  sp.p0 = blockIdx.y * pps;
  int raw = -1;
  if (tid < pps && sp.p0 + tid < P)
    raw = table[(size_t)sp.b * P + sp.p0 + tid];
  sp.seq = seq_lens[sp.b];
  sp.live = 0;
  for (int i = 0; i < pps && sp.p0 + i < P; ++i) {
    int lo, hi;
    pa_slot_range(sp.p0 + i, sp.seq, page, P, window, ring, &lo, &hi);
    if (lo < hi) sp.live = i + 1;
  }
  if (sp.live && tid < pps) {
    int lo = 0, hi = 0;
    if (tid < sp.live)
      pa_slot_range(sp.p0 + tid, sp.seq, page, P, window, ring, &lo, &hi);
    const int id = wpp > 0 ? floordiv(raw, wpp) : raw;
    const bool on = lo < hi && id >= 0 && id < NP;
    pid[tid] = on ? id : -1;
    pid[pps + tid] = lo;
    pid[2 * pps + tid] = on ? hi : lo;
  }
  return sp;
}

// Kernel 1: a split's scores and page maxima.  TQ: q's type; T: the
// pages' (ksc: their K scales when T is int8, else unused).
template <typename TQ, typename T, int VEC>
__global__ void __launch_bounds__(PA_THREADS) paged_attention_kernel(
    const TQ* __restrict__ q, const T* __restrict__ kp,
    const float* __restrict__ ksc, const int* __restrict__ table,
    const int* __restrict__ seq_lens, float* __restrict__ ws, int B, int Hq,
    int Hkv, int D, int page, int P, int NP, int wpp, int window, int ring,
    float scale) {
  extern __shared__ float4 pa_smem[];
  const int G = Hq / Hkv, tid = threadIdx.x, nt = blockDim.x;
  const int pps = pa_pages_per_split(page), slots = pps * page;
  char* base = reinterpret_cast<char*>(pa_smem);
  T* ks = reinterpret_cast<T*>(base);
  base += pa_align16((size_t)slots * D * sizeof(T));
  float* qs = reinterpret_cast<float*>(base);
  base += pa_align16((size_t)G * D * 4);
  float* sc = reinterpret_cast<float*>(base);  // (G, slots)
  base += pa_align16((size_t)G * slots * 4);
  int* pid = reinterpret_cast<int*>(base);
  const int *tlo = pid + pps, *thi = pid + 2 * pps;
  base += pa_align16((size_t)3 * pps * 4);
  float* kss = reinterpret_cast<float*>(base);  // K scales (int8 pages)
  const PaSplit sp = pa_split(table, seq_lens, Hkv, page, P, NP, wpp,
                              window, ring, pid);
  const PaWs w(ws, B, Hkv, G, D, page, P);
  float* smax = w.sm + ((size_t)sp.bh * pa_splits(page, P) + blockIdx.y) * G;
  if (!sp.live) {  // no attended token: the split maximum the later
    for (int g = tid; g < G; g += nt) smax[g] = PA_NEG;  // splits read
    return;
  }
  __syncthreads();

  const int cpr = D / VEC;  // chunks a row
  const int toks = sp.live * page;
  for (int e = tid; e < toks * cpr; e += nt) {
    const int u = e / cpr, c = e - u * cpr;  // token slot, chunk
    const int id = pid[u / page];
    if (id >= 0)
      copy_chunk<T, VEC>(ks + ((size_t)c * slots + u) * VEC,
                         kp + ((size_t)(id * page + u % page) * Hkv + sp.h)
                                  * D + c * VEC);
  }
  __pipeline_commit();
  // q and the scales while the K rows arrive
  const TQ* qg = q + ((size_t)sp.b * Hq + sp.h * G) * D;
  for (int i = tid; i < G * D; i += nt) qs[i] = to_f(qg[i]);
  load_scales<T>(kss, ksc, pid, toks, page, Hkv, sp.h);
  __pipeline_wait_prior(0);
  __syncthreads();

  // one thread per (query head, token of a page that is not a hole)
  const size_t pg0 = (size_t)sp.bh * P + sp.p0;  // the split's first page
  for (int e = tid; e < G * toks; e += nt) {
    const int g = e / toks, u = e - g * toks, i = u / page;
    if (pid[i] < 0) continue;
    const float* qr = qs + g * D;
    const float ku = PaQuant<T>::on ? kss[u] : 1.f;
    float s = 0.f;
    for (int c = 0; c < cpr; ++c) {
      float x[VEC];
      widen<T, VEC>(ks + ((size_t)c * slots + u) * VEC, x, ku);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s = fmaf(qr[c * VEC + j], x[j], s);
    }
    s *= scale;
    sc[g * slots + u] = s;
    w.sc[((pg0 + i) * G + g) * page + u - i * page] = s;
  }
  __syncthreads();
  // each page's max over its attended tokens (a hole's: PA_NEG), and
  // the split's max of them, per query head
  for (int g = tid; g < G; g += nt) {
    float ms = PA_NEG;
    for (int i = 0; i < sp.live; ++i) {
      float m = PA_NEG;
      for (int t = tlo[i]; t < thi[i]; ++t)
        m = fmaxf(m, sc[g * slots + i * page + t]);
      w.pm[(pg0 + i) * G + g] = m;
      ms = fmaxf(ms, m);
    }
    smax[g] = ms;
  }
}

// Kernel 2: a split's p, sum of p and p V per page, each page's p taken
// against the running max of the pages up to it (vsc: the V scales when
// T is int8, else unused).
template <typename T, int VEC>
__global__ void __launch_bounds__(PA_THREADS) paged_attention_values_kernel(
    const T* __restrict__ vp, const float* __restrict__ vsc,
    const int* __restrict__ table, const int* __restrict__ seq_lens,
    float* __restrict__ ws, int B, int Hq, int Hkv, int D, int page, int P,
    int NP, int wpp, int window, int ring) {
  extern __shared__ float4 pa_smem[];
  const int G = Hq / Hkv, tid = threadIdx.x, nt = blockDim.x;
  const int pps = pa_pages_per_split(page), slots = pps * page;
  char* base = reinterpret_cast<char*>(pa_smem);
  T* vs = reinterpret_cast<T*>(base);
  base += pa_align16((size_t)slots * D * sizeof(T));
  float* pr = reinterpret_cast<float*>(base);  // (G, slots)
  base += pa_align16((size_t)G * slots * 4);
  float* mrun = reinterpret_cast<float*>(base);  // (G, pps)
  base += pa_align16((size_t)G * pps * 4);
  float* pmo = reinterpret_cast<float*>(base);  // (pps, G) page maxima
  base += pa_align16((size_t)G * pps * 4);
  int* pid = reinterpret_cast<int*>(base);
  const int *tlo = pid + pps, *thi = pid + 2 * pps;
  base += pa_align16((size_t)3 * pps * 4);
  float* smx = reinterpret_cast<float*>(base);  // earlier splits' maxima
  base += pa_align16((size_t)pa_splits(page, P) * G * 4);
  float* vss = reinterpret_cast<float*>(base);  // V scales (int8 pages)
  const PaSplit sp = pa_split(table, seq_lens, Hkv, page, P, NP, wpp,
                              window, ring, pid);
  if (!sp.live) return;
  __syncthreads();

  const int cpr = D / VEC;
  for (int e = tid; e < sp.live * page * cpr; e += nt) {
    const int u = e / cpr, c = e - u * cpr;
    const int id = pid[u / page];
    if (id >= 0)
      copy_chunk<T, VEC>(vs + (size_t)u * D + c * VEC,
                         vp + ((size_t)(id * page + u % page) * Hkv + sp.h)
                                  * D + c * VEC);
  }
  __pipeline_commit();

  // the running max at each of the split's pages: the max of the page
  // maxima up to it (a hole's is PA_NEG), from the earlier splits' maxima
  // and the split's own page maxima, all loaded together, then one
  // thread per query head (a max is exact in any order)
  const PaWs w(ws, B, Hkv, G, D, page, P);
  const size_t pg0 = (size_t)sp.bh * P + sp.p0;
  const int s = blockIdx.y;
  const float* smb = w.sm + (size_t)sp.bh * pa_splits(page, P) * G;
  for (int e = tid; e < s * G; e += nt) smx[e] = smb[e];
  for (int e = tid; e < sp.live * G; e += nt) pmo[e] = w.pm[pg0 * G + e];
  load_scales<T>(vss, vsc, pid, sp.live * page, page, Hkv, sp.h);
  __syncthreads();
  for (int g = tid; g < G; g += nt) {
    float m = PA_NEG;
    for (int j = 0; j < s; ++j) m = fmaxf(m, smx[j * G + g]);
    for (int i = 0; i < sp.live; ++i) {
      m = fmaxf(m, pmo[i * G + g]);
      mrun[g * pps + i] = m;
    }
  }
  __syncthreads();
  // p of each attended token of a page that is not a hole, else 0
  const int toks = sp.live * page;
  for (int e = tid; e < G * toks; e += nt) {
    const int g = e / toks, u = e - g * toks, i = u / page;
    const int t = u - i * page;
    float p = 0.f;
    if (pid[i] >= 0 && t >= tlo[i] && t < thi[i])
      p = expf(w.sc[((pg0 + i) * G + g) * page + t] - mrun[g * pps + i]);
    pr[g * slots + u] = p;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  // per page and query head: the sum of p over the page's slots in
  // order, then p V over its attended tokens in order
  for (int e = tid; e < G * sp.live; e += nt) {
    const int g = e / sp.live, i = e - g * sp.live;
    if (pid[i] < 0) continue;
    float psum = 0.f;
    for (int t = 0; t < page; ++t) psum += pr[g * slots + i * page + t];
    w.ps[(pg0 + i) * G + g] = psum;
  }
  for (int e = tid; e < sp.live * G * D; e += nt) {
    const int i = e / (G * D), gd = e - i * G * D, g = gd / D, d = gd - g * D;
    if (pid[i] < 0) continue;
    const float* prow = pr + g * slots + i * page;
    const T* vcol = vs + (size_t)i * page * D + d;
    float sum = 0.f;
#pragma unroll 4
    for (int t = tlo[i]; t < thi[i]; ++t) {
      float x = to_f(vcol[(size_t)t * D]);
      if constexpr (PaQuant<T>::on) x = __fmul_rn(x, vss[i * page + t]);
      sum += prow[t] * x;
    }
    w.pv[((pg0 + i) * G + g) * D + d] = sum;
  }
}

// Kernel 3: one block per (b, h), one thread per output element (the
// block covers G * D up to 1024): the online softmax's fold over the
// pages in table order, holes and slots with no attended token skipped
// (their update is the identity), out = acc / (l + 1e-30).  The table
// row's flags are staged in shared memory first; a batch's page terms
// load together, whatever the flags say.
__global__ void __launch_bounds__(1024) paged_attention_merge_kernel(
    const int* __restrict__ table, const int* __restrict__ seq_lens,
    float* __restrict__ ws, float* __restrict__ out, int B, int Hq, int Hkv,
    int D, int page, int P, int NP, int wpp, int window, int ring) {
  extern __shared__ int pa_on[];  // P flags: the slot adds to the fold
  const int G = Hq / Hkv, bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int seq = seq_lens[b];
  for (int i = threadIdx.x; i < P; i += blockDim.x) {  // beside seq_len
    const int raw = table[(size_t)b * P + i];
    const int id = wpp > 0 ? floordiv(raw, wpp) : raw;
    int lo, hi;
    pa_slot_range(i, seq, page, P, window, ring, &lo, &hi);
    pa_on[i] = lo < hi && id >= 0 && id < NP;
  }
  int first, npages;
  pa_fold_span(seq, page, P, window, ring, &first, &npages);
  __syncthreads();
  const PaWs w(ws, B, Hkv, G, D, page, P);
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D;
    float m = PA_NEG, l = 0.f, acc = 0.f;
    for (int i0 = first; i0 < npages; i0 += PA_FOLD_BATCH) {
      float pmv[PA_FOLD_BATCH], psv[PA_FOLD_BATCH], pvv[PA_FOLD_BATCH];
#pragma unroll
      for (int j = 0; j < PA_FOLD_BATCH; ++j) {
        if (i0 + j >= npages) break;
        const size_t pg = ((size_t)bh * P + i0 + j) * G + g;
        pmv[j] = w.pm[pg];
        psv[j] = w.ps[pg];
        pvv[j] = w.pv[pg * D + (e - g * D)];
      }
#pragma unroll
      for (int j = 0; j < PA_FOLD_BATCH; ++j) {
        if (i0 + j >= npages) break;
        if (!pa_on[i0 + j]) continue;  // a hole: the update is the identity
        const float m_new = fmaxf(m, pmv[j]);
        const float a = expf(m - m_new);
        l = a * l + psv[j];
        acc = a * acc + pvv[j];
        m = m_new;
      }
    }
    out[((size_t)b * Hq + h * G) * D + e] = acc / (l + 1e-30f);
  }
}

// the merge kernel's block: one thread per output element, up to 1024
static inline int pa_merge_threads(int G, int D) {
  const int t = (G * D + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// ---- launch geometry (also used by the emulation harness) -------------

// (pages a split, splits) for a page size and table width
extern "C" void paged_attention_geometry(int page, int P, int* pps,
                                         int* splits) {
  *pps = pa_pages_per_split(page);
  *splits = pa_splits(page, P);
}

// floats of the workspace (PaWs)
extern "C" size_t paged_attention_workspace_floats(int B, int Hq, int Hkv,
                                                   int D, int page, int P) {
  return (size_t)B * Hkv * (Hq / Hkv)
         * ((size_t)P * (page + 2 + D) + pa_splits(page, P));
}

// dynamic shared memory of the split kernels (kernel 1, kernel 2) for
// pages of elem bytes an element (1: int8, with scales)
extern "C" size_t paged_attention_smem_bytes(int G, int D, int page, int P,
                                             int elem, int kernel) {
  return kernel == 1 ? pa_smem_k1(G, D, page, (size_t)elem, elem == 1)
                     : pa_smem_k2(G, D, page, P, (size_t)elem, elem == 1);
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

static int pa_smem_attr(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename TQ, typename T, int VEC>
static int launch(const void* q, const void* k, const void* v,
                  const float* ksc, const float* vsc, const int* table,
                  const int* seq_lens, float* out, float* ws, int B, int Hq,
                  int Hkv, int D, int page, int P, int NP, int wpp,
                  int window, int ring, float scale, cudaStream_t st) {
  const int G = Hq / Hkv;
  const bool quant = PaQuant<T>::on;
  const auto k1 = paged_attention_kernel<TQ, T, VEC>;
  const auto k2 = paged_attention_values_kernel<T, VEC>;
  const size_t s1 = pa_smem_k1(G, D, page, sizeof(T), quant);
  const size_t s2 = pa_smem_k2(G, D, page, P, sizeof(T), quant);
  int err = pa_smem_attr((const void*)k1, s1);
  if (!err) err = pa_smem_attr((const void*)k2, s2);
  if (err) return err;
  if (P > 0) {  // a table of no pages: every output is 0, from the merge
    const dim3 grid(B * Hkv, pa_splits(page, P));
    k1<<<grid, PA_THREADS, s1, st>>>((const TQ*)q, (const T*)k, ksc,
                                      table, seq_lens, ws, B, Hq, Hkv, D,
                                      page, P, NP, wpp, window, ring, scale);
    err = (int)cudaGetLastError();
    if (err) return err;
    k2<<<grid, PA_THREADS, s2, st>>>((const T*)v, vsc, table, seq_lens, ws,
                                      B, Hq, Hkv, D, page, P, NP, wpp,
                                      window, ring);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const size_t s3 = (size_t)P * sizeof(int);
  err = pa_smem_attr((const void*)paged_attention_merge_kernel, s3);
  if (err) return err;
  paged_attention_merge_kernel<<<B * Hkv, pa_merge_threads(G, D), s3, st>>>(
      table, seq_lens, ws, out, B, Hq, Hkv, D, page, P, NP, wpp, window,
      ring);
  return (int)cudaGetLastError();
}

// q in bf16 (q_bf16) or float32; K and V in q's type, or int8 (kv_int8)
// with their float32 scales k_scale, v_scale (NP, page, Hkv)
extern "C" int paged_attention_launch(
    int q_bf16, int kv_int8, const void* q, const void* k, const void* v,
    const float* k_scale, const float* v_scale, const int* table,
    const int* seq_lens, float* out, float* ws, int B, int Hq, int Hkv,
    int D, int page, int P, int NP, int wpp, int window, int ring,
    float scale, void* stream) {
  // 16-byte chunks of K and V when a row's bytes are a multiple of 16:
  // every row then starts 16-byte aligned if the tensors do
  using bf16 = __nv_bfloat16;
  const int elem = kv_int8 ? 1 : (q_bf16 ? 2 : 4);
  const bool vec = (D * elem) % 16 == 0
                   && ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  decltype(&launch<float, float, 4>) fn;
  if (kv_int8)
    fn = q_bf16 ? (vec ? launch<bf16, int8_t, 16> : launch<bf16, int8_t, 1>)
                : (vec ? launch<float, int8_t, 16>
                       : launch<float, int8_t, 1>);
  else
    fn = q_bf16 ? (vec ? launch<bf16, bf16, 8> : launch<bf16, bf16, 1>)
                : (vec ? launch<float, float, 4> : launch<float, float, 1>);
  return fn(q, k, v, k_scale, v_scale, table, seq_lens, out, ws, B, Hq, Hkv,
            D, page, P, NP, wpp, window, ring, scale, (cudaStream_t)stream);
}
