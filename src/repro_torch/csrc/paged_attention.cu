// Paged GQA decode attention over the Ouroboros-managed KV page heap.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention (the
// Pallas kernel; the reference host loop decodes with the jnp
// paged_attend1, which computes the same function).  The plain PyTorch
// version is src/repro_torch/kernels/ref.py::paged_attention.
//
// What it computes: for each sequence b and kv head h, the G = Hq/Hkv
// query heads of that group attend over the tokens the page table maps,
// with an online softmax in float32: scores (q . k) * D^-1/2, tokens at
// or past seq_len and table holes (-1) masked, output acc / (l + 1e-30).
// The table holds page ids, or arena word offsets when wpp > 0 (page =
// floor(offset / wpp), so a -1 hole stays -1).
//
// What bounds it on the H100: the bytes of K and V it reads (each
// valid token's Hkv * D elements, twice) at 3.35 TB/s; the arithmetic
// (4 * G * D flops per token per kv head) is far below the card's rate.
//
// Design: one block per (b, kv head), looping over the sequence's pages
// in table order, as the TPU grid's innermost dimension did.  Each page
// is staged into shared memory as float32 (bf16 or f32 in), then the
// block computes the G x page scores, one thread per query head updates
// its running max and sum, and the block folds p V into the (G, D)
// accumulator.  Pages past seq_len and holes are skipped: for them the
// reference's update is the identity.  Simple and right first: no TMA,
// no tensor cores, one page per step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ seq_lens, float* __restrict__ out, int Hq,
    int Hkv, int D, int page, int P, int NP, int wpp, float scale) {
  extern __shared__ float sm[];
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* qs = sm;                 // G*D
  float* ks = qs + G * D;         // page*D
  float* vs = ks + page * D;      // page*D
  float* sc = vs + page * D;      // G*page
  float* acc = sc + G * page;     // G*D
  float* m = acc + G * D;         // G
  float* l = m + G;               // G
  float* alpha = l + G;           // G

  for (int i = tid; i < G * D; i += nt) {
    qs[i] = to_f(q[((size_t)b * Hq + h * G) * D + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += nt) {
    m[g] = -1e30f;
    l[g] = 0.f;
  }
  const int seq = seq_lens[b];
  int npages = seq <= 0 ? 0 : (seq + page - 1) / page;
  if (npages > P) npages = P;
  __syncthreads();

  for (int i = 0; i < npages; ++i) {
    const int raw = table[(size_t)b * P + i];
    const int pid = wpp > 0 ? floordiv(raw, wpp) : raw;
    if (pid < 0 || pid >= NP) continue;  // hole: the update is the identity
    const size_t base = (size_t)pid * page * Hkv * D;
    for (int e = tid; e < page * D; e += nt) {
      const int t = e / D, d = e % D;
      const size_t off = base + ((size_t)t * Hkv + h) * D + d;
      ks[e] = to_f(kp[off]);
      vs[e] = to_f(vp[off]);
    }
    __syncthreads();
    const int ntok = min(page, seq - i * page);
    for (int e = tid; e < G * page; e += nt) {
      const int g = e / page, t = e % page;
      float s = 0.f;
      if (t < ntok) {
        const float* qr = qs + g * D;
        const float* kr = ks + t * D;
        for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
        s *= scale;
      }
      sc[e] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += nt) {
      float* row = sc + g * page;
      const float m_old = m[g];
      float m_new = m_old;
      for (int t = 0; t < ntok; ++t) m_new = fmaxf(m_new, row[t]);
      float psum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = t < ntok ? expf(row[t] - m_new) : 0.f;
        row[t] = p;
        psum += p;
      }
      const float a = expf(m_old - m_new);
      l[g] = a * l[g] + psum;
      m[g] = m_new;
      alpha[g] = a;
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += nt) {
      const int g = e / D, d = e % D;
      const float* prow = sc + g * page;
      float sum = 0.f;
      for (int t = 0; t < ntok; ++t) sum += prow[t] * vs[t * D + d];
      acc[e] = alpha[g] * acc[e] + sum;
    }
    __syncthreads();
  }
  for (int e = tid; e < G * D; e += nt) {
    const int g = e / D;
    out[((size_t)b * Hq + h * G) * D + e] = acc[e] / (l[g] + 1e-30f);
  }
}

// ---- launch geometry (also used by the emulation harness) -------------

extern "C" size_t paged_attention_smem_bytes(int G, int D, int page) {
  return (size_t)(2 * G * D + 2 * page * D + G * page + 3 * G)
         * sizeof(float);
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const int* table, const int* seq_lens, float* out, int B,
                  int Hq, int Hkv, int D, int page, int P, int NP, int wpp,
                  float scale, cudaStream_t s) {
  const size_t smem = paged_attention_smem_bytes(Hq / Hkv, D, page);
  if (smem > 48 * 1024) {
    int err = (int)cudaFuncSetAttribute(
        (const void*)paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  paged_attention_kernel<T><<<B * Hkv, 128, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, table, seq_lens, out, Hq, Hkv,
      D, page, P, NP, wpp, scale);
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_launch(
    int dtype_bf16, const void* q, const void* k, const void* v,
    const int* table, const int* seq_lens, float* out, int B, int Hq,
    int Hkv, int D, int page, int P, int NP, int wpp, float scale,
    void* stream) {
  auto fn = dtype_bf16 ? launch<__nv_bfloat16> : launch<float>;
  return fn(q, k, v, table, seq_lens, out, B, Hq, Hkv, D, page, P, NP, wpp,
            scale, (cudaStream_t)stream);
}
