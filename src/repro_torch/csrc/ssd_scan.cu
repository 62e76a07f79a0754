// Mamba-2 SSD chunked scan (state-space duality): one launch per prefill
// layer of the ssm family.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (the TPU Pallas fast
// path of models/ssm.py::ssd_jnp).  The plain PyTorch version is
// ssd_plain in src/repro_torch/kernels/ssd_scan.py (a mirror of ssd_jnp);
// the naive recurrence kernels/ref.py::ssd_ref is the tests' oracle.
//
// Math, per (batch row b, head h) and chunk of Q steps (cum = in-chunk
// cumulative sum of dt * a, every exponent <= 0 since a < 0 <= dt):
//   W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j      for j <= i, else 0
//   y_i     = sum_j W[i][j] x_j + exp(cum_i) C_i h^T
//   h      <- exp(cum_{Q-1}) h + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_j^T
// with the (P, N) float32 state h carried from chunk to chunk.
//
// What bounds it on the H100: operations.  The inputs need, per chunk and
// head, 2 (Q(Q+1)/2 P + 2 Q P N) float32 operations for W x and the two
// state terms (2.4 MFLOP at Q 64, P 64, N 128), plus 2 Q(Q+1)/2 N for the
// masked C B^T once per group (bf16 B and C multiply exactly on the
// tensor cores), against 6 Q P bytes of x in and y out: even at the
// float32 rate outside the tensor cores (67 TFLOP/s) the work outweighs
// the bytes by about 5x.  This first kernel computes the whole Q x Q
// C B^T of every head, masks it, and uses no tensor cores (wgmma later).
//
// Design: one block of 256 threads per (b, h), walking the chunks in
// order (the TPU's sequential grid axis becomes this loop).  The state
// stays in shared memory for the whole scan; each chunk stages x, B, C
// (widened to float32) and dt in shared memory, computes the cumsum on
// one thread (Q adds), then the three products above as register-tiled
// FMA loops: each thread owns a strided 4x4 (y, W) or 4x8 (state) tile
// of the output, so an operand load feeds 4-8 FMAs.  Rows are padded by
// one word so that a warp's column-wise reads fall in distinct banks.
// At Q 64, P 64, N 128 that is 130 KB of dynamic shared memory, one
// block per SM; B * H = 48 blocks at the engine's single-row prefill,
// on 132 SMs.
//
// Limits (checked by the wrapper): Q <= 64, P <= 64, N <= 128, L a
// multiple of Q, H a multiple of G (head h reads group h / (H / G)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SSD_THREADS 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x (B, L, H, P) and b, c (B, L, G, N) of type T; dt (B, L, H) f32; a (H,)
// f32; h0 (B, H, P, N) f32 or null.  y (B, L, H, P) f32; hf (B, H, P, N).
template <typename T>
__global__ void ssd_scan_kernel(const T* x, const float* dt, const float* a,
                                const T* b, const T* c, const float* h0,
                                float* y, float* hf, int L, int H, int P,
                                int G, int N, int Q) {
  extern __shared__ float smem[];
  const int P1 = P + 1, N1 = N + 1, Q1 = Q + 1;
  float* s_h = smem;                 // P x N1: the carried state
  float* s_x = s_h + P * N1;         // Q x P1
  float* s_b = s_x + Q * P1;         // Q x N1
  float* s_c = s_b + Q * N1;         // Q x N1
  float* s_w = s_c + Q * N1;         // Q x Q1
  float* s_dt = s_w + Q * Q1;        // Q
  float* s_cum = s_dt + Q;           // Q
  float* s_wj = s_cum + Q;           // Q: exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bi = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const float ah = a[h];
  const long long hbase = ((long long)bi * H + h) * P * N;

  for (int k = tid; k < P * N; k += SSD_THREADS)
    s_h[(k / N) * N1 + k % N] = h0 ? h0[hbase + k] : 0.f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    __syncthreads();  // the previous chunk is done with the staged tiles
    for (int k = tid; k < Q * P; k += SSD_THREADS) {
      const int i = k / P, p = k % P;
      const long long row = (long long)bi * L + t0 + i;
      s_x[i * P1 + p] = to_f32(x[(row * H + h) * P + p]);
    }
    for (int k = tid; k < Q * N; k += SSD_THREADS) {
      const int i = k / N, n = k % N;
      const long long off = (((long long)bi * L + t0 + i) * G + g) * N + n;
      s_b[i * N1 + n] = to_f32(b[off]);
      s_c[i * N1 + n] = to_f32(c[off]);
    }
    for (int i = tid; i < Q; i += SSD_THREADS)
      s_dt[i] = dt[((long long)bi * L + t0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += s_dt[i] * ah;
        s_cum[i] = run;
      }
    }
    __syncthreads();
    const float cum_last = s_cum[Q - 1];
    for (int j = tid; j < Q; j += SSD_THREADS)
      s_wj[j] = expf(cum_last - s_cum[j]) * s_dt[j];

    // W = (C B^T) * decay * dt, lower triangle (j <= i)
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = ty + 16 * u, j = tx + 16 * u;
          cv[u] = i < Q ? s_c[i * N1 + n] : 0.f;
          bv[u] = j < Q ? s_b[j * N1 + n] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += cv[u] * bv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ty + 16 * u, j = tx + 16 * v;
          if (i < Q && j < Q)
            s_w[i * Q1 + j] = j <= i
                ? acc[u][v] * expf(s_cum[i] - s_cum[j]) * s_dt[j] : 0.f;
        }
    }
    __syncthreads();

    // y = W x + exp(cum) C h^T, written straight to device memory
    {
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < Q; ++j) {
        float wv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = ty + 16 * u, p = tx + 16 * u;
          wv[u] = i < Q ? s_w[i * Q1 + j] : 0.f;
          xv[u] = p < P ? s_x[j * P1 + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) intra[u][v] += wv[u] * xv[v];
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = ty + 16 * u, p = tx + 16 * u;
          cv[u] = i < Q ? s_c[i * N1 + n] : 0.f;
          hv[u] = p < P ? s_h[p * N1 + n] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) inter[u][v] += cv[u] * hv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ty + 16 * u;
        if (i >= Q) continue;
        const float e = expf(s_cum[i]);
        const long long row = (long long)bi * L + t0 + i;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = tx + 16 * v;
          if (p < P) y[(row * H + h) * P + p] = intra[u][v] + e * inter[u][v];
        }
      }
    }
    __syncthreads();  // every read of the incoming state is done

    // h = exp(cum_last) h + sum_j (x_j wj_j) B_j^T, in place per thread
    {
      const float keep = expf(cum_last);
      float acc[4][8] = {};
      for (int j = 0; j < Q; ++j) {
        const float wj = s_wj[j];
        float xv[4], bv[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = ty + 16 * u;
          xv[u] = p < P ? s_x[j * P1 + p] * wj : 0.f;
        }
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int n = tx + 16 * v;
          bv[v] = n < N ? s_b[j * N1 + n] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] += xv[u] * bv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int p = ty + 16 * u, n = tx + 16 * v;
          if (p < P && n < N)
            s_h[p * N1 + n] = keep * s_h[p * N1 + n] + acc[u][v];
        }
    }
  }
  __syncthreads();
  for (int k = tid; k < P * N; k += SSD_THREADS)
    hf[hbase + k] = s_h[(k / N) * N1 + k % N];
}

// ---- launch geometry (also used by the emulation harness) -------------

extern "C" size_t ssd_scan_smem_bytes(int P, int N, int Q) {
  return ((size_t)P * (N + 1) + (size_t)Q * (P + 1) + 2 * (size_t)Q * (N + 1)
          + (size_t)Q * (Q + 1) + 3 * (size_t)Q) * sizeof(float);
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

template <typename T>
static int launch(const void* x, const float* dt, const float* a,
                  const void* b, const void* c, const float* h0, float* y,
                  float* hf, int B, int L, int H, int P, int G, int N, int Q,
                  cudaStream_t stream) {
  const size_t smem = ssd_scan_smem_bytes(P, N, Q);
  int err = (int)cudaFuncSetAttribute(
      (const void*)ssd_scan_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  ssd_scan_kernel<T><<<B * H, SSD_THREADS, smem, stream>>>(
      (const T*)x, dt, a, (const T*)b, (const T*)c, h0, y, hf, L, H, P, G,
      N, Q);
  return (int)cudaGetLastError();
}

extern "C" int ssd_scan_launch(int bf16, const void* x, const float* dt,
                               const float* a, const void* b, const void* c,
                               const float* h0, float* y, float* hf, int B,
                               int L, int H, int P, int G, int N, int Q,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, dt, a, b, c, h0, y, hf, B, L, H, P,
                                      G, N, Q, s)
              : launch<float>(x, dt, a, b, c, h0, y, hf, B, L, H, P, G, N,
                              Q, s);
}
