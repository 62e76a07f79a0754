// Mamba-2 SSD chunked scan (state-space duality): three launches per
// prefill layer of the ssm family, one wrapper call.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (the TPU Pallas fast
// path of models/ssm.py::ssd_jnp).  The plain PyTorch version is
// ssd_plain in src/repro_torch/kernels/ssd_scan.py (a mirror of ssd_jnp);
// the naive recurrence kernels/ref.py::ssd_ref is the tests' oracle.
//
// Math, per (batch row b, head h) and chunk c of Q steps (cum = in-chunk
// cumulative sum of dt * a, every exponent <= 0 since a < 0 <= dt):
//   W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j      for j <= i, else 0
//   y_i     = sum_j W[i][j] x_j + exp(cum_i) C_i h_{c-1}^T
//   S_c     = sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_j^T
//   h_c     = exp(cum_{Q-1}) h_{c-1} + S_c
// with the (P, N) float32 state h_{-1} = h0 (or 0).
//
// What bounds it on the H100: operations.  The inputs need, per chunk and
// head, 2 (Q(Q+1)/2 P + 2 Q P N) float32 operations for W x and the two
// state terms (2.4 MFLOP at Q 64, P 64, N 128), plus 2 Q(Q+1)/2 N for the
// masked C B^T once per group (bf16 B and C multiply exactly on the
// tensor cores), against 6 Q P bytes of x in and y out: even at the
// float32 rate outside the tensor cores (67 TFLOP/s) the work outweighs
// the bytes by about 5x.
//
// Design: the SSD decomposition.  Everything but one elementwise pass is
// parallel over chunks, so a prefill of 1-7 chunks fills the card with
// (chunk, head) blocks instead of walking the chunks in one block per
// head:
//   1. ssd_chunk_kernel, two kinds of block in one grid:
//      - per (b, c, group), first: C B^T once for the group's heads, its
//        lower-triangle 16x16 tiles only, on the tensor cores for bf16
//        inputs (wmma 16x16x16, bf16 operands, float32 sums: products of
//        bf16 values are exact in float32), on the FMA pipes for float32
//        inputs; stored transposed (cbT[j][i]);
//      - per (b, c, h), or per half of its N columns when a wave of the
//        card holds the halves (ssd_state_halves): the head's cumsum of
//        dt * a, and S_c = X~^T B with X~_j = exp(cum_{Q-1} - cum_j)
//        dt_j x_j, an 8 x 4 (halves: 4 x 4) float32 register tile a
//        thread, operands from shared memory.  For a scan of one chunk
//        it writes h_final = exp(cum_{Q-1}) h0 + S_0 itself, and step 2
//        is not launched.
//   2. ssd_pass_kernel, a thread per 4 state elements: the serial pass
//      h_c = exp(cum_{Q-1}) h_{c-1} + S_c in chunk order, overwriting S_c
//      with h_{c-1} (the state entering chunk c > 0) and writing h_final;
//      up to 8 chunks' S and decays are loaded before the walk.
//   3. ssd_scan_kernel, a block of 512 threads per (b, c, h): y = W x +
//      exp(cum) (C h_{c-1}^T), a 4 x 4 register tile a thread over the
//      (Q, P) output, one group of 8 warps over W x (each warp's depth
//      cut at its last row: W is lower triangular), the other over
//      C h^T, their sums joined through shared memory; W built in shared
//      memory from cbT, cum and dt (exp of differences, so nothing
//      overflows); C h^T skipped for chunk 0 of a scan from a zero state
//      (h_{-1} = h0 read from h0).
// Every sum runs in the plain version's order: the cumsum serially (the
// rounded dt_i a added in turn), each product's sum over its depth in
// order, W x and exp(cum) (C h^T) apart.  At a serving run's steps (dt up
// to ~20) a chunk's decays span e^-1000, and a cumsum or a product summed
// in another order (a warp scan; W x and C h^T in one sum; a depth split
// between warps) left the outputs up to 2e-3 beyond the tolerance from
// the plain version, where the plain version itself is off float64 by
// ~5e-3.
// A block's staging is latency bound (a block alone on its SM at 1-2
// chunks), so every thread issues all its loads of a tile before it uses
// any (and the exps of W read all their operands first): inputs
// into registers (a warp a row, lanes along it: coalesced), widened to
// float32 on the way to shared memory, so the inner loops read float32
// only; the float32 scratch (cbT, h_{c-1}) by cp.async, in flight
// meanwhile.  Scratch (the wrapper's torch.empty,
// ssd_scan_workspace_floats): cbT (B, nc, G, Q, Q), cum (B, nc, H, Q)
// and the chunk states (B, nc, H, P, N), 11 MB at 7 chunks of
// mamba2-780m.
//
// Limits (checked by the wrapper): Q <= 64, P <= 64, N <= 128, L a
// multiple of Q, H a multiple of G (head h reads group h / (H / G)).
// Shared-memory tiles are laid out at those maxima.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#define SSD_THREADS 256
#define SSD_WARPS (SSD_THREADS / 32)
#define SSD_QM 64    // maxima of Q and N, the tiles' extents (P <= 64
#define SSD_NM 128   // fits SSD_LDP)
#define SSD_LDQ 68   // padded row strides in floats: multiples of 4 for
#define SSD_LDP 68   // 16-byte loads, not of 32, so that a column walk
                     // spreads over the banks
#define SSD_LDH 136  // bf16 rows of the wmma operands (a multiple of 8)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a,
                                     const float4& b) {
  acc[0] += a * b.x;
  acc[1] += a * b.y;
  acc[2] += a * b.z;
  acc[3] += a * b.w;
}

// Element (r, k) of a rows x cols tile for this thread of a block of NW
// warps: rows warp + NW rr, columns lane + 32 kk, so a warp reads along
// a row.  load_tile issues every load of the thread's share (widened, 0
// outside the tile) before any is used; for_tile visits the same
// positions.
template <int RR, int KK, int NW = SSD_WARPS, typename T>
__device__ __forceinline__ void load_tile(const T* src, long long ld,
                                          int rows, int cols,
                                          float (&v)[RR][KK]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < RR; ++rr)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int r = warp + NW * rr, k = lane + 32 * kk;
      v[rr][kk] = r < rows && k < cols ? to_f32(src[r * ld + k]) : 0.f;
    }
}

template <int RR, int KK, int NW = SSD_WARPS, class F>
__device__ __forceinline__ void for_tile(F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < RR; ++rr)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      f(rr, kk, warp + NW * rr, lane + 32 * kk);
}

// ---- 1. per (b, chunk, group): C B^T; per (b, chunk, head): S_c ----------

// b, c (B, L, G, N) of type T.  cbT (B, nc, G, Q, Q): [j][i] = C_i . B_j
// for the lower-triangle tiles (the rest is never read).
template <typename T>
__device__ __forceinline__ void cb_block(const T* b, const T* c, float* cbT,
                                         float* smem, int blk, int L, int G,
                                         int N, int Q) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nc = L / Q;
  const int g = blk % G, bc = blk / G;  // bc = b * nc + c
  const int bi = bc / nc, t0 = (bc % nc) * Q;
  const long long ld = (long long)G * N;
  const T* cs = c + ((long long)bi * L + t0) * ld + (long long)g * N;
  const T* bs = b + ((long long)bi * L + t0) * ld + (long long)g * N;
  float* out = cbT + (long long)blk * Q * Q;
  const int tiles = (Q + 15) / 16;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // the tensor cores: bf16 tiles (zero past Q rows and N columns, up
    // to whole 16 x 16 tiles), float32 sums
    using namespace nvcuda;
    __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* s_b = s_c + SSD_QM * SSD_LDH;
    float* s_o = reinterpret_cast<float*>(s_b + SSD_QM * SSD_LDH);
    const uint16_t* cr = reinterpret_cast<const uint16_t*>(cs);
    const uint16_t* br = reinterpret_cast<const uint16_t*>(bs);
    uint16_t vc[8][4], vb[8][4];
    for_tile<8, 4>([&](int rr, int kk, int r, int k) {
      const bool in = r < Q && k < N;
      vc[rr][kk] = in ? cr[r * ld + k] : 0;
      vb[rr][kk] = in ? br[r * ld + k] : 0;
    });
    uint16_t* zc = reinterpret_cast<uint16_t*>(s_c);
    uint16_t* zb = reinterpret_cast<uint16_t*>(s_b);
    for_tile<8, 4>([&](int rr, int kk, int r, int k) {
      zc[r * SSD_LDH + k] = vc[rr][kk];
      zb[r * SSD_LDH + k] = vb[rr][kk];
    });
    __syncthreads();
    const int kt = (N + 15) / 16;
    for (int t = warp; t < tiles * (tiles + 1) / 2; t += SSD_WARPS) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      const int tj = t - ti * (ti + 1) / 2;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < kt; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, s_c + ti * 16 * SSD_LDH + k * 16,
                               SSD_LDH);
        wmma::load_matrix_sync(fb, s_b + tj * 16 * SSD_LDH + k * 16,
                               SSD_LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      // stored transposed: s_o[j][i]
      wmma::store_matrix_sync(s_o + tj * 16 * SSD_LDQ + ti * 16, acc,
                              SSD_LDQ, wmma::mem_col_major);
    }
    __syncthreads();
    for_tile<8, 2>([&](int, int, int j, int i) {
      if (j < Q && i < Q && j / 16 <= i / 16)
        out[j * Q + i] = s_o[j * SSD_LDQ + i];
    });
  } else {
    // the FMA pipes: a thread's 4 x 4 outputs (i = ty + 16u, j = tx +
    // 16v) over rows padded by one word
    float* s_c = smem;
    float* s_b = s_c + SSD_QM * (SSD_NM + 1);
    const int N1 = SSD_NM + 1;
    {
      float vc[8][4], vb[8][4];
      load_tile(cs, ld, Q, N, vc);
      load_tile(bs, ld, Q, N, vb);
      for_tile<8, 4>([&](int rr, int kk, int r, int k) {
        s_c[r * N1 + k] = vc[rr][kk];
        s_b[r * N1 + k] = vb[rr][kk];
      });
    }
    __syncthreads();
    const int ty = tid / 16, tx = tid % 16;
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cv[u] = s_c[(ty + 16 * u) * N1 + n];
        bv[u] = s_b[(tx + 16 * u) * N1 + n];
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
        if (i < Q && j <= i) out[j * Q + i] = acc[u][v];
      }
  }
}

// The state blocks of one (b, c, h): 2 when N > 64 and a wave of the
// card holds them (2 B nc H <= 3 sms), each over 64 columns of N, so that
// a prefill of a few chunks spreads over more SMs; else 1.
extern "C" int ssd_state_halves(int B, int L, int H, int N, int Q,
                                int sms) {
  return N > 64 && 2LL * B * (L / Q) * H <= 3LL * sms ? 2 : 1;
}

// x (B, L, H, P) and b (B, L, G, N) of type T; dt (B, L, H) f32; a (H,)
// f32.  cum (B, nc, H, Q): the head's cumsums; st (B, nc, H, P, N) f32:
// S_c.  Block blk is (b, c, h) blk / halves.  kWide: all 128 columns
// of N, each thread an 8 x 4 tile of S; else the 64 columns from n0 =
// 64 (blk % halves) on, each thread a 4 x 4 tile.  Every sum runs as the
// plain version's does (the cumsum serially, S over j in order), so that
// the kernel rounds as it does: at a serving run's steps (dt up to ~20)
// the decays of a chunk span e^-1000, and a cumsum summed in another
// order moves their exponents by more than the tolerance.
template <typename T, bool kWide>
__device__ __forceinline__ void state_block(const T* x, const float* dt,
                                            const float* a, const T* b,
                                            const float* h0, float* cum,
                                            float* st, float* hf,
                                            float* smem, int blk, int L,
                                            int H, int P, int G, int N,
                                            int Q, int halves) {
  constexpr int LDB = kWide ? SSD_NM + 4 : SSD_LDP, KB = kWide ? 4 : 2;
  constexpr int TP = kWide ? 8 : 4;     // p rows a thread
  float* s_x = smem;                    // Q x LDP: X~ = x * w
  float* s_b = s_x + SSD_QM * SSD_LDP;  // Q x LDB: B's columns
  float* s_w = s_b + SSD_QM * LDB;      // Q: exp(cum_last - cum_j) dt_j
  float* s_decay = s_w + SSD_QM;        // exp(cum_last)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = L / Q;
  const int n0 = 64 * (blk % halves);
  blk /= halves;
  const int h = blk % H, bc = blk / H;
  const int bi = bc / nc, t0 = (bc % nc) * Q, g = h / (H / G);
  const long long row0 = (long long)bi * L + t0;

  // every load first: x and B into registers, and warp 0's dt
  float vx[8][2], vb[8][KB];
  load_tile(x + (row0 * H + h) * P, (long long)H * P, Q, P, vx);
  load_tile(b + (row0 * G + g) * N + n0, (long long)G * N, Q, N - n0, vb);
  if (warp == 0) {
    // cum_j = the running sum of the rounded dt_i a, i <= j, in order:
    // every lane keeps the same sum, lanes j and j - 32 take cum_j
    const float ah = a[h];
    const float d0 = lane < Q ? dt[(row0 + lane) * H + h] : 0.f;
    const float d1 = lane + 32 < Q ? dt[(row0 + lane + 32) * H + h] : 0.f;
    float run = 0.f, c0 = 0.f, c1 = 0.f;
#pragma unroll
    for (int j = 0; j < SSD_QM; ++j) {
      const float dj = __shfl_sync(0xffffffffu, j < 32 ? d0 : d1, j & 31);
      if (j < Q) run = __fadd_rn(run, __fmul_rn(dj, ah));
      if (j == lane) c0 = run;
      if (j == lane + 32) c1 = run;
    }
    float* dst = n0 == 0 ? cum + (long long)blk * Q : nullptr;
    if (lane == 0) *s_decay = expf(run);
    if (lane < Q) {
      if (dst) dst[lane] = c0;
      s_w[lane] = expf(run - c0) * d0;
    }
    if (lane + 32 < Q) {
      if (dst) dst[lane + 32] = c1;
      s_w[lane + 32] = expf(run - c1) * d1;
    }
  }
  for_tile<8, KB>([&](int rr, int kk, int r, int k) {
    s_b[r * LDB + k] = vb[rr][kk];
  });
  __syncthreads();
  for_tile<8, 2>([&](int rr, int kk, int r, int k) {
    s_x[r * SSD_LDP + k] = vx[rr][kk] * (r < Q ? s_w[r] : 0.f);
  });
  __syncthreads();

  // a warp: 4 p-groups of TP x 8 n-groups of 4; kWide: 2 x 4 warps over
  // 8 x 32 groups, else 4 x 2 warps over 16 x 16
  const int tp = (warp >> (kWide ? 2 : 1)) * 4 + (lane >> 3);
  const int tn = (warp & (kWide ? 3 : 1)) * 8 + (lane & 7);
  float acc[TP][4] = {};
#pragma unroll 4
  for (int j = 0; j < Q; ++j) {
    const float* xr = s_x + j * SSD_LDP + TP * tp;
    const float4 bv = *reinterpret_cast<const float4*>(s_b + j * LDB + 4 * tn);
#pragma unroll
    for (int q = 0; q < TP / 4; ++q) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * q);
      fma4(acc[4 * q], xv.x, bv);
      fma4(acc[4 * q + 1], xv.y, bv);
      fma4(acc[4 * q + 2], xv.z, bv);
      fma4(acc[4 * q + 3], xv.w, bv);
    }
  }

  // S_c, or for a scan of one chunk h_final = exp(cum_last) h0 + S_0
  const bool one = nc == 1;
  float* out = one ? hf + ((long long)bi * H + h) * P * N
                   : st + (long long)blk * P * N;
  const float* hin = one && h0 ? h0 + ((long long)bi * H + h) * P * N
                               : nullptr;
  const float decay = *s_decay;
  const int n = n0 + 4 * tn;
  const bool full = n + 3 < N && (N & 3) == 0;
#pragma unroll
  for (int u = 0; u < TP; ++u) {
    const int p = TP * tp + u;
    if (p >= P) break;
    if (hin)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (n + v < N) acc[u][v] = decay * hin[p * N + n + v] + acc[u][v];
    float* o = out + (long long)p * N + n;
    if (full) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (n + v < N) o[v] = acc[u][v];
    }
  }
}

// Blocks [0, B nc G) compute C B^T, the blocks after them the chunk
// states, halves (ssd_state_halves) of them a (b, c, h) (the C B^T
// blocks first, so that they start first).
template <typename T>
__global__ void __launch_bounds__(SSD_THREADS, 3)
ssd_chunk_kernel(const T* x, const float* dt, const float* a, const T* b,
                 const T* c, const float* h0, float* cbT, float* cum,
                 float* st, float* hf, int B, int L, int H, int P, int G,
                 int N, int Q, int halves) {
  extern __shared__ float smem[];
  const int ncb = B * (L / Q) * G, blk = blockIdx.x;
  if (blk < ncb)
    cb_block<T>(b, c, cbT, smem, blk, L, G, N, Q);
  else if (halves == 1 && N > 64)
    state_block<T, true>(x, dt, a, b, h0, cum, st, hf, smem, blk - ncb, L,
                         H, P, G, N, Q, halves);
  else
    state_block<T, false>(x, dt, a, b, h0, cum, st, hf, smem, blk - ncb, L,
                          H, P, G, N, Q, halves);
}

// Blocks of ssd_chunk_kernel (also used by the emulation harness).
extern "C" int ssd_chunk_blocks(int B, int L, int H, int G, int Q,
                                int halves) {
  return B * (L / Q) * (G + H * halves);
}

// ---- 2. the serial pass over chunks, a thread per state element(s) ------

// st (B, nc, H, P, N): S_c in, the state entering chunk c out (chunk 0's
// is h0, read from there); h0 and hf (B, H, P, N) f32 (h0 may be null).
// Not launched for a scan of one chunk (the state kernel writes hf).  A
// thread takes V consecutive elements (V = 4 when P N is a multiple of
// 4) and loads a batch of chunks' S and decays before it walks them.
constexpr int kPassBatch = 8;

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

template <int V>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_pass_kernel(const float* cum, const float* h0, float* st, float* hf,
                int B, int nc, int H, int PN, int Q) {
  const long long idx =
      ((long long)blockIdx.x * SSD_THREADS + threadIdx.x) * V;
  if (idx >= (long long)B * H * PN) return;
  const int e = (int)(idx % PN);
  const long long bh = idx / PN;
  const int h = (int)(bh % H), bi = (int)(bh / H);
  float hc[V];
  if (h0)
    load_v<V>(h0 + idx, hc);
  else
    for (int v = 0; v < V; ++v) hc[v] = 0.f;
  const long long cs = (long long)H * PN;  // one chunk's stride in st
  float* at = st + ((long long)bi * nc * H + h) * PN + e;
  const float* last = cum + ((long long)bi * nc * H + h) * Q + Q - 1;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float s[kPassBatch][V], d[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u)
      if (c0 + u < nc) {
        load_v<V>(at + (c0 + u) * cs, s[u]);
        d[u] = last[(long long)(c0 + u) * H * Q];
      }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u)
      if (c0 + u < nc) {
        if (c0 + u > 0) store_v<V>(at + (c0 + u) * cs, hc);
        const float decay = expf(d[u]);
#pragma unroll
        for (int v = 0; v < V; ++v) hc[v] = decay * hc[v] + s[u][v];
      }
  }
  store_v<V>(hf + idx, hc);
}

// ---- 3. y per (b, chunk, head) ---------------------------------------------

// y (B, L, H, P) f32.  h0 (B, H, P, N) f32 or null: h_{-1} (with none
// the inter-chunk half of chunk 0 is 0 and skipped).  As the plain
// version: y = W x + exp(cum) (C h_{c-1}^T), each product summed in
// order: two groups of 8 warps, the first over W x, the second over
// C h^T, whose sums join the first's through shared memory.
#define SCAN_THREADS 512

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS, 2)
ssd_scan_kernel(const T* x, const float* dt, const T* c, const float* cbT,
                const float* cum, const float* st, const float* h0, float* y,
                int L, int H, int P, int G, int N, int Q) {
  extern __shared__ float smem[];
  // rows k < Q: W^T (a) and x (m); rows SSD_QM + n: C^T and h_{c-1}^T
  float* s_a = smem;                               // (QM + NM) x LDQ
  float* s_m = s_a + (SSD_QM + SSD_NM) * SSD_LDQ;  // (QM + NM) x LDP
  float* s_cum = s_m + (SSD_QM + SSD_NM) * SSD_LDP;
  float* s_dt = s_cum + SSD_QM;
  float* s_e = s_dt + SSD_QM;  // exp(cum_i)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = L / Q;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int ci = bc % nc, bi = bc / nc, t0 = ci * Q, g = h / (H / G);
  const long long row0 = (long long)bi * L + t0;
  const bool inter = h0 != nullptr || ci > 0;
  const float* cm = cum + (long long)blockIdx.x * Q;
  constexpr int NW = SCAN_THREADS / 32;

  // the float32 scratch by cp.async: cbT rows as they lie, h_{c-1}
  // transposed (rows p of the state become columns)
  const float* cb = cbT + ((long long)bc * G + g) * Q * Q;
  for_tile<4, 2, NW>([&](int, int, int j, int i) {
    if (j < Q && i < Q)
      __pipeline_memcpy_async(s_a + j * SSD_LDQ + i, cb + j * Q + i, 4);
  });
  if (inter) {
    // the state entering the chunk: h0 for chunk 0, else the pass's
    const float* hin = ci == 0 ? h0 + ((long long)bi * H + h) * P * N
                               : st + (long long)blockIdx.x * P * N;
    for_tile<4, 4, NW>([&](int, int, int p, int n) {
      if (p < P && n < N)
        __pipeline_memcpy_async(s_m + (SSD_QM + n) * SSD_LDP + p,
                                hin + p * N + n, 4);
    });
  }
  __pipeline_commit();
  // the inputs into registers, then widened into shared memory
  {
    float vx[4][2];
    load_tile<4, 2, NW>(x + (row0 * H + h) * P, (long long)H * P, Q, P, vx);
    if (tid < SSD_QM) {
      const float cv = tid < Q ? cm[tid] : 0.f;
      s_cum[tid] = cv;
      s_dt[tid] = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
      s_e[tid] = expf(cv);
    }
    for_tile<4, 2, NW>([&](int rr, int kk, int j, int p) {
      s_m[j * SSD_LDP + p] = vx[rr][kk];
    });
  }
  if (inter) {
    float vc[4][4];
    load_tile<4, 4, NW>(c + (row0 * G + g) * N, (long long)G * N, Q, N, vc);
    for_tile<4, 4, NW>([&](int rr, int kk, int i, int n) {
      s_a[(SSD_QM + n) * SSD_LDQ + i] = vc[rr][kk];
    });
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  // W in place over C B^T, every operand read before any exp (no branch:
  // rows and columns past Q hold values that no kept output reads)
  {
    float v[4][2], cj[4], dj[4], ci[2];
    for_tile<4, 2, NW>([&](int rr, int kk, int j, int i) {
      v[rr][kk] = s_a[j * SSD_LDQ + i];
    });
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      cj[rr] = s_cum[warp + NW * rr];
      dj[rr] = s_dt[warp + NW * rr];
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) ci[kk] = s_cum[lane + 32 * kk];
    for_tile<4, 2, NW>([&](int rr, int kk, int j, int i) {
      const float w = v[rr][kk] * expf(ci[kk] - cj[rr]) * dj[rr];
      s_a[j * SSD_LDQ + i] = j <= i ? w : 0.f;
    });
  }
  __syncthreads();

  // warp (of its group): 4 i-groups of 4 (rows 16 (w / 2) ..+15) x 8
  // p-groups of 4; group 0: W x over the warp's W depth (cut at its last
  // row: W is lower triangular); group 1: C h^T over N
  const int grp = warp >> 3, w = warp & 7;
  const int ti = (w >> 1) * 4 + (lane >> 3);
  const int tp = (w & 1) * 8 + (lane & 7);
  float acc[4][4] = {};
  auto step = [&](int k) {
    const float4 av = *reinterpret_cast<const float4*>(
        s_a + k * SSD_LDQ + 4 * ti);
    const float4 mv = *reinterpret_cast<const float4*>(
        s_m + k * SSD_LDP + 4 * tp);
    fma4(acc[0], av.x, mv);
    fma4(acc[1], av.y, mv);
    fma4(acc[2], av.z, mv);
    fma4(acc[3], av.w, mv);
  };
  if (grp == 0) {
    const int jmax = min(Q, 16 * ((w >> 1) + 1));
#pragma unroll 4
    for (int k = 0; k < jmax; ++k) step(k);
  } else if (inter) {
#pragma unroll 4
    for (int n = 0; n < N; ++n) step(SSD_QM + n);
  }
  __syncthreads();  // every read of s_m done: its rows 0.. take C h^T
  float* s_red = s_m;  // 16 x 256: sum e of thread t at e * 256 + t
  const int t = tid & 255;
  if (grp && inter)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) s_red[(u * 4 + v) * 256 + t] = acc[u][v];
  __syncthreads();
  if (grp) return;
  const bool full = 4 * tp + 3 < P && (P & 3) == 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = 4 * ti + u;
    if (i >= Q) break;
    if (inter)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc[u][v] += s_e[i] * s_red[(u * 4 + v) * 256 + t];
    float* o = y + ((row0 + i) * H + h) * P + 4 * tp;
    if (full) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (4 * tp + v < P) o[v] = acc[u][v];
    }
  }
}

// ---- launch geometry (also used by the emulation harness) -------------

// dynamic shared memory of each launch (1: the larger of its two kinds
// of block, C B^T in bf16 or float32; 3: the output kernel)
extern "C" size_t ssd_scan_smem_bytes(int step, int bf16) {
  const size_t state =
      (SSD_QM * SSD_LDP + SSD_QM * (SSD_NM + 4) + SSD_QM + 4) * 4;
  const size_t cb = bf16 ? 2 * SSD_QM * SSD_LDH * 2 + SSD_QM * SSD_LDQ * 4
                         : 2 * SSD_QM * (SSD_NM + 1) * 4;
  switch (step) {
    case 1:
      return cb > state ? cb : state;
    case 3:
      return ((SSD_QM + SSD_NM) * (SSD_LDQ + SSD_LDP) + 3 * SSD_QM) * 4;
    default:
      return 0;
  }
}

// float32 scratch of one call: cbT (B, nc, G, Q, Q), cum (B, nc, H, Q),
// the chunk states (B, nc, H, P, N), each from a multiple of 4 floats
static size_t round4(size_t v) { return (v + 3) & ~(size_t)3; }

static void ssd_workspace(int B, int L, int H, int P, int G, int N, int Q,
                          size_t* cum, size_t* st, size_t* total) {
  const size_t bnc = (size_t)B * (L / Q);
  *cum = round4(bnc * G * Q * Q);
  *st = *cum + round4(bnc * H * Q);
  *total = *st + bnc * H * P * N;
}

extern "C" size_t ssd_scan_workspace_floats(int B, int L, int H, int P,
                                            int G, int N, int Q) {
  size_t cum, st, total;
  ssd_workspace(B, L, H, P, G, N, Q, &cum, &st, &total);
  return total;
}

// ---- host launchers (plain C interface, loaded with ctypes) -------------

template <typename T>
static int launch(const void* x, const float* dt, const float* a,
                  const void* b, const void* c, const float* h0, float* y,
                  float* hf, float* ws, int B, int L, int H, int P, int G,
                  int N, int Q, cudaStream_t stream) {
  const int nc = L / Q, bf16 = std::is_same<T, __nv_bfloat16>::value;
  size_t o_cum, o_st, total;
  ssd_workspace(B, L, H, P, G, N, Q, &o_cum, &o_st, &total);
  float* cbT = ws;
  float* cum = ws + o_cum;
  float* st = ws + o_st;
  // each kernel's shared memory, set once per instance and card
  static unsigned long long sized = 0;  // bit d: card d done
  int dev, sms, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= 64 || !(sized >> dev & 1ull)) {
    const void* fns[2] = {(const void*)ssd_chunk_kernel<T>,
                          (const void*)ssd_scan_kernel<T>};
    const int smem[2] = {(int)ssd_scan_smem_bytes(1, bf16),
                         (int)ssd_scan_smem_bytes(3, bf16)};
    for (int k = 0; k < 2 && !err; ++k)
      err = (int)cudaFuncSetAttribute(
          fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[k]);
    if (err) return err;
    if (dev < 64) sized |= 1ull << dev;
  }
  const long long elems = (long long)B * H * P * N;
  if (elems == 0) return 0;
  if (nc > 0) {
    if ((err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    const int halves = ssd_state_halves(B, L, H, N, Q, sms);
    ssd_chunk_kernel<T><<<ssd_chunk_blocks(B, L, H, G, Q, halves),
                          SSD_THREADS, ssd_scan_smem_bytes(1, bf16),
                          stream>>>((const T*)x, dt, a, (const T*)b,
                                    (const T*)c, h0, cbT, cum, st, hf, B, L,
                                    H, P, G, N, Q, halves);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (nc == 1) {
    // the state kernel wrote h_final
  } else if ((P * N) % 4 == 0) {
    const long long th = elems / 4;
    ssd_pass_kernel<4><<<(unsigned)((th + SSD_THREADS - 1) / SSD_THREADS),
                         SSD_THREADS, 0, stream>>>(cum, h0, st, hf, B, nc, H,
                                                   P * N, Q);
  } else {
    ssd_pass_kernel<1><<<(unsigned)((elems + SSD_THREADS - 1) / SSD_THREADS),
                         SSD_THREADS, 0, stream>>>(cum, h0, st, hf, B, nc, H,
                                                   P * N, Q);
  }
  if ((err = (int)cudaGetLastError()) || nc == 0) return err;
  ssd_scan_kernel<T><<<B * nc * H, SCAN_THREADS,
                       ssd_scan_smem_bytes(3, bf16), stream>>>(
      (const T*)x, dt, (const T*)c, cbT, cum, st, h0, y, L, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

extern "C" int ssd_scan_launch(int bf16, const void* x, const float* dt,
                               const float* a, const void* b, const void* c,
                               const float* h0, float* y, float* hf,
                               float* ws, int B, int L, int H, int P, int G,
                               int N, int Q, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, dt, a, b, c, h0, y, hf, ws, B, L, H,
                                      P, G, N, Q, s)
              : launch<float>(x, dt, a, b, c, h0, y, hf, ws, B, L, H, P, G,
                              N, Q, s);
}
