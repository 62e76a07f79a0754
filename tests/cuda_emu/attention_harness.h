// Plain C entry points around the emulated paged attention kernels
// (attention_emu.inc, included before this header).

// The two split kernels as (B * Hkv, splits) grids (the emulation runs a
// 1-D grid of B * Hkv * splits blocks and splits each block's index),
// then the merge kernel, through a workspace as the wrapper's.  TQ: q's
// type; T: the pages' (int8 pages read their scales ks, vs).
template <typename TQ, typename T, int VEC>
static void emu_attention(const void* q, const void* k, const void* v,
                          const float* ks, const float* vs,
                          const int* table, const int* seq_lens, float* out,
                          int B, int Hq, int Hkv, int D, int page, int P,
                          int NP, int wpp, int window, int ring,
                          float scale) {
  std::vector<float> ws(
      paged_attention_workspace_floats(B, Hq, Hkv, D, page, P) + 1, NAN);
  int pps, S;
  paged_attention_geometry(page, P, &pps, &S);
  const int G = Hq / Hkv;
  auto split = [&](int kernel, auto body) {
    emu_launch(B * Hkv * S, PA_THREADS,
               paged_attention_smem_bytes(G, D, page, P, sizeof(T), kernel),
               [&] {
                 blockIdx.y = blockIdx.x % S;
                 blockIdx.x /= S;
                 body();
               });
  };
  split(1, [&] {
    paged_attention_kernel<TQ, T, VEC>((const TQ*)q, (const T*)k, ks, table,
                                       seq_lens, ws.data(), B, Hq, Hkv, D,
                                       page, P, NP, wpp, window, ring, scale);
  });
  split(2, [&] {
    paged_attention_values_kernel<T, VEC>((const T*)v, vs, table, seq_lens,
                                          ws.data(), B, Hq, Hkv, D, page, P,
                                          NP, wpp, window, ring);
  });
  emu_launch(B * Hkv, pa_merge_threads(G, D), P * sizeof(int), [&] {
    paged_attention_merge_kernel(table, seq_lens, ws.data(), out, B, Hq,
                                 Hkv, D, page, P, NP, wpp, window, ring);
  });
}

// vec: 16-byte row chunks (the launcher's choice when a row's bytes are
// a multiple of 16), else one element at a time; window 0: none, ring 1:
// the table is a ring
extern "C" void emu_paged_attention_window(
    int bf16, int vec, const void* q, const void* k, const void* v,
    const int* table, const int* seq_lens, float* out, int B, int Hq,
    int Hkv, int D, int page, int P, int NP, int wpp, int window, int ring,
    float scale) {
  using b16 = __nv_bfloat16;
  auto fn = bf16 ? (vec ? emu_attention<b16, b16, 8>
                        : emu_attention<b16, b16, 1>)
                 : (vec ? emu_attention<float, float, 4>
                        : emu_attention<float, float, 1>);
  fn(q, k, v, nullptr, nullptr, table, seq_lens, out, B, Hq, Hkv, D, page,
     P, NP, wpp, window, ring, scale);
}

// no window, page tables as they are
extern "C" void emu_paged_attention(int bf16, int vec, const void* q,
                                    const void* k, const void* v,
                                    const int* table, const int* seq_lens,
                                    float* out, int B, int Hq, int Hkv,
                                    int D, int page, int P, int NP, int wpp,
                                    float scale) {
  emu_paged_attention_window(bf16, vec, q, k, v, table, seq_lens, out, B, Hq,
                             Hkv, D, page, P, NP, wpp, 0, 0, scale);
}

// int8 pages with their float32 scales (NP, page, Hkv); q in bf16
// (q_bf16) or float32; vec as above (16 int8 elements a chunk)
extern "C" void emu_paged_attention_int8(
    int q_bf16, int vec, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* table, const int* seq_lens,
    float* out, int B, int Hq, int Hkv, int D, int page, int P, int NP,
    int wpp, int window, int ring, float scale) {
  using b16 = __nv_bfloat16;
  auto fn = q_bf16 ? (vec ? emu_attention<b16, int8_t, 16>
                          : emu_attention<b16, int8_t, 1>)
                   : (vec ? emu_attention<float, int8_t, 16>
                          : emu_attention<float, int8_t, 1>);
  fn(q, k, v, ks, vs, table, seq_lens, out, B, Hq, Hkv, D, page, P, NP, wpp,
     window, ring, scale);
}
