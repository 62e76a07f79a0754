// Host stand-in for <mma.h>: nvcuda::wmma's 16x16x16 fragments.  Every
// emulated thread of the warp holds the whole tile and computes the
// whole product (the lanes agree); a load reads the tile from memory, and
// only lane 0 stores it (a kernel synchronises its block before another
// thread reads a stored tile).  Products sum in float32 in k order.
#pragma once
#include <cuda_bf16.h>

#include <type_traits>

namespace nvcuda {
namespace wmma {

struct row_major {};
struct col_major {};
struct matrix_a {};
struct matrix_b {};
struct accumulator {};
enum layout_t { mem_row_major, mem_col_major };

template <class Use, int M, int N, int K, class T, class Layout = void>
struct fragment {
  static_assert(M == 16 && N == 16 && K == 16, "16x16x16 tiles only");
  float v[256];  // element (r, c) at r * 16 + c, widened
};

inline float emu_widen(float v) { return v; }
inline float emu_widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class Use, class T, class Layout>
inline void load_matrix_sync(fragment<Use, 16, 16, 16, T, Layout>& f,
                             const T* p, unsigned ld) {
  // element (r, c) of the 16 x 16 operand
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c)
      f.v[r * 16 + c] = emu_widen(
          std::is_same<Layout, row_major>::value ? p[r * ld + c]
                                                 : p[c * ld + r]);
}

template <class T>
inline void fill_fragment(fragment<accumulator, 16, 16, 16, T>& f, float x) {
  for (float& e : f.v) e = x;
}

template <class TA, class LA, class TB, class LB>
inline void mma_sync(fragment<accumulator, 16, 16, 16, float>& d,
                     const fragment<matrix_a, 16, 16, 16, TA, LA>& a,
                     const fragment<matrix_b, 16, 16, 16, TB, LB>& b,
                     const fragment<accumulator, 16, 16, 16, float>& c) {
  float out[256];
  for (int r = 0; r < 16; ++r)
    for (int col = 0; col < 16; ++col) {
      float s = c.v[r * 16 + col];
      for (int k = 0; k < 16; ++k) s += a.v[r * 16 + k] * b.v[k * 16 + col];
      out[r * 16 + col] = s;
    }
  for (int e = 0; e < 256; ++e) d.v[e] = out[e];
}

inline void store_matrix_sync(
    float* p, const fragment<accumulator, 16, 16, 16, float>& f, unsigned ld,
    layout_t layout) {
  if (threadIdx.x % 32 != 0) return;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c)
      (layout == mem_row_major ? p[r * ld + c] : p[c * ld + r]) =
          f.v[r * 16 + c];
}

}  // namespace wmma
}  // namespace nvcuda
