// Host stand-in for <cuda_runtime.h>: the kernel sources under
// src/repro_torch/csrc need only the stream type and the 16-byte vector
// types (and make_float4) outside their host launchers, which the
// emulation strips.
#pragma once
typedef void* cudaStream_t;
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
