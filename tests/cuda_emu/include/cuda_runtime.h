// Host stand-in for <cuda_runtime.h>: the kernel sources under
// src/repro_torch/csrc need only the stream type outside their host
// launchers, which the emulation strips.
#pragma once
typedef void* cudaStream_t;
