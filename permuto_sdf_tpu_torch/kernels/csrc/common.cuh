// Shared helpers of the port's CUDA kernels (built for sm_90a with nvcc,
// bound to Python through a plain C interface and ctypes).
//
// Every exported entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() right after the launch so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Kernel launch, written as a macro so the launch sites stay one line.
#ifndef PSDF_LAUNCH
#define PSDF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

// Dynamic shared memory of the current block, typed.
#ifndef PSDF_DYNAMIC_SMEM
template <typename T>
__device__ __forceinline__ T* psdf_dynamic_smem() {
  extern __shared__ __align__(16) unsigned char psdf_smem_raw[];
  return reinterpret_cast<T*>(psdf_smem_raw);
}
#endif

#define PSDF_FULL_MASK 0xffffffffu

static inline int psdf_blocks(long long work, int per_block) {
  return (int)((work + per_block - 1) / per_block);
}

extern "C" const char* psdf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
