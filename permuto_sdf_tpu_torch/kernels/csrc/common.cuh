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

// Copies nbytes from src to dst with the calling warp's lanes, in 16-, 4-
// or 1-byte units: the widest that both addresses and nbytes allow (a row
// stored from shared memory in whole vectors).
__device__ __forceinline__ void psdf_warp_copy(void* dst, const void* src, int nbytes) {
  const int lane = threadIdx.x & 31;
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)nbytes;
  if ((a & 15) == 0) {
    for (int i = lane; i < nbytes / 16; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if ((a & 3) == 0) {
    for (int i = lane; i < nbytes / 4; i += 32)
      reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
  } else {
    for (int i = lane; i < nbytes; i += 32)
      reinterpret_cast<uint8_t*>(dst)[i] = reinterpret_cast<const uint8_t*>(src)[i];
  }
}

// Asynchronous copies from global to shared memory (cp.async, sm_80+):
// every copy a warp starts is in flight at once, and psdf_stage_wait()
// waits for all of them. The CPU emulation of the tests defines its own,
// synchronous ones.
#ifndef PSDF_CP_ASYNC
__device__ __forceinline__ void psdf_cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void psdf_cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void psdf_cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}
#endif

// The tensor cores' TF32 product (mma.sync m16n8k8, sm_80+) for one warp:
// d += a b, A 16 x 8 (row-major), B 8 x 8 (column-major), float32
// accumulate, in the PTX fragment layout (g = lane / 4, t = lane % 4):
// a = {A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]}, b = {B[t][g],
// B[t + 4][g]}, d = {D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]};
// a and b are TF32 bit patterns (psdf_tf32: float32 rounded to nearest,
// ties away, to 10 mantissa bits). The CPU emulation of the tests defines
// its own.
#ifndef PSDF_MMA
__device__ __forceinline__ uint32_t psdf_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void psdf_mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// Stages nbytes from global memory src into shared memory dst with the
// calling warp's lanes: asynchronous 16- or 4-byte copies where both
// addresses and nbytes allow, else plain byte copies. Start every row of
// a ray this way, then psdf_stage_wait() once: the rows' loads overlap.
__device__ __forceinline__ void psdf_warp_stage(void* dst, const void* src, int nbytes) {
  const int lane = threadIdx.x & 31;
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)nbytes;
  if ((a & 15) == 0) {
    for (int i = lane; i < nbytes / 16; i += 32)
      psdf_cp_async16(static_cast<uint8_t*>(dst) + 16 * i,
                      static_cast<const uint8_t*>(src) + 16 * i);
  } else if ((a & 3) == 0) {
    for (int i = lane; i < nbytes / 4; i += 32)
      psdf_cp_async4(static_cast<uint8_t*>(dst) + 4 * i,
                     static_cast<const uint8_t*>(src) + 4 * i);
  } else {
    for (int i = lane; i < nbytes; i += 32)
      static_cast<uint8_t*>(dst)[i] = static_cast<const uint8_t*>(src)[i];
  }
}

// Waits for the calling warp's staged rows and makes them visible to all
// its lanes.
__device__ __forceinline__ void psdf_stage_wait() {
  psdf_cp_async_wait();
  __syncwarp();
}

// n floats (or n bytes) rounded up to 16 bytes, so that shared-memory
// slices laid out one after another all start 16-byte aligned.
__host__ __device__ __forceinline__ int psdf_pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int psdf_pad16(int n) { return (n + 15) & ~15; }

static inline int psdf_blocks(long long work, int per_block) {
  return (int)((work + per_block - 1) / per_block);
}

extern "C" const char* psdf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
