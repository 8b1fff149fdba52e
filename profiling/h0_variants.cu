// Kernel H0 (compaction.cu) as one launch of a thread-block cluster: the
// design measured against the port's two launches and not kept (PERF.md
// §6, PR 17: the cluster's launch, barrier and count exchange cost more
// than the second launch they save), for measurement only: no path of the
// port calls it. Built and timed by profiling/h0_designs.py, and run on the
// CPU by tests/test_torch_kernel_sources.py against the plain version.
//
// The form: one cluster walks the mask in passes. In a pass each thread
// loads its VECS consecutive 16-byte vectors of the mask (and of the
// second mask), tests each byte for nonzero and combines the two, so it
// holds a bit per element; the block scans its threads' bit counts (a warp
// scan, then the warp totals), writes its true positions in order into
// shared memory and publishes its total there; after one cluster barrier
// every warp reads the totals of the cluster's blocks through distributed
// shared memory, which gives the block's offset in the output, and the
// block stores its positions below `size` in whole, coalesced rows. A
// running offset carries from pass to pass, the next pass's loads are in
// flight during a pass, and the second half of the barrier that frees the
// totals (arrive after the reads, wait before the next barrier or the exit)
// overlaps the stores. Then the slots [count, size) take the fill value.
//
// psdf_compact_shape launches it with `threads` threads a block (256, 512
// or 1024; 32 for the CPU test), `vecs` 16-byte vectors a thread a pass (1
// or 2) and `cluster` blocks (up to 16), at any n. psdf_compact_probe times
// its stages.
#include "compaction.cu"

// Thread-block clusters (sm_90): a launch of clusters of `cluster` blocks
// along x, the block's rank in its cluster, the cluster's size, a barrier
// of all the cluster's threads (barrier.cluster, whole or in its arrive and
// wait halves), and a pointer into another block's shared memory
// (distributed shared memory: p is an address in the caller's own shared
// memory; the result is the same offset in block `rank`'s). The CPU
// emulation of the tests
// (tests/cuda_cpu_emulation/cuda_runtime.h) defines its own under the same
// names, which run a cluster's blocks together.
#ifndef PSDF_CLUSTER
#include <cooperative_groups.h>

__device__ __forceinline__ unsigned psdf_cluster_rank() {
  return cooperative_groups::this_cluster().block_rank();
}
__device__ __forceinline__ unsigned psdf_cluster_blocks() {
  return cooperative_groups::this_cluster().num_blocks();
}
// The cluster barrier in two halves: arrive (release: this thread's
// earlier memory operations, remote reads included, are done for the
// others) and wait (acquire) for the other threads' arrivals. A thread
// alternates them; work between the two overlaps the barrier.
__device__ __forceinline__ void psdf_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void psdf_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void psdf_cluster_sync() {
  psdf_cluster_arrive();
  psdf_cluster_wait();
}
template <typename T>
__device__ __forceinline__ T* psdf_cluster_map(T* p, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// More than 8 blocks a cluster is the H100's non-portable size: the kernel
// opts in first.
template <typename... Params, typename... Args>
static inline int psdf_launch_cluster(void (*kernel)(Params...), int grid, int block,
                                      int cluster, size_t smem, void* stream, Args... args) {
  if (cluster > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}
#define PSDF_LAUNCH_CLUSTER(kernel, grid, block, cluster, smem, stream, ...) \
  psdf_launch_cluster(kernel, (grid), (block), (cluster), (smem), (stream), __VA_ARGS__)
#endif


namespace {

__device__ __forceinline__ unsigned vec_bits(uint4 a, uint4 b, int mode) {
  return word_bits(a.x, b.x, mode) | word_bits(a.y, b.y, mode) << 4 |
         word_bits(a.z, b.z, mode) << 8 | word_bits(a.w, b.w, mode) << 12;
}

// Elements [base, base + 16 VECS) of the combined mask as bits (element
// base + k at bit k; 0 past n): 16-byte loads where both masks are
// 16-byte aligned and the run lies inside the mask, else bytes.
template <int VECS>
__device__ __forceinline__ unsigned load_bits(const uint8_t* __restrict__ a,
                                              const uint8_t* __restrict__ b, int mode,
                                              long long base, long long n, bool vec) {
  unsigned bits = 0;
  if (vec && base + 16 * VECS <= n) {
    uint4 va[VECS], vb[VECS];
#pragma unroll
    for (int v = 0; v < VECS; ++v) {
      va[v] = reinterpret_cast<const uint4*>(a + base)[v];
      vb[v] = mode == kMaskOnly ? va[v] : reinterpret_cast<const uint4*>(b + base)[v];
    }
#pragma unroll
    for (int v = 0; v < VECS; ++v) bits |= vec_bits(va[v], vb[v], mode) << (16 * v);
  } else {
    for (int k = 0; k < 16 * VECS && base + k < n; ++k)
      bits |= (unsigned)combined_at(a, b, mode, base + k) << k;
  }
  return bits;
}

// Exclusive prefix and total over the warp's lanes of v.
__device__ __forceinline__ int warp_excl_scan(int v, int lane, int& total) {
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  total = __shfl_sync(PSDF_FULL_MASK, incl, 31);
  return incl - v;
}

// The one-launch form's shared memory, in ints: the warps' totals and the
// block's total, two copies each (by the pass's parity, so a block that
// runs ahead into the next pass never overwrites what a slower warp or
// block still reads), then the block's positions in the pass.
template <int THREADS, int VECS>
__host__ __device__ constexpr int cluster_smem_ints() {
  return ((2 * (THREADS / 32) + 2 + 3) & ~3) + THREADS * 16 * VECS;
}

// The one-launch form: THREADS threads a block, VECS 16-byte vectors a
// thread a pass, the cluster's blocks as launched.
template <int THREADS, int VECS>
__global__ void __launch_bounds__(THREADS) compact_cluster_kernel(
    long long n, const uint8_t* __restrict__ mask, const uint8_t* __restrict__ other, int mode,
    int size, long long fill, long long* __restrict__ idx, int* __restrict__ count) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kPerThread = 16 * VECS;
  int* warp_tot = psdf_dynamic_smem<int>();  // [2][kWarps]
  int* block_tot = warp_tot + 2 * kWarps;    // [2]
  int* pos = warp_tot + ((2 * kWarps + 2 + 3) & ~3);  // [THREADS * kPerThread]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned rank = psdf_cluster_rank();
  const unsigned blocks = psdf_cluster_blocks();
  const long long pass_len = (long long)blocks * THREADS * kPerThread;
  // this thread's first element in a pass, from the pass's start
  const int first = ((int)rank * THREADS + threadIdx.x) * kPerThread;
  const bool vec = (((uintptr_t)mask | (uintptr_t)(mode == kMaskOnly ? mask : other)) & 15) == 0;

  long long running = 0;  // true entries in the passes before
  unsigned bits = first < n ? load_bits<VECS>(mask, other, mode, first, n, vec) : 0u;
  int parity = 0;
#pragma unroll 1
  for (long long pass = 0; pass < n; pass += pass_len) {
    const long long next = pass + pass_len + first;
    const unsigned next_bits = next < n ? load_bits<VECS>(mask, other, mode, next, n, vec) : 0u;
    int wsum;
    const int in_warp = warp_excl_scan(__popc(bits), lane, wsum);
    if (lane == 0) warp_tot[parity * kWarps + warp] = wsum;
    __syncthreads();
    int btot;
    const int wv = lane < kWarps ? warp_tot[parity * kWarps + lane] : 0;
    const int wex = warp_excl_scan(wv, lane, btot);
    int at = __shfl_sync(PSDF_FULL_MASK, wex, warp) + in_warp;
    for (unsigned b = bits; b != 0u; b &= b - 1u) pos[at++] = first + __ffs(b) - 1;
    if (threadIdx.x == 0) block_tot[parity] = btot;
    if (pass > 0) psdf_cluster_wait();  // the previous pass's totals are free
    psdf_cluster_sync();
    int ptot;
    const int rv = lane < (int)blocks ? *psdf_cluster_map(&block_tot[parity], lane) : 0;
    const int rex = warp_excl_scan(rv, lane, ptot);
    psdf_cluster_arrive();  // done with the other blocks' totals
    const long long out = running + __shfl_sync(PSDF_FULL_MASK, rex, rank);
    const int stop = (int)min((long long)btot, (long long)size - out);
    for (int j = threadIdx.x; j < stop; j += THREADS) idx[out + j] = pass + pos[j];
    running += ptot;
    bits = next_bits;
    parity ^= 1;
  }
  const long long stride = (long long)blocks * THREADS;
  for (long long s = running + (long long)rank * THREADS + threadIdx.x; s < size; s += stride)
    idx[s] = fill;
  if (rank == 0 && threadIdx.x == 0) *count = (int)running;
  if (n > 0) psdf_cluster_wait();  // no block leaves while another reads its totals
}

}  // namespace

// Kernel H0's one-launch form at a given shape: one cluster of `cluster`
// blocks of THREADS threads, VECS 16-byte vectors a thread a pass.
template <int THREADS, int VECS>
static int launch_compact_cluster(int cluster, int n, const void* mask, const void* other,
                                  int mode, int size, long long fill, void* idx, void* count,
                                  void* stream) {
  if (n < 0 || size < 0 || (mode != kMaskOnly && other == nullptr && n > 0))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(long long, const uint8_t*, const uint8_t*, int, int, long long, long long*,
                 int*) = compact_cluster_kernel<THREADS, VECS>;
  const size_t smem = cluster_smem_ints<THREADS, VECS>() * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // one cluster: the grid is the cluster's blocks
  return PSDF_LAUNCH_CLUSTER(kernel, cluster, THREADS, cluster, smem, stream, (long long)n,
                             (const uint8_t*)mask, (const uint8_t*)other, mode, size, fill,
                             (long long*)idx, (int*)count);
}

extern "C" int psdf_compact_shape(int threads, int vecs, int cluster, int n, const void* mask,
                                  const void* other, int mode, int size, long long fill,
                                  void* idx, void* count, void* stream) {
#define PSDF_H0_SHAPE(T, V)                                                              \
  if (threads == T && vecs == V)                                                         \
    return launch_compact_cluster<T, V>(cluster, n, mask, other, mode, size, fill, idx, \
                                        count, stream);
  PSDF_H0_SHAPE(32, 1)
  PSDF_H0_SHAPE(256, 1)
  PSDF_H0_SHAPE(256, 2)
  PSDF_H0_SHAPE(512, 1)
  PSDF_H0_SHAPE(512, 2)
  PSDF_H0_SHAPE(1024, 1)
  PSDF_H0_SHAPE(1024, 2)
#undef PSDF_H0_SHAPE
  return (int)cudaErrorInvalidValue;
}

// A probe of the one-launch form's costs: the same pass as
// compact_cluster_kernel with its stages switched on by the bits of STAGES
// (1 the loads, 2 the block scan, 4 the positions into shared memory, 8 the
// cluster barriers and the other blocks' totals, 16 the coalesced stores,
// 32 the fills); a stage switched off is replaced by a constant, so only
// the launch with every bit set writes the right output. One pass of n
// <= blocks * THREADS * 16 elements. PLAIN launches the same blocks
// without a cluster (and without stage 8).
namespace probe {

template <int THREADS, int STAGES>
__global__ void __launch_bounds__(THREADS) stage_kernel(
    long long n, const uint8_t* __restrict__ mask, int size, long long fill,
    long long* __restrict__ idx, int* __restrict__ count, int cluster_blocks) {
  constexpr int kWarps = THREADS / 32;
  int* warp_tot = psdf_dynamic_smem<int>();
  int* block_tot = warp_tot + 2 * kWarps;
  int* pos = warp_tot + ((2 * kWarps + 2 + 3) & ~3);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned rank = (STAGES & 8) ? psdf_cluster_rank() : blockIdx.x;
  const unsigned blocks = (STAGES & 8) ? psdf_cluster_blocks() : (unsigned)cluster_blocks;
  const int first = ((int)rank * THREADS + threadIdx.x) * 16;
  unsigned bits = 0x11111111u;
  if (STAGES & 1) bits = first < n ? load_bits<1>(mask, mask, kMaskOnly, first, n, true) : 0u;
  int wsum = 0, in_warp = 0, btot = 0, at = 0;
  if (STAGES & 2) {
    in_warp = warp_excl_scan(__popc(bits), lane, wsum);
    if (lane == 0) warp_tot[warp] = wsum;
    __syncthreads();
    const int wv = lane < kWarps ? warp_tot[lane] : 0;
    const int wex = warp_excl_scan(wv, lane, btot);
    at = __shfl_sync(PSDF_FULL_MASK, wex, warp) + in_warp;
  } else {
    at = threadIdx.x * 8;
    btot = THREADS * 8;
  }
  if (STAGES & 4)
    for (unsigned b = bits; b != 0u; b &= b - 1u) pos[at++] = first + __ffs(b) - 1;
  if (threadIdx.x == 0) block_tot[0] = btot;
  long long out = (long long)rank * btot;
  int ptot = (int)blocks * btot;
  if (STAGES & 8) {
    psdf_cluster_sync();
    const int rv = lane < (int)blocks ? *psdf_cluster_map(&block_tot[0], lane) : 0;
    const int rex = warp_excl_scan(rv, lane, ptot);
    psdf_cluster_arrive();
    out = __shfl_sync(PSDF_FULL_MASK, rex, rank);
  } else if (STAGES & 4) {
    __syncthreads();
  }
  if (STAGES & 16) {
    const int stop = (int)min((long long)btot, (long long)size - out);
    for (int j = threadIdx.x; j < stop; j += THREADS) idx[out + j] = pos[j];
  }
  if (STAGES & 32) {
    const long long stride = (long long)blocks * THREADS;
    for (long long s = ptot + (long long)rank * THREADS + threadIdx.x; s < size; s += stride)
      idx[s] = fill;
  }
  if (rank == 0 && threadIdx.x == 0) *count = ptot;
  if (STAGES & 8) psdf_cluster_wait();
}

template <int STAGES>
int launch_stage(int cluster, int n, const void* mask, int size, long long fill, void* idx,
                 void* count, void* stream) {
  constexpr int T = 1024;
  void (*kernel)(long long, const uint8_t*, int, long long, long long*, int*, int) =
      stage_kernel<T, STAGES>;
  const size_t smem = cluster_smem_ints<T, 1>() * sizeof(int);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (STAGES & 8)
    return PSDF_LAUNCH_CLUSTER(kernel, cluster, T, cluster, smem, stream, (long long)n,
                               (const uint8_t*)mask, size, fill, (long long*)idx, (int*)count,
                               cluster);
  PSDF_LAUNCH(kernel, cluster, T, smem, stream, (long long)n, (const uint8_t*)mask, size, fill,
              (long long*)idx, (int*)count, cluster);
  return (int)cudaGetLastError();
}

}  // namespace probe

// The probe at 1024 threads a block and `cluster` blocks; stages as above.
extern "C" int psdf_compact_probe(int stages, int cluster, int n, const void* mask, int size,
                                  long long fill, void* idx, void* count, void* stream) {
  switch (stages) {
#define PSDF_H0_PROBE(S) \
  case S:                \
    return probe::launch_stage<S>(cluster, n, mask, size, fill, idx, count, stream);
    PSDF_H0_PROBE(0)
    PSDF_H0_PROBE(1)
    PSDF_H0_PROBE(3)
    PSDF_H0_PROBE(7)
    PSDF_H0_PROBE(8)
    PSDF_H0_PROBE(15)
    PSDF_H0_PROBE(31)
    PSDF_H0_PROBE(63)
    PSDF_H0_PROBE(55)
    PSDF_H0_PROBE(23)
#undef PSDF_H0_PROBE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
