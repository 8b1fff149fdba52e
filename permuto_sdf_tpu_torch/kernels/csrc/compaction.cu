// Kernel H0: order-preserving stream compaction of a boolean mask.
//
// Replaces: `jnp.nonzero(mask, size=size, fill_value=len(mask))`, which the
// JAX package calls at permuto_sdf_tpu/ops/sphere_trace.py:328 and :425 and
// permuto_sdf_tpu/train/train_permuto_sdf.py:436 (`_compact_idx`) and :1699
// (`_shade_hits_compact`); XLA lowers it to a cumulative sum and a scatter.
// Out: idx [size] int64, the first `size` true positions in ascending order
// with len(mask) in the unused slots, and the number of true entries.
//
// What bounds it on an H100: bytes. It reads the n-byte mask twice (once
// per pass; the second read mostly hits L2) and writes 8 bytes per output
// slot; the arithmetic is a few integer adds per element.
//
// Design: tiles of 2048 elements (256 threads x 8 consecutive elements).
// Pass 1 counts the true entries of each tile. Pass 2 runs one block per
// tile: the block sums the counts of the tiles before its own (its offset)
// and of all tiles (the total) with a block reduction, scans its threads'
// counts (a warp scan, then the warp totals), and writes the positions of
// its true entries that fall below `size`, in order. Slots [total, size)
// get the fill value, spread over all threads of the grid. No atomics, so
// the result is the same on every run; no host synchronisation.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int thread_count(int n, const uint8_t* __restrict__ mask,
                                            long long base, unsigned* bits) {
  int c = 0;
  unsigned b = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k;
    if (i < n && mask[i] != 0) {
      ++c;
      b |= 1u << k;
    }
  }
  *bits = b;
  return c;
}

// Sum of v over the block; `red` holds kWarps ints of shared memory.
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(PSDF_FULL_MASK, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads) compact_count_kernel(
    int n, const uint8_t* __restrict__ mask, int* __restrict__ tile_counts) {
  int* red = psdf_dynamic_smem<int>();
  unsigned bits;
  const long long base = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kPerThread;
  const int total = block_sum(thread_count(n, mask, base, &bits), red);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads) compact_write_kernel(
    int n, const uint8_t* __restrict__ mask, const int* __restrict__ tile_counts,
    int nr_tiles, int size, long long fill, long long* __restrict__ idx,
    int* __restrict__ count) {
  int* smem = psdf_dynamic_smem<int>();
  int* red_before = smem;
  int* red_all = smem + kWarps;
  int* warp_tot = smem + 2 * kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int before = 0, all = 0;
  for (int b = threadIdx.x; b < nr_tiles; b += kThreads) {
    const int v = tile_counts[b];
    all += v;
    if (b < (int)blockIdx.x) before += v;
  }
  before = block_sum(before, red_before);
  all = block_sum(all, red_all);

  unsigned bits = 0;
  const long long base = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kPerThread;
  const int c = blockIdx.x < (unsigned)nr_tiles ? thread_count(n, mask, base, &bits) : 0;
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int offset = before + incl - c;
  for (int w = 0; w < warp; ++w) offset += warp_tot[w];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (bits & (1u << k)) {
      if (offset < size) idx[offset] = base + k;
      ++offset;
    }
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long s = (long long)all + (long long)blockIdx.x * kThreads + threadIdx.x; s < size;
       s += stride)
    idx[s] = fill;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = all;
}

}  // namespace

// mask [n] bool -> idx [size] int64, count [1] int32; tile_counts: scratch
// of max(1, ceil(n / 2048)) ints.
extern "C" int psdf_compact(int n, const void* mask, int size, long long fill,
                            void* tile_counts, void* idx, void* count, void* stream) {
  if (n < 0 || size < 0) return (int)cudaErrorInvalidValue;
  const int nr_tiles = psdf_blocks(n, kTile);
  if (nr_tiles > 0) {
    PSDF_LAUNCH(compact_count_kernel, nr_tiles, kThreads, kWarps * sizeof(int), stream, n,
                (const uint8_t*)mask, (int*)tile_counts);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  PSDF_LAUNCH(compact_write_kernel, nr_tiles > 0 ? nr_tiles : 1, kThreads,
              3 * kWarps * sizeof(int), stream, n, (const uint8_t*)mask,
              (const int*)tile_counts, nr_tiles, size, fill, (long long*)idx, (int*)count);
  return (int)cudaGetLastError();
}
