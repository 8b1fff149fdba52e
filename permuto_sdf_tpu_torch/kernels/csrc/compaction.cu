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

// The arrays kernels H1 and H2 move (below), passed by value.
constexpr int kMaxArrays = 12;
struct RowArrays {
  const void* src[kMaxArrays];
  void* dst[kMaxArrays];
  long long row_bytes[kMaxArrays];
  unsigned fill[kMaxArrays];  // a 4-byte pattern (H2's fills; 0 for H1)
  int count;
};

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

// ---------------------------------------------------------------------------
// Kernels H1 (take) and H2 (scatter): whole rows of several per-ray arrays
// moved between a batch of n rays and a bucket of B of them, in one launch.
//
// Replaces: `_take_rays` and `_scatter_rays` of the hit-ray compaction,
// permuto_sdf_tpu/train/train_permuto_sdf.py:451 and :469 (with
// `_pad_one(t_exit)[ray_idx]` and `_pad_one(img_indices, 0)[ray_idx]`,
// :412 and :527), which XLA runs as one gather or scatter per array.
// H1: dst[b] = src[ray_idx[b]] for ray_idx[b] < n, else a row of zeros (the
// all-invalid pad row: mask false, z, dt, sdf, t_exit 0). H2: dst[r] =
// src[b] where ray_idx[b] == r, else r's fill; ids >= n are dropped. H2
// reads the ids as a compaction lists them: ascending, the valid ones
// distinct. H2's backward is H1 on the cotangents.
//
// What bounds them on an H100: bytes, each row read once and written once.
//
// Design: H1 runs one block per bucket row, its threads striding over the
// 4-byte words of each array's row (bytes where a row is not a whole number
// of aligned words). H2 runs one thread per destination row, which finds
// its bucket row by a binary search of the ascending ids (or writes the
// fills), so every destination row is written once, in one launch. The
// arrays travel in one parameter struct.
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 64;
constexpr int kScatterThreads = 256;

// Row src_row of array k to row dst_row (its fill pattern instead with
// `fill`), words first..: step apart.
__device__ __forceinline__ void copy_row(const RowArrays& a, int k, long long src_row,
                                         long long dst_row, bool fill, int first, int step) {
  const long long nb = a.row_bytes[k];
  const uint8_t* s = (const uint8_t*)a.src[k] + src_row * nb;
  uint8_t* d = (uint8_t*)a.dst[k] + dst_row * nb;
  if (nb % 4 == 0 && ((uintptr_t)a.src[k] | (uintptr_t)a.dst[k]) % 4 == 0) {
    for (long long w = first; w < nb / 4; w += step)
      ((unsigned*)d)[w] = fill ? a.fill[k] : ((const unsigned*)s)[w];
  } else {
    for (long long w = first; w < nb; w += step)
      d[w] = fill ? (uint8_t)(a.fill[k] & 0xffu) : s[w];
  }
}

__global__ void __launch_bounds__(kRowThreads) take_rows_kernel(
    RowArrays a, const long long* __restrict__ ray_idx, long long n) {
  const long long b = blockIdx.x;
  const long long i = ray_idx[b];
  const bool valid = i >= 0 && i < n;
  for (int k = 0; k < a.count; ++k)
    copy_row(a, k, valid ? i : 0, b, !valid, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kScatterThreads) scatter_rows_kernel(
    RowArrays a, const long long* __restrict__ ray_idx, int B, long long n) {
  const long long r = (long long)blockIdx.x * kScatterThreads + threadIdx.x;
  if (r >= n) return;
  int lo = 0, hi = B;  // the first b with ray_idx[b] >= r
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ray_idx[mid] < r) lo = mid + 1;
    else hi = mid;
  }
  const bool hit = lo < B && ray_idx[lo] == r;
  for (int k = 0; k < a.count; ++k) copy_row(a, k, hit ? lo : 0, r, !hit, 0, 1);
}

}  // namespace

// H1: B bucket rows gathered from n source rows by ray_idx [B] int64.
extern "C" int psdf_take_rows(RowArrays arrays, const void* ray_idx, int B, long long n,
                              void* stream) {
  if (B < 0 || arrays.count < 0 || arrays.count > kMaxArrays) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  PSDF_LAUNCH(take_rows_kernel, B, kRowThreads, 0, stream, arrays, (const long long*)ray_idx, n);
  return (int)cudaGetLastError();
}

// H2: n destination rows, each the bucket row that ray_idx [B] (ascending)
// sends there or else its fills.
extern "C" int psdf_scatter_rows(RowArrays arrays, const void* ray_idx, int B, long long n,
                                 void* stream) {
  if (B < 0 || n < 0 || n >= (1LL << 31) || arrays.count < 0 || arrays.count > kMaxArrays)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  PSDF_LAUNCH(scatter_rows_kernel, psdf_blocks(n, kScatterThreads), kScatterThreads, 0, stream,
              arrays, (const long long*)ray_idx, B, n);
  return (int)cudaGetLastError();
}

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
