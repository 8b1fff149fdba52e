// Kernel H0: order-preserving stream compaction of a boolean mask, or of
// the mask combined with a second one (mask & other, mask & ~other).
//
// Replaces: `jnp.nonzero(mask, size=size, fill_value=len(mask))`, which the
// JAX package calls at permuto_sdf_tpu/ops/sphere_trace.py:328 and :425 and
// permuto_sdf_tpu/train/train_permuto_sdf.py:436 (`_compact_idx`) and :1699
// (`_shade_hits_compact`); XLA lowers it to a cumulative sum and a scatter.
// The tracer's masks `alive & ~conv` and `conv & alive` are formed there
// by elementwise ops first; here the loads form them.
// Out: idx [size] int64, the first `size` true positions in ascending order
// with the fill value in the unused slots, and the number of true entries.
//
// What bounds it on an H100: bytes, n mask bytes (2n with a second mask)
// read and 8 bytes per output slot written; a few integer ops per element.
// At the tracers' sizes (n ~ 2e5 bytes, ~0.1 us of traffic) a call is the
// latency of its two launches.
//
// Design: tiles of 2048 elements (256 threads x 8 consecutive elements).
// The first launch counts the true entries of each tile; the second runs
// one block per tile: the block sums the counts of the tiles before its own
// (its offset) and of all tiles (the total) with a block reduction, scans
// its threads' counts (a warp scan, then the warp totals), and writes the
// positions of its true entries that fall below `size`, in order. Slots
// [total, size) get the fill value, spread over all threads of the grid.
// Both launches form the combined mask from the two masks' bytes. No
// atomics, so the result is the same on every run; no host
// synchronisation. One launch of a thread-block cluster, whose blocks
// exchange their counts through distributed shared memory, was measured
// slower at every n (PERF.md §6, PR 17; profiling/h0_variants.cu).
#include "common.cuh"

// The arrays kernels H1 and H2 move (below), passed by value.
constexpr int kMaxArrays = 12;
struct RowArrays {
  const void* src[kMaxArrays];
  void* dst[kMaxArrays];
  long long row_bytes[kMaxArrays];
  unsigned fill[kMaxArrays];  // a 4-byte pattern (H2's fills; 0 for H1)
  int chunk[kMaxArrays];      // H1: the bytes a thread moves at once, 16, 8, 4 or 1
  int first_chunk[kMaxArrays];  // H1: the array's first chunk in a row's chunks
  int row_chunks;             // H1: the chunks of a row, all arrays
  int count;
};

namespace {

// How the second mask combines with the first.
enum CompactMode { kMaskOnly = 0, kAnd = 1, kAndNot = 2 };

// Element i of the combined mask, read as bytes.
__device__ __forceinline__ bool combined_at(const uint8_t* __restrict__ a,
                                            const uint8_t* __restrict__ b, int mode,
                                            long long i) {
  return a[i] != 0 && (mode == kMaskOnly || ((b[i] != 0) == (mode == kAnd)));
}

// The top bit of each byte of w that is nonzero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// Four bytes of each mask, combined -> 4 bits, byte k at bit k.
__device__ __forceinline__ unsigned word_bits(unsigned a, unsigned b, int mode) {
  unsigned t = nonzero_bytes(a);
  if (mode == kAnd) t &= nonzero_bytes(b);
  if (mode == kAndNot) t &= ~nonzero_bytes(b);
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) | ((t >> 28) & 8u);
}

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;

// The thread's kPerThread elements from base of the combined mask as bits
// (element base + k at bit k) -> their count: one 8-byte load of each mask
// where both are 8-byte aligned and the run lies inside them, else bytes.
__device__ __forceinline__ int thread_count(int n, const uint8_t* __restrict__ mask,
                                            const uint8_t* __restrict__ other, int mode,
                                            long long base, unsigned* bits) {
  const uint8_t* second = mode == kMaskOnly ? mask : other;
  unsigned b = 0;
  if (base + kPerThread <= n && (((uintptr_t)mask | (uintptr_t)second) & 7) == 0) {
    const uint2 x = *reinterpret_cast<const uint2*>(mask + base);
    const uint2 y = *reinterpret_cast<const uint2*>(second + base);
    b = word_bits(x.x, y.x, mode) | word_bits(x.y, y.y, mode) << 4;
  } else {
    for (int k = 0; k < kPerThread && base + k < n; ++k)
      b |= (unsigned)combined_at(mask, second, mode, base + k) << k;
  }
  *bits = b;
  return __popc(b);
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
    int n, const uint8_t* __restrict__ mask, const uint8_t* __restrict__ other, int mode,
    int* __restrict__ tile_counts) {
  int* red = psdf_dynamic_smem<int>();
  unsigned bits;
  const long long base = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kPerThread;
  const int total = block_sum(thread_count(n, mask, other, mode, base, &bits), red);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads) compact_write_kernel(
    int n, const uint8_t* __restrict__ mask, const uint8_t* __restrict__ other, int mode,
    const int* __restrict__ tile_counts, int nr_tiles, int size, long long fill,
    long long* __restrict__ idx, int* __restrict__ count) {
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
  const int c = blockIdx.x < (unsigned)nr_tiles ? thread_count(n, mask, other, mode, base, &bits)
                                                : 0;
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
// At the training step's bucket (256 rows of ~0.9 KB, 8 arrays) that is
// ~0.46 MB, ~0.1 us of traffic: a launch is its latency.
//
// Design of H1: one flat space of (bucket row, array, chunk). The host
// gives each array a chunk width, the widest of 16, 8, 4 or 1 bytes that
// its base pointers and its row bytes allow (16 for the step's sample
// rows, 4 for a row of 3 floats, 1 for a 3-byte bool row or an odd base),
// and its first chunk in a row. A block loads the ids of the rows its
// chunks fall in once, into shared memory; each thread then issues the
// read-only loads of its kPer chunks (up to 16 bytes each) before any of
// its stores, so a row costs one round trip to memory and not one per
// array. kPer is 1, 2 or 4, the most that still launches a block per
// streaming multiprocessor. It replaced one 64-thread block per bucket row
// whose threads walked the arrays one after another in 4- or 1-byte
// copies, each array's loads behind the previous array's stores: 0.00325
// device ms a launch at the step's bucket against 0.00230, and 0.00334
// against 0.00268 in the hit-ray step (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py, profiling/torch_encode_paths.py --paths train).
//
// Design of H2: one thread per destination row, which finds its bucket row
// by a binary search of the ascending ids (or writes the fills), so every
// destination row is written once, in one launch. The arrays travel in one
// parameter struct.
// ---------------------------------------------------------------------------

constexpr int kTakeThreads = 128;
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

// A chunk of `width` bytes at p, read through the read-only path.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ p, int width) {
  uint4 v{0u, 0u, 0u, 0u};
  if (width == 16) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  } else if (width == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v.x = u.x;
    v.y = u.y;
  } else if (width == 4) {
    v.x = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    v.x = __ldg(p);
  }
  return v;
}

__device__ __forceinline__ void store_chunk(uint8_t* __restrict__ p, int width, uint4 v) {
  if (width == 16) {
    *reinterpret_cast<uint4*>(p) = v;
  } else if (width == 8) {
    uint2 u;
    u.x = v.x;
    u.y = v.y;
    *reinterpret_cast<uint2*>(p) = u;
  } else if (width == 4) {
    *reinterpret_cast<unsigned*>(p) = v.x;
  } else {
    *p = (uint8_t)v.x;
  }
}

// Kernel H1: chunks [g0, g0 + kTakeThreads kPer) of the flat space, chunk g
// of bucket row g / row_chunks; thread t takes chunks g0 + t + m
// kTakeThreads. A row whose id is not below n is zeros. Shared memory:
// kTakeThreads kPer ids.
template <int kPer>
__global__ void __launch_bounds__(kTakeThreads) take_rows_kernel(
    RowArrays a, const long long* __restrict__ ray_idx, long long total, long long n) {
  long long* src_row = psdf_dynamic_smem<long long>();  // a row's source, or -1: zeros
  const long long rc = a.row_chunks;
  const long long g0 = (long long)blockIdx.x * kTakeThreads * kPer;
  const long long g_end = min(g0 + kTakeThreads * kPer, total);
  const long long b0 = g0 / rc;
  const int rows = (int)((g_end - 1) / rc - b0 + 1);
  for (int r = threadIdx.x; r < rows; r += kTakeThreads) {
    const long long i = __ldg(ray_idx + b0 + r);
    src_row[r] = i >= 0 && i < n ? i : -1;
  }
  __syncthreads();
  uint4 v[kPer];
  uint8_t* dst[kPer];
  int width[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {  // every load before any store
    const long long g = g0 + m * kTakeThreads + threadIdx.x;
    dst[m] = nullptr;
    if (g >= g_end) continue;
    const long long b = g / rc;
    const int c = (int)(g - b * rc);
    int k = 0;
    while (k + 1 < a.count && c >= a.first_chunk[k + 1]) ++k;
    const int w = a.chunk[k];
    const long long off = (long long)(c - a.first_chunk[k]) * w;
    const long long i = src_row[b - b0];
    width[m] = w;
    dst[m] = (uint8_t*)a.dst[k] + b * a.row_bytes[k] + off;
    v[m] = i >= 0 ? load_chunk((const uint8_t*)a.src[k] + i * a.row_bytes[k] + off, w)
                  : uint4{0u, 0u, 0u, 0u};
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m)
    if (dst[m] != nullptr) store_chunk(dst[m], width[m], v[m]);
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

// H1: B bucket rows gathered from n source rows by ray_idx [B] int64, in
// one launch (none for B = 0 or rows of no chunks).
extern "C" int psdf_take_rows(RowArrays arrays, const void* ray_idx, int B, long long n,
                              void* stream) {
  if (B < 0 || arrays.count < 0 || arrays.count > kMaxArrays || arrays.row_chunks < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * arrays.row_chunks;
  if (total == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != 0) return err;
  // chunks a thread: the most that still gives every streaming multiprocessor a block
  const long long per_sm = total / ((long long)kTakeThreads * max(sms, 1));
  const int per = per_sm >= 4 ? 4 : per_sm >= 2 ? 2 : 1;
  const int grid = psdf_blocks(total, kTakeThreads * per);
  const auto* ids = (const long long*)ray_idx;
  if (per == 4)
    PSDF_LAUNCH(take_rows_kernel<4>, grid, kTakeThreads, kTakeThreads * 4 * 8, stream,
                arrays, ids, total, n);
  else if (per == 2)
    PSDF_LAUNCH(take_rows_kernel<2>, grid, kTakeThreads, kTakeThreads * 2 * 8, stream,
                arrays, ids, total, n);
  else
    PSDF_LAUNCH(take_rows_kernel<1>, grid, kTakeThreads, kTakeThreads * 1 * 8, stream,
                arrays, ids, total, n);
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

// Kernel H0: mask [n] bool, combined with other [n] bool by mode (0 the
// mask alone, 1 mask & other, 2 mask & ~other) -> idx [size] int64 (the
// fill in the unused slots), count [1] int32; tile_counts: scratch of
// max(1, ceil(n / 2048)) ints.
extern "C" int psdf_compact(int n, const void* mask, const void* other, int mode, int size,
                            long long fill, void* tile_counts, void* idx, void* count,
                            void* stream) {
  if (n < 0 || size < 0 || mode < kMaskOnly || mode > kAndNot ||
      (mode != kMaskOnly && other == nullptr && n > 0))
    return (int)cudaErrorInvalidValue;
  const int nr_tiles = psdf_blocks(n, kTile);
  if (nr_tiles > 0) {
    PSDF_LAUNCH(compact_count_kernel, nr_tiles, kThreads, kWarps * sizeof(int), stream,
                n, (const uint8_t*)mask, (const uint8_t*)other, mode, (int*)tile_counts);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  PSDF_LAUNCH(compact_write_kernel, nr_tiles > 0 ? nr_tiles : 1, kThreads,
              3 * kWarps * sizeof(int), stream, n, (const uint8_t*)mask,
              (const uint8_t*)other, mode, (const int*)tile_counts, nr_tiles, size, fill,
              (long long*)idx, (int*)count);
  return (int)cudaGetLastError();
}
