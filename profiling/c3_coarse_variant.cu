// Kernel C3's design before it read the distance field, for measurement
// only: the same warp per ray and the same two passes as
// `first_occupied_kernel`, but the span test of pass 1 reads a coarse grid
// (a byte per 8^3 block of voxels, set iff any of its voxels is: the JAX
// package's `downsample_occupancy` at factor 8, 32 KB at V = 256, built by
// entry 1 once per grid state) in place of the distance field, and pass 2
// reads a probe's coarse cell before its voxel's byte. The result equals
// the plain version's. Built and timed by profiling/c3_designs.py; no path
// of the port calls it.
#include "occupancy_grid.cu"

namespace {

// Entry 1: coarse[c] = any of the voxels of coarse cell c, the
// 8^3 block at 8 (cx, cy, cz) of the V^3 grid (an axis's last block cut at
// V). One thread per coarse cell. kWords (V a multiple of 8, the grid
// 8-byte aligned): neighbouring threads read neighbouring 8-byte runs;
// otherwise the block's voxels one byte at a time.
template <bool kWords>
__global__ void __launch_bounds__(128) coarse_occupancy_kernel(
    int V, const uint8_t* __restrict__ occ, uint8_t* __restrict__ coarse) {
  const int C = (V + 7) >> 3;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)C * C * C) return;
  const int cz = (int)(c % C), cy = (int)((c / C) % C), cx = (int)(c / C / C);
  bool any = false;
  if constexpr (kWords) {
    const unsigned long long* rows = reinterpret_cast<const unsigned long long*>(occ);
    unsigned long long w = 0;
#pragma unroll 8
    for (int r = 0; r < 64; ++r) {  // the block's rows (x, y): 8 voxels along z each
      const long long x = 8 * cx + (r >> 3), y = 8 * cy + (r & 7);
      w |= rows[((x * V + y) * V + 8 * cz) >> 3];
    }
    any = w != 0;
  } else {
    const int x1 = min(8 * cx + 8, V), y1 = min(8 * cy + 8, V), z1 = min(8 * cz + 8, V);
    for (int x = 8 * cx; x < x1 && !any; ++x)
      for (int y = 8 * cy; y < y1 && !any; ++y)
        for (int z = 8 * cz; z < z1 && !any; ++z)
          any = occ[((long long)x * V + y) * V + z] != 0;
  }
  coarse[c] = any ? 1 : 0;
}

// A span whose box of coarse cells holds more than kBoxCells cells is
// probed one by one without the test.
constexpr int kBoxCells = 8;

// Entry 2: per ray, the start of the first occupied probe segment
// and whether there is one (t_exit without one), the voxels read through the
// coarse grid of entry 1. kPow2: see probe_ijk.
template <bool kPow2>
__global__ void __launch_bounds__(128) first_occupied_coarse_kernel(
    int R, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_entry, const float* __restrict__ t_exit,
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ coarse,
    int V, float half_extent, float tx, float ty, float tz, float voxel_size,
    int P, float inv_P, float inv_vs, float* __restrict__ t_first,
    uint8_t* __restrict__ has) {
  const int lane = threadIdx.x & 31;
  const long long ray =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // whole warps leave together
  const float ox = origins[ray * 3 + 0], oy = origins[ray * 3 + 1],
              oz = origins[ray * 3 + 2];
  const float dx = dirs[ray * 3 + 0], dy = dirs[ray * 3 + 1],
              dz = dirs[ray * 3 + 2];
  const float te = t_entry[ray];
  const float t1 = t_exit[ray];
  const int C = (V + 7) >> 3;
  int first = -1;
  for (int base = 0; base < P && first < 0; base += 32 * kSpan) {  // warp-uniform
    // pass 1: lane l tests span s = base / kSpan + l, probes [a, b] with
    // b = a + kSpan (the next span's first probe) or P - 1. Each axis's
    // voxel index is monotone in the probe index (every float operation of
    // probe_ijk is), so the span's probes lie in the box of coarse cells
    // spanned by its two ends' cells.
    const int a = base + kSpan * lane;
    int ix, iy, iz;
    probe_ijk<kPow2>(V, half_extent, tx, ty, tz, voxel_size, ox, oy, oz, dx,
                     dy, dz, te, t1, min(a, P - 1), P, ix, iy, iz, inv_P,
                     inv_vs);
    int jx = __shfl_down_sync(PSDF_FULL_MASK, ix, 1);
    int jy = __shfl_down_sync(PSDF_FULL_MASK, iy, 1);
    int jz = __shfl_down_sync(PSDF_FULL_MASK, iz, 1);
    const int b = min(a + kSpan, P - 1);
    if (a < P && (lane == 31 || b != a + kSpan))
      probe_ijk<kPow2>(V, half_extent, tx, ty, tz, voxel_size, ox, oy, oz, dx,
                       dy, dz, te, t1, b, P, jx, jy, jz, inv_P, inv_vs);
    bool maybe = false;
    if (a < P) {
      const int x0 = max(min(ix, jx) >> 3, 0), x1 = min(max(ix, jx) >> 3, C - 1);
      const int y0 = max(min(iy, jy) >> 3, 0), y1 = min(max(iy, jy) >> 3, C - 1);
      const int z0 = max(min(iz, jz) >> 3, 0), z1 = min(max(iz, jz) >> 3, C - 1);
      if (x0 <= x1 && y0 <= y1 && z0 <= z1) {
        if ((x1 - x0 + 1) * (y1 - y0 + 1) * (z1 - z0 + 1) > kBoxCells) {
          maybe = true;
        } else {
          for (int x = x0; x <= x1 && !maybe; ++x)
            for (int y = y0; y <= y1 && !maybe; ++y)
              for (int z = z0; z <= z1 && !maybe; ++z)
                maybe = __ldg(coarse + (x * C + y) * C + z) != 0;
        }
      }
    }
    unsigned spans = __ballot_sync(PSDF_FULL_MASK, maybe);
    // pass 2: the flagged spans in order, two a round (half a warp each);
    // each probe reads its coarse cell, and its voxel only where that is set
    while (spans != 0) {  // warp-uniform
      const int s1 = __ffs(spans) - 1;
      spans &= spans - 1;
      const int s2 = spans != 0 ? __ffs(spans) - 1 : -1;
      if (s2 >= 0) spans &= spans - 1;
      const int s = lane < 16 ? s1 : s2;
      const int p = base + kSpan * s + (lane & 15);
      bool o = s >= 0 && p < P &&
               probe_ijk<kPow2>(V, half_extent, tx, ty, tz, voxel_size, ox,
                                oy, oz, dx, dy, dz, te, t1, p, P, ix, iy, iz,
                                inv_P, inv_vs);
      if (o) o = __ldg(coarse + ((ix >> 3) * C + (iy >> 3)) * C + (iz >> 3)) != 0;
      if (o) o = occ[((long long)ix * V + iy) * V + iz] != 0;
      const unsigned hit = __ballot_sync(PSDF_FULL_MASK, o);
      if (hit != 0) {
        const int k = __ffs(hit) - 1;  // the lowest set lane: s1's half first
        first = base + kSpan * (k < 16 ? s1 : s2) + (k & 15);
        break;
      }
    }
  }
  if (lane == 0) {
    const float seg_len = (t1 - te) / (float)P;
    t_first[ray] = first >= 0 ? te + (float)first * seg_len : t1;
    has[ray] = first >= 0 ? 1 : 0;
  }
}

}  // namespace

extern "C" int psdf_coarse_occupancy(int V, const void* occ, void* coarse,
                                     void* stream) {
  if (V <= 0) return (int)cudaErrorInvalidValue;
  const long long C = (V + 7) / 8;
  const int block = 128;
  const int grid = psdf_blocks(C * C * C, block);
  if (V % 8 == 0 && ((uintptr_t)occ & 7) == 0)
    PSDF_LAUNCH(coarse_occupancy_kernel<true>, grid, block, 0, stream, V,
                (const uint8_t*)occ, (uint8_t*)coarse);
  else
    PSDF_LAUNCH(coarse_occupancy_kernel<false>, grid, block, 0, stream, V,
                (const uint8_t*)occ, (uint8_t*)coarse);
  return (int)cudaGetLastError();
}

extern "C" int psdf_first_occupied_coarse(int R, const void* origins, const void* dirs,
                                   const void* t_entry, const void* t_exit,
                                   const void* occ, const void* coarse, int V,
                                   float half_extent, float tx, float ty,
                                   float tz, float voxel_size, int P,
                                   void* t_first, void* has, void* stream) {
  if (P <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const int block = 128;  // 4 rays per block
  const int grid = psdf_blocks((long long)R * 32, block);
  if (grid == 0) return 0;
  // P and the voxel size powers of two (a normal float with a normal
  // reciprocal): their reciprocals are exact
  int e = 0;
  const float m = frexpf(voxel_size, &e);
  const bool pow2 = (P & (P - 1)) == 0 && m == 0.5f && e - 1 >= -126 && 1 - e <= 127;
#define PSDF_COARSE_ARGS                                              \
  R, (const float*)origins, (const float*)dirs, (const float*)t_entry,        \
      (const float*)t_exit, (const uint8_t*)occ, (const uint8_t*)coarse, V,   \
      half_extent, tx, ty, tz, voxel_size, P, 1.0f / (float)P,                \
      ldexpf(1.0f, 1 - e), (float*)t_first, (uint8_t*)has
  if (pow2)
    PSDF_LAUNCH(first_occupied_coarse_kernel<true>, grid, block, 0, stream,
                PSDF_COARSE_ARGS);
  else
    PSDF_LAUNCH(first_occupied_coarse_kernel<false>, grid, block, 0, stream,
                PSDF_COARSE_ARGS);
#undef PSDF_COARSE_ARGS
  return (int)cudaGetLastError();
}
