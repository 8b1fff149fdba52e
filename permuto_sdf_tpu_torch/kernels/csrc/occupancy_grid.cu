// Kernel C: sample placement through the occupied voxels of a ray.
//
// Replaces: permuto_sdf_tpu/ops/occupancy_grid.py:226
// `compute_samples_in_occupied_regions` (with `_probe_occupancy` :212),
// with jitter off (the eval render). The JAX package leaves it to XLA.
//
// What bounds it on an H100: memory latency and bytes of the probes. Each
// ray reads P = 512 one-byte voxels of the 16.8 MB bool grid at positions
// that step along the ray (mostly distinct 32-byte sectors), and writes
// 64 samples of z, dt and mask; the arithmetic is small.
//
// Design: one warp per ray. Lane k probes the contiguous run of P/32
// probes [k*P/32, (k+1)*P/32), so all of a lane's loads are independent
// and in flight together; the occupied counts become a prefix count by a
// warp scan of the lane totals and are kept in shared memory as integers
// (cum = count * seg_len with one rounding, as in the plain version); each
// lane then places S/32 samples by a binary search over the counts
// (searchsorted side="right"). Rules kept from the JAX op: rays with <= 2
// samples are zeroed, the start offset is 0.5 (no jitter), and the last
// valid sample's dt is clamped to the distance left to t_exit.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(128) probe_sampler_kernel(
    int R, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_entry, const float* __restrict__ t_exit,
    const uint8_t* __restrict__ occ, int V, float half_extent, float tx,
    float ty, float tz, float voxel_size, float min_dist, int S, int P,
    float* __restrict__ z, float* __restrict__ dt, uint8_t* __restrict__ mask,
    float* __restrict__ ray_fixed_dt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  int* cnt = psdf_dynamic_smem<int>() + warp * P;

  const float ox = origins[ray * 3 + 0], oy = origins[ray * 3 + 1],
              oz = origins[ray * 3 + 2];
  const float dx = dirs[ray * 3 + 0], dy = dirs[ray * 3 + 1],
              dz = dirs[ray * 3 + 2];
  const float te = t_entry[ray];
  const float tx1 = t_exit[ray];
  const int per_lane = P / 32;

  int c = 0;
  for (int k = 0; k < per_lane; ++k) {
    const int p = lane * per_lane + k;
    const float frac = ((float)p + 0.5f) / (float)P;
    const float ts = te + frac * (tx1 - te);
    const float px = ox + ts * dx, py = oy + ts * dy, pz = oz + ts * dz;
    const int ix = (int)floorf(((px - tx) + half_extent) / voxel_size);
    const int iy = (int)floorf(((py - ty) + half_extent) / voxel_size);
    const int iz = (int)floorf(((pz - tz) + half_extent) / voxel_size);
    const bool inb = ix >= 0 && ix < V && iy >= 0 && iy < V && iz >= 0 &&
                     iz < V;
    if (inb && occ[((long long)ix * V + iy) * V + iz] != 0) ++c;
    cnt[p] = c;
  }
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  const int lane_excl = incl - c;
  for (int k = 0; k < per_lane; ++k) cnt[lane * per_lane + k] += lane_excl;
  const int total = __shfl_sync(PSDF_FULL_MASK, incl, 31);
  __syncwarp();

  const float seg_len = (tx1 - te) / (float)P;
  const float occupied_dist = (float)total * seg_len;
  int nr = (int)floorf(occupied_dist / min_dist);
  nr = min(max(nr, 0), S);
  if (nr <= 2) nr = 0;
  const float dt_ray = nr > 0 ? occupied_dist / (float)max(nr, 1) : 0.f;

  for (int s = lane; s < S; s += 32) {
    const float arc = ((float)s + 0.5f) * dt_ray;
    // first probe whose cumulative occupied length exceeds arc
    int lo = 0, hi = P;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((float)cnt[mid] * seg_len <= arc) lo = mid + 1;
      else hi = mid;
    }
    const int idx = min(lo, P - 1);
    const float cum_before = idx > 0 ? (float)cnt[idx - 1] * seg_len : 0.f;
    const float into = fminf(fmaxf(arc - cum_before, 0.f), seg_len);
    const float t = (te + (float)idx * seg_len) + into;
    const bool valid = s < nr;
    const float zz = valid ? t : 0.f;
    float d = valid ? dt_ray : 0.f;
    if (valid && s == nr - 1) d = fminf(fmaxf(tx1 - zz, 0.f), dt_ray);
    z[ray * S + s] = zz;
    dt[ray * S + s] = d;
    mask[ray * S + s] = valid ? 1 : 0;
  }
  if (lane == 0) ray_fixed_dt[ray] = nr > 0 ? dt_ray : 0.f;
}

}  // namespace

extern "C" int psdf_probe_sampler(int R, const void* origins, const void* dirs,
                                  const void* t_entry, const void* t_exit,
                                  const void* occ, int V, float half_extent,
                                  float tx, float ty, float tz,
                                  float voxel_size, float min_dist, int S,
                                  int P, void* z, void* dt, void* mask,
                                  void* ray_fixed_dt, void* stream) {
  if (P % 32 != 0) return (int)cudaErrorInvalidValue;
  const int block = 128;  // 4 rays per block
  const int grid = psdf_blocks((long long)R * 32, block);
  if (grid == 0) return 0;
  const size_t smem = (size_t)(block / 32) * P * sizeof(int);
  PSDF_LAUNCH(probe_sampler_kernel, grid, block, smem, stream, R,
              (const float*)origins, (const float*)dirs,
              (const float*)t_entry, (const float*)t_exit,
              (const uint8_t*)occ, V, half_extent, tx, ty, tz, voxel_size,
              min_dist, S, P, (float*)z, (float*)dt, (uint8_t*)mask,
              (float*)ray_fixed_dt);
  return (int)cudaGetLastError();
}
