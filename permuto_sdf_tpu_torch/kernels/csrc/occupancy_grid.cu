// Kernel C: sample placement through the occupied voxels of a ray.
// Kernel I: the occupancy refresh from SDF probes.
//
// Replaces: permuto_sdf_tpu/ops/occupancy_grid.py:226
// `compute_samples_in_occupied_regions` (with `_probe_occupancy` :212) --
// kernel C -- and :138 `compute_stratified_sample_of_grid_points` with :179
// `update_with_sdf_random_sample` -- kernel I, two entry points around the
// SDF evaluation of the probes. The JAX package leaves them to XLA.
//
// What bounds C on an H100: memory latency and bytes of the probes. Each
// ray reads P = 512 one-byte voxels of the 16.8 MB bool grid at positions
// that step along the ray (mostly distinct 32-byte sectors), and writes
// 64 samples of z, dt and mask; the arithmetic is small. I is bound by the
// scattered writes: each of the n = 262,144 probes writes a 4-byte value
// and a 1-byte flag at a voxel far from its neighbours' (a 32-byte sector
// each).
//
// Design of C: one warp per ray. Lane k probes the contiguous run of P/32
// probes [k*P/32, (k+1)*P/32), so all of a lane's loads are independent
// and in flight together; the occupied counts become a prefix count by a
// warp scan of the lane totals and are kept in shared memory as integers
// (cum = count * seg_len with one rounding, as in the plain version); each
// lane then places S/32 samples by a binary search over the counts
// (searchsorted side="right"). Rules kept from the JAX op: rays with <= 2
// samples are zeroed, the start offset is the per-ray jitter in [0, 1)
// (0.5 without jitter), and the last valid sample's dt is clamped to the
// distance left to t_exit.
//
// Design of I: one thread per probe in both entry points. The voxel of
// probe i of update k is lin = (a (k n + i) + b) mod 2^m in uint32 with a
// and b odd (a Weyl map): a bijection of the voxel ids, so no two probes
// of one update share a voxel and the scatter needs no atomics.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(128) probe_sampler_kernel(
    int R, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_entry, const float* __restrict__ t_exit,
    const float* __restrict__ start, const uint8_t* __restrict__ occ, int V,
    float half_extent, float tx, float ty, float tz, float voxel_size, float min_dist, int S, int P,
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
  const float st = (start != nullptr) ? start[ray] : 0.5f;
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
    const float arc = ((float)s + st) * dt_ray;
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

// Kernel I, entry 1: voxel ids and (jittered) centers of the n probes of
// update `update_idx`. jitter [n, 3] in [-0.5, 0.5) voxels, or null.
__global__ void __launch_bounds__(256) grid_points_kernel(
    int n, uint32_t update_idx, int V, uint32_t lin_mask, float voxel_size,
    float half_extent, float tx, float ty, float tz,
    const float* __restrict__ jitter, int* __restrict__ lin_out,
    float* __restrict__ centers) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const uint32_t i = update_idx * (uint32_t)n + (uint32_t)k;
  const uint32_t lin = (i * 2654435761u + 340573321u) & lin_mask;
  const uint32_t vv = (uint32_t)V * (uint32_t)V;
  const float ijk[3] = {(float)(lin / vv), (float)((lin / (uint32_t)V) % V),
                        (float)(lin % (uint32_t)V)};
  const float t[3] = {tx, ty, tz};
  lin_out[k] = (int)lin;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float c = ((ijk[j] + 0.5f) * voxel_size - half_extent) + t[j];
    if (jitter != nullptr) c = c + jitter[(long long)k * 3 + j] * voxel_size;
    centers[(long long)k * 3 + j] = c;
  }
}

// Kernel I, entry 2: values[lin] = sdf and occupancy[lin] = the NeuS
// logistic density of clip(|sdf| - half_diag, 0, 1e10) at inv_s is above
// thresh. The probes' voxels are distinct (see above): plain stores.
__global__ void __launch_bounds__(256) grid_update_kernel(
    int n, const int* __restrict__ lin, const float* __restrict__ sdf,
    float inv_s, float half_diag, float thresh, float* __restrict__ values,
    uint8_t* __restrict__ occupancy) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float v = sdf[k];
  const int at = lin[k];
  values[at] = v;
  const float x = fminf(fmaxf(fabsf(v) - half_diag, 0.f), 1e10f);
  const float e = expf(-inv_s * x);
  const float density = inv_s * e / ((1.0f + e) * (1.0f + e));
  occupancy[at] = density > thresh ? 1 : 0;
}

}  // namespace

extern "C" int psdf_probe_sampler(int R, const void* origins, const void* dirs,
                                  const void* t_entry, const void* t_exit,
                                  const void* start, const void* occ, int V,
                                  float half_extent, float tx, float ty,
                                  float tz, float voxel_size, float min_dist, int S,
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
              (const float*)start, (const uint8_t*)occ, V, half_extent, tx,
              ty, tz, voxel_size, min_dist, S, P, (float*)z, (float*)dt, (uint8_t*)mask,
              (float*)ray_fixed_dt);
  return (int)cudaGetLastError();
}

extern "C" int psdf_grid_points(int n, unsigned int update_idx, int V,
                                float voxel_size, float half_extent, float tx,
                                float ty, float tz, const void* jitter,
                                void* lin, void* centers, void* stream) {
  const long long nv = (long long)V * V * V;
  if ((nv & (nv - 1)) != 0 || nv > (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int block = 256;
  const int grid = psdf_blocks(n, block);
  if (grid == 0) return 0;
  PSDF_LAUNCH(grid_points_kernel, grid, block, 0, stream, n,
              (uint32_t)update_idx, V, (uint32_t)(nv - 1), voxel_size,
              half_extent, tx, ty, tz, (const float*)jitter, (int*)lin,
              (float*)centers);
  return (int)cudaGetLastError();
}

extern "C" int psdf_grid_update(int n, const void* lin, const void* sdf,
                                float inv_s, float half_diag, float thresh,
                                void* values, void* occupancy, void* stream) {
  const int block = 256;
  const int grid = psdf_blocks(n, block);
  if (grid == 0) return 0;
  PSDF_LAUNCH(grid_update_kernel, grid, block, 0, stream, n, (const int*)lin,
              (const float*)sdf, inv_s, half_diag, thresh, (float*)values,
              (uint8_t*)occupancy);
  return (int)cudaGetLastError();
}
