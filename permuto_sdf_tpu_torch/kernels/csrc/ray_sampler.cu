// Kernel C2: uniform foreground samples between the bound's entry and exit
// (sampling without the occupancy grid).
//
// Replaces: permuto_sdf_tpu/ops/ray_sampler.py:29 `compute_samples_fg`. The
// JAX package leaves it to XLA.
//
// What bounds it on an H100: bytes. Per ray it reads t_entry, t_exit and
// the jitter (12 bytes) and writes S samples of z, dt and mask (9 bytes
// each) and ray_fixed_dt; the arithmetic is ~20 operations per sample.
//
// Design: one thread per sample slot, neighbouring threads on neighbouring
// slots of one ray, so the [R, S] stores are coalesced. Each thread forms
// its ray's scalars itself (a few operations, cheaper than a pass of its
// own): the count nr = clamp(int(dist / min_dist), 0, S) and the spacing
// dt_ray = dist / nr taken from it, then the discard of rays with <= 2
// samples (so ray_fixed_dt reads the count after the discard, dt_ray the
// one before), the start t_entry + u dt_ray with the per-ray jitter u in
// [0, 1) (0 without), z clipped to [t_entry, t_exit], and the last valid
// sample's dt the distance left to t_exit, clamped to [0, dt_ray]. The
// float operations are the JAX op's, in its order.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) samples_fg_kernel(
    long long n, int S, const float* __restrict__ t_entry,
    const float* __restrict__ t_exit, const float* __restrict__ start,
    float min_dist, float* __restrict__ z, float* __restrict__ dt,
    uint8_t* __restrict__ mask, float* __restrict__ ray_fixed_dt) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = i / S;
  const int s = (int)(i % S);
  const float t0 = t_entry[r], t1 = t_exit[r];
  const float dist = t1 - t0;
  const float q = dist / min_dist;
  // int32 truncation, then clamp to [0, S] (a NaN count is 0)
  int nr = !(q > 0.f) ? 0 : (q >= (float)S ? S : (int)q);
  const float dt_ray = nr > 0 ? dist / (float)max(nr, 1) : 0.f;
  if (nr <= 2) nr = 0;  // the reference's discard rule
  const float base = t0 + (start != nullptr ? start[r] * dt_ray : 0.f);
  const bool valid = s < nr;
  const float zz = valid ? fminf(fmaxf(base + (float)s * dt_ray, t0), t1) : 0.f;
  float d = valid ? dt_ray : 0.f;
  const int last = max(nr - 1, 0);
  if (valid && s == last) {
    const float z_last = fminf(fmaxf(base + (float)last * dt_ray, t0), t1);
    d = fminf(fmaxf(t1 - z_last, 0.f), dt_ray);
  }
  z[i] = zz;
  dt[i] = d;
  mask[i] = valid ? 1 : 0;
  if (s == 0) ray_fixed_dt[r] = nr > 0 ? dt_ray : 0.f;
}

}  // namespace

extern "C" int psdf_samples_fg(int R, int S, const void* t_entry,
                               const void* t_exit, const void* start,
                               float min_dist, void* z, void* dt, void* mask,
                               void* ray_fixed_dt, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const int block = 256;
  const long long n = (long long)R * S;
  const int grid = psdf_blocks(n, block);
  if (grid == 0) return 0;
  PSDF_LAUNCH(samples_fg_kernel, grid, block, 0, stream, n, S,
              (const float*)t_entry, (const float*)t_exit,
              (const float*)start, min_dist, (float*)z, (float*)dt,
              (uint8_t*)mask, (float*)ray_fixed_dt);
  return (int)cudaGetLastError();
}
