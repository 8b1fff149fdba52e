// Kernel C2 (ray_sampler.cu) in the thread mappings the port measured
// against its own (one flat index over the [R, S] slots, a thread a slot),
// for measurement only: design 1, a block row a ray and a thread a slot
// (2-D blocks, so no thread divides an index); design 2, a block row a ray
// at four slots a thread, with 16-byte stores of z and dt and a 4-byte
// store of the mask (S a multiple of 4). Both use the port's intersection
// and slot code, so they write the port's outputs bit for bit. Built
// (nvcc only) and timed by profiling/c2_designs.py; no path of the port
// calls them.
#include "ray_sampler.cu"

namespace {

// The ray's per-ray outputs, as the port's kernel writes them.
__device__ __forceinline__ void write_ray(long long r, const FgRay& q, float t0, float t1,
                                          bool hit, float* ray_fixed_dt, float* t_entry,
                                          float* t_exit, uint8_t* does_intersect) {
  ray_fixed_dt[r] = q.nr > 0 ? q.dt_ray : 0.f;
  t_entry[r] = t0;
  t_exit[r] = t1;
  does_intersect[r] = hit ? 1 : 0;
}

__global__ void __launch_bounds__(256) samples_fg_kernel_rows(
    int R, int S, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ start, float cx, float cy, float cz, float r2, float min_dist,
    float* __restrict__ z, float* __restrict__ dt, uint8_t* __restrict__ mask,
    float* __restrict__ ray_fixed_dt, float* __restrict__ t_entry,
    float* __restrict__ t_exit, uint8_t* __restrict__ does_intersect) {
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= R) return;
  float t0, t1;
  const bool hit = sphere_span(origins, dirs, r, cx, cy, cz, r2, &t0, &t1);
  const FgRay q = fg_ray(t0, t1, start, r, min_dist, S);
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    fg_slot(q, s, z + r * S + s, dt + r * S + s, mask + r * S + s);
  if (threadIdx.x == 0)
    write_ray(r, q, t0, t1, hit, ray_fixed_dt, t_entry, t_exit, does_intersect);
}

__global__ void __launch_bounds__(256) samples_fg_kernel_vec4(
    int R, int S, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ start, float cx, float cy, float cz, float r2, float min_dist,
    float* __restrict__ z, float* __restrict__ dt, uint8_t* __restrict__ mask,
    float* __restrict__ ray_fixed_dt, float* __restrict__ t_entry,
    float* __restrict__ t_exit, uint8_t* __restrict__ does_intersect) {
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= R) return;
  float t0, t1;
  const bool hit = sphere_span(origins, dirs, r, cx, cy, cz, r2, &t0, &t1);
  const FgRay q = fg_ray(t0, t1, start, r, min_dist, S);
  for (int s0 = 4 * threadIdx.x; s0 < S; s0 += 4 * blockDim.x) {
    float zs[4], ds[4];
    uint8_t ms[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) fg_slot(q, s0 + k, zs + k, ds + k, ms + k);
    const long long at = r * S + s0;
    *reinterpret_cast<float4*>(z + at) = float4{zs[0], zs[1], zs[2], zs[3]};
    *reinterpret_cast<float4*>(dt + at) = float4{ds[0], ds[1], ds[2], ds[3]};
    *reinterpret_cast<unsigned*>(mask + at) =
        ms[0] | (unsigned)ms[1] << 8 | (unsigned)ms[2] << 16 | (unsigned)ms[3] << 24;
  }
  if (threadIdx.x == 0)
    write_ray(r, q, t0, t1, hit, ray_fixed_dt, t_entry, t_exit, does_intersect);
}

}  // namespace

// psdf_samples_fg's arguments and outputs, in design 0 (the port's kernel),
// 1 (a block row a ray) or 2 (four slots a thread).
extern "C" int psdf_samples_fg_design(int design, int R, int S, const void* origins,
                                      const void* dirs, const void* start, float cx, float cy,
                                      float cz, float r2, float min_dist, void* z, void* dt,
                                      void* mask, void* ray_fixed_dt, void* t_entry,
                                      void* t_exit, void* does_intersect, void* stream) {
  if (design == 0)
    return psdf_samples_fg(R, S, origins, dirs, start, cx, cy, cz, r2, min_dist, z, dt, mask,
                           ray_fixed_dt, t_entry, t_exit, does_intersect, stream);
  const uintptr_t vec = (uintptr_t)z | (uintptr_t)dt;
  if (S <= 0 || R < 0 || design < 1 || design > 2 ||
      (design == 2 && (S % 4 != 0 || vec % 16 != 0 || (uintptr_t)mask % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  // a block: 256 threads, as many rays as fit at up to 256 threads a ray
  const int tx = min(design == 1 ? S : S / 4, 256), ty = max(1, 256 / tx);
  const dim3 block(tx, ty);
  const int grid = psdf_blocks(R, ty);
  auto kernel = design == 1 ? samples_fg_kernel_rows : samples_fg_kernel_vec4;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      R, S, (const float*)origins, (const float*)dirs, (const float*)start, cx, cy, cz, r2,
      min_dist, (float*)z, (float*)dt, (uint8_t*)mask, (float*)ray_fixed_dt, (float*)t_entry,
      (float*)t_exit, (uint8_t*)does_intersect);
  return (int)cudaGetLastError();
}
