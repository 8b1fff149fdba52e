// Kernel C2: uniform foreground samples between the bound sphere's entry
// and exit (sampling without the occupancy grid), with the sphere's
// intersection computed in the same launch.
//
// Replaces: permuto_sdf_tpu/ops/ray_sampler.py:29 `compute_samples_fg`,
// and permuto_sdf_tpu/ops/ray_primitives.py:18 `Sphere.ray_intersection`
// before it (train_permuto_sdf.py:473 and train_nerf.py:154 without the
// grid). The JAX package leaves both to XLA.
//
// What bounds it on an H100: bytes. Per ray it reads the origin, the
// direction and the jitter (28 bytes), writes t_entry, t_exit and
// does_intersect (9 bytes), ray_fixed_dt and S samples of z, dt and mask
// (9 bytes each); the arithmetic is ~20 operations per sample and ~36 per
// ray for the intersection.
//
// Design: one thread per sample slot, neighbouring threads on neighbouring
// slots of one ray, so the [R, S] stores are coalesced. Each thread forms
// its ray's scalars itself (a few operations, cheaper than a pass of its
// own): the ray's intersection with the sphere (its origin and direction
// read through the read-only cache, which the ray's threads share), the
// count nr = clamp(int(dist / min_dist), 0, S) and the spacing dt_ray =
// dist / nr taken from it, then the discard of rays with <= 2 samples (so
// ray_fixed_dt reads the count after the discard, dt_ray the one before),
// the start t_entry + u dt_ray with the per-ray jitter u in [0, 1) (0
// without), z clipped to [t_entry, t_exit], and the last valid sample's dt
// the distance left to t_exit, clamped to [0, dt_ray]. The plain
// intersection's ~33 elementwise launches and its copy of the sphere's
// centre to the card go. A block row a ray (2-D blocks, no thread divides
// an index) and four slots a thread (16-byte stores) measured within 4% of
// this mapping alone and no faster in the step (profiling/c2_variants.cu;
// PERF.md §6). The float operations are the plain version's
// (`samples_fg_sphere_plain`), in its order: each sum over the three axes
// is (x + y) + z; division and square root are IEEE (nvcc's defaults), and
// --fmad=false keeps every product rounded, so the two agree bit for bit.
#include "common.cuh"

namespace {

// A ray's uniform samples: its range, spacing, start and count.
struct FgRay {
  float t0, t1, dt_ray, base;
  int nr;
};

__device__ __forceinline__ FgRay fg_ray(float t0, float t1, const float* __restrict__ start,
                                        long long r, float min_dist, int S) {
  FgRay q;
  q.t0 = t0;
  q.t1 = t1;
  const float dist = t1 - t0;
  const float c = dist / min_dist;
  // int32 truncation, then clamp to [0, S] (a NaN count is 0)
  int nr = !(c > 0.f) ? 0 : (c >= (float)S ? S : (int)c);
  q.dt_ray = nr > 0 ? dist / (float)max(nr, 1) : 0.f;
  q.nr = nr <= 2 ? 0 : nr;  // the reference's discard rule
  q.base = t0 + (start != nullptr ? start[r] * q.dt_ray : 0.f);
  return q;
}

// Slot s of the ray: z, dt and mask.
__device__ __forceinline__ void fg_slot(const FgRay& q, int s, float* z, float* dt,
                                        uint8_t* mask) {
  const bool valid = s < q.nr;
  float d = valid ? q.dt_ray : 0.f;
  const int last = max(q.nr - 1, 0);
  if (valid && s == last) {
    const float z_last = fminf(fmaxf(q.base + (float)last * q.dt_ray, q.t0), q.t1);
    d = fminf(fmaxf(q.t1 - z_last, 0.f), q.dt_ray);
  }
  *z = valid ? fminf(fmaxf(q.base + (float)s * q.dt_ray, q.t0), q.t1) : 0.f;
  *dt = d;
  *mask = valid ? 1 : 0;
}

// Ray r against the sphere (centre c, radius^2 r2), as
// Sphere.ray_intersection: -> does_intersect, with t_entry (clamped to >=
// 0) and t_exit, both 0 for a ray that misses.
__device__ __forceinline__ bool sphere_span(const float* __restrict__ o,
                                            const float* __restrict__ d, long long r,
                                            float cx, float cy, float cz, float r2,
                                            float* t_entry, float* t_exit) {
  const float ox = __ldg(o + 3 * r) - cx, oy = __ldg(o + 3 * r + 1) - cy,
              oz = __ldg(o + 3 * r + 2) - cz;
  const float dx = __ldg(d + 3 * r), dy = __ldg(d + 3 * r + 1), dz = __ldg(d + 3 * r + 2);
  const float a = (dx * dx + dy * dy) + dz * dz;
  const float b = 2.f * ((ox * dx + oy * dy) + oz * dz);
  const float c = ((ox * ox + oy * oy) + oz * oz) - r2;
  const float disc = b * b - 4.f * a * c;
  const float sq = sqrtf(fabsf(disc));
  const bool hit = disc >= 0.f;
  const float t0 = hit ? (-b - sq) / (2.f * a) : 0.f;
  *t_entry = t0 < 0.f ? 0.f : t0;  // a NaN stays, as torch.clamp keeps it
  *t_exit = hit ? (-b + sq) / (2.f * a) : 0.f;
  return hit;
}

// Thread i takes slot i % S of ray i / S; the ray's slot 0 also writes its
// per-ray outputs.
__global__ void __launch_bounds__(256) samples_fg_kernel(
    long long n, int S, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ start, float cx, float cy, float cz, float r2, float min_dist,
    float* __restrict__ z, float* __restrict__ dt, uint8_t* __restrict__ mask,
    float* __restrict__ ray_fixed_dt, float* __restrict__ t_entry,
    float* __restrict__ t_exit, uint8_t* __restrict__ does_intersect) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = i / S;
  const int s = (int)(i - r * S);
  float t0, t1;
  const bool hit = sphere_span(origins, dirs, r, cx, cy, cz, r2, &t0, &t1);
  const FgRay q = fg_ray(t0, t1, start, r, min_dist, S);
  fg_slot(q, s, z + i, dt + i, mask + i);
  if (s == 0) {
    ray_fixed_dt[r] = q.nr > 0 ? q.dt_ray : 0.f;
    t_entry[r] = t0;
    t_exit[r] = t1;
    does_intersect[r] = hit ? 1 : 0;
  }
}

}  // namespace

// origins, dirs [R, 3], the sphere's centre and radius^2 -> z, dt, mask
// [R, S], ray_fixed_dt, t_entry, t_exit, does_intersect [R], in one launch
// (none for R = 0).
extern "C" int psdf_samples_fg(int R, int S, const void* origins, const void* dirs,
                               const void* start, float cx, float cy, float cz, float r2,
                               float min_dist, void* z, void* dt, void* mask,
                               void* ray_fixed_dt, void* t_entry, void* t_exit,
                               void* does_intersect, void* stream) {
  if (S <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * S;
  if (n == 0) return (int)cudaSuccess;
  PSDF_LAUNCH(samples_fg_kernel, psdf_blocks(n, 256), 256, 0, stream, n, S,
              (const float*)origins, (const float*)dirs, (const float*)start, cx, cy, cz, r2,
              min_dist, (float*)z, (float*)dt, (uint8_t*)mask, (float*)ray_fixed_dt,
              (float*)t_entry, (float*)t_exit, (uint8_t*)does_intersect);
  return (int)cudaGetLastError();
}
