// Kernel C: sample placement through the occupied voxels of a ray.
// Kernel C3: the first occupied probe segment of a ray (the plain sphere
// tracers' seed).
// Kernel I: the occupancy refresh from SDF probes.
// Kernel I2: the occupancy refresh from density probes (NeRF).
//
// Replaces: permuto_sdf_tpu/ops/occupancy_grid.py:226
// `compute_samples_in_occupied_regions` (with `_probe_occupancy` :212) --
// kernel C --, :367 `compute_first_sample_start_of_occupied_regions` (with
// the same `_probe_occupancy`) -- kernel C3 --, :138
// `compute_stratified_sample_of_grid_points` with :179
// `update_with_sdf_random_sample` -- kernel I, two entry points around the
// SDF evaluation of the probes -- and :193
// `update_with_density_random_sample` -- kernel I2, after the density
// evaluation of the same probes. The JAX package leaves them to XLA.
//
// What bounds C on an H100: bytes and latency of the probes. Each ray
// reads P = 512 one-byte voxels of the 16.8 MB bool grid at positions that
// step along the ray (mostly distinct 32-byte sectors), and writes 64
// samples of z, dt and mask; at the exact frame's chunk (R = 2048 rays, one
// warp each) the launch fills a quarter of the card's warp slots, so C's
// time is one warp's chain: its loads, three IEEE divisions per probe, the
// scan and the placement. C3 needs the same probes up to the first
// occupied one and writes 5 bytes per ray; it reads a voxel's byte only
// where the distance field cannot rule a run of probes out, so its time is
// the warp's chain of rounds and their probes' arithmetic. I and I2 are
// bound by the scattered accesses: each of the n probes writes (I2: reads
// and writes) a 4-byte value and a 1-byte flag at a voxel far from its
// neighbours' (a 32-byte sector each).
//
// Design of C: one warp per ray, probing in rounds of 32 (lane k takes probe
// 32 j + k, so one load instruction reads 32 neighbouring probes; at
// P = 512, a template case, all 16 loads of a lane are issued before any is
// used, other multiples of 32 up to 1024 loop over the rounds). Round j's
// ballot is the occupancy of probes 32 j .. 32 j + 31; lane j keeps it, and
// a warp scan of the ballots' popcounts gives each round's occupied counts
// (cum = count * seg_len with one rounding, as in the plain version). A
// sample at arc length `arc` lies at the c-th occupied probe, c the smallest
// count with c * seg_len > arc (searchsorted side="right": cum is monotone
// in the count), found from floor(arc / seg_len) by +-1 steps of the same
// float product; its round is the first lane whose inclusive count reaches
// c (five shuffles), and the probe is that round's (c - exclusive count)-th
// set bit (__fns). No shared memory and no binary search over P counts
// remain. Past the last occupied probe the index is clamped to P - 1, as in
// the plain version. Rules kept from the JAX op: rays with <= 2 samples are
// zeroed, the start offset is the per-ray jitter in [0, 1) (0.5 without
// jitter), and the last valid sample's dt is clamped to the distance left
// to t_exit. It replaced a design with lane k probing the contiguous run
// [16 k, 16 k + 16), so each load instruction touched 32 sectors, the counts
// in 2 KB of shared memory per warp and a ~10-step binary search per
// sample: 0.0137 device ms at R = 2048 against the new 0.0073 (NVIDIA H100
// 80GB HBM3, 700 W, profiling/torch_encode_paths.py --paths grid).
//
// Design of C3: one warp per ray, two passes over the grid's Chebyshev
// distance field (kernel J0's, which the plain sphere tracers build for
// the same grid state, and pass to C3). Every float operation of the
// probe's voxel (`probe_ijk`, the helper kernel C uses, so the two index
// the grid identically) is monotone in the probe index, so along a ray each
// axis's voxel index is monotone, and the probes between two probes lie in
// the box of voxels that the two span. Pass 1 gives each lane a span of 16
// probes (512 a round): one probe's voxel a lane, its neighbour's end by a
// shuffle. A start voxel at field distance k > 0 has no occupied voxel
// within L-inf distance k - 1, and every voxel of the box lies within the
// box's largest side of the start, so a span whose end is within k - 1 of
// its start on every axis is empty (a span starting outside the grid is
// empty where its box misses the grid). Pass 2 walks the other spans in
// order, two a round (half a warp each), each probe reading its voxel's
// byte. The first occupied probe is the one-level probe's, bit for bit,
// whatever the field's cap; a ray through empty space computes 32 probes,
// not 512. The seed is the start of the first occupied segment,
// t_entry + first * seg_len, or t_exit without one. It replaced the same
// warp probing and reading the byte grid at every probe in rounds of 32
// (mostly one 32-byte sector each): 0.0168 device ms at the plain frame's
// 8,192-ray chunk and 0.252 at R = 160,000; and a design whose pass 1 read
// a coarse grid (a byte per 8^3 block, built once per grid state): 0.0065
// and 0.059 (NVIDIA H100 80GB HBM3, 700 W, profiling/torch_encode_paths.py
// --paths plain, profiling/c3_designs.py).
//
// Design of I and I2: one thread per probe. The voxel of probe i of update
// k is lin = (a (k n + i) + b) mod 2^m in uint32 with a and b odd (a Weyl
// map): a bijection of the voxel ids, so no two probes of one update share
// a voxel and the update needs no atomics. I2 reads the old value and
// writes the new one at the same voxel; with distinct ids no thread reads
// a voxel another thread writes, so the launch computes exactly the JAX
// op's gather of the old values followed by its scatter. Ids that repeat
// within one launch are not supported (the JAX op's result would then
// depend on the scatter order as well).
#include "common.cuh"

namespace {

// The voxel (ix, iy, iz) of probe p of P along the ray o + t d, t in
// [te, t1], in the V^3 grid, and whether it lies inside the grid: the
// probe's midpoint t = te + ((p + 0.5) / P) (t1 - te) and its voxel index,
// in the float order of the JAX op. kPow2: P and the voxel size are powers
// of two and the divisions by them are products by their reciprocals
// inv_P and inv_vs, which are then exact: the same quotients, bit for bit,
// for a fraction of an IEEE division's instructions.
template <bool kPow2 = false>
__device__ __forceinline__ bool probe_ijk(
    int V, float half_extent, float tx, float ty, float tz, float voxel_size,
    float ox, float oy, float oz, float dx, float dy, float dz, float te,
    float t1, int p, int P, int& ix, int& iy, int& iz, float inv_P = 0.0f,
    float inv_vs = 0.0f) {
  float frac, qx, qy, qz;
  if constexpr (kPow2) {
    frac = ((float)p + 0.5f) * inv_P;
  } else {
    frac = ((float)p + 0.5f) / (float)P;
  }
  const float ts = te + frac * (t1 - te);
  const float px = ox + ts * dx, py = oy + ts * dy, pz = oz + ts * dz;
  if constexpr (kPow2) {
    qx = ((px - tx) + half_extent) * inv_vs;
    qy = ((py - ty) + half_extent) * inv_vs;
    qz = ((pz - tz) + half_extent) * inv_vs;
  } else {
    qx = ((px - tx) + half_extent) / voxel_size;
    qy = ((py - ty) + half_extent) / voxel_size;
    qz = ((pz - tz) + half_extent) / voxel_size;
  }
  ix = (int)floorf(qx);
  iy = (int)floorf(qy);
  iz = (int)floorf(qz);
  return ix >= 0 && ix < V && iy >= 0 && iy < V && iz >= 0 && iz < V;
}

// The linear voxel index of probe p, or -1 outside the grid.
__device__ __forceinline__ long long probe_voxel(
    int V, float half_extent, float tx, float ty, float tz, float voxel_size,
    float ox, float oy, float oz, float dx, float dy, float dz, float te,
    float t1, int p, int P) {
  int ix, iy, iz;
  const bool inb = probe_ijk(V, half_extent, tx, ty, tz, voxel_size, ox, oy,
                             oz, dx, dy, dz, te, t1, p, P, ix, iy, iz);
  return inb ? ((long long)ix * V + iy) * V + iz : -1;
}

// Whether probe p lies in an occupied voxel (points outside the grid are
// empty).
__device__ __forceinline__ bool probe_occupied(
    const uint8_t* __restrict__ occ, int V, float half_extent, float tx,
    float ty, float tz, float voxel_size, float ox, float oy, float oz,
    float dx, float dy, float dz, float te, float t1, int p, int P) {
  const long long v = probe_voxel(V, half_extent, tx, ty, tz, voxel_size, ox,
                                  oy, oz, dx, dy, dz, te, t1, p, P);
  return v >= 0 && occ[v] != 0;
}

// Kernel C for NJ rounds of 32 probes (P = 32 NJ; NJ = 0: P / 32 rounds at
// run time, at most 32). One warp per ray.
template <int NJ>
__global__ void __launch_bounds__(128) probe_sampler_kernel(
    int R, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_entry, const float* __restrict__ t_exit,
    const float* __restrict__ start, const uint8_t* __restrict__ occ, int V,
    float half_extent, float tx, float ty, float tz, float voxel_size,
    float min_dist, int S, int P_run, float* __restrict__ z,
    float* __restrict__ dt, uint8_t* __restrict__ mask,
    float* __restrict__ ray_fixed_dt) {
  const int P = NJ > 0 ? 32 * NJ : P_run;
  const int nj = P / 32;
  const int lane = threadIdx.x & 31;
  const long long ray =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // whole warps leave together; no block barrier below

  const float ox = origins[ray * 3 + 0], oy = origins[ray * 3 + 1],
              oz = origins[ray * 3 + 2];
  const float dx = dirs[ray * 3 + 0], dy = dirs[ray * 3 + 1],
              dz = dirs[ray * 3 + 2];
  const float te = t_entry[ray];
  const float tx1 = t_exit[ray];
  const float st = (start != nullptr) ? start[ray] : 0.5f;

  // Round j is probes 32 j .. 32 j + 31, lane k taking probe 32 j + k: one
  // load instruction reads 32 neighbouring probes. Lane j keeps round j's
  // ballot.
  unsigned bal = 0;
  if constexpr (NJ > 0) {
    long long vox[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      vox[j] = probe_voxel(V, half_extent, tx, ty, tz, voxel_size, ox, oy, oz,
                           dx, dy, dz, te, tx1, 32 * j + lane, P);
    uint8_t o[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[j] = vox[j] >= 0 ? occ[vox[j]] : 0;  // all in flight
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const unsigned b = __ballot_sync(PSDF_FULL_MASK, o[j] != 0);
      if (lane == j) bal = b;
    }
  } else {
    for (int j = 0; j < nj; ++j) {
      const unsigned b = __ballot_sync(
          PSDF_FULL_MASK,
          probe_occupied(occ, V, half_extent, tx, ty, tz, voxel_size, ox, oy,
                         oz, dx, dy, dz, te, tx1, 32 * j + lane, P));
      if (lane == j) bal = b;
    }
  }
  // Occupied counts: lane j's inclusive and exclusive count of rounds 0..j
  // (lanes past the last round hold the total).
  const int pc = __popc(bal);
  int incl = pc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  const int excl = incl - pc;
  const int total = __shfl_sync(PSDF_FULL_MASK, incl, 31);
  // the count up to probe P - 2 (cum_before of a sample past the last probe)
  const int before_last =
      total - (int)(__shfl_sync(PSDF_FULL_MASK, bal, nj - 1) >> 31);

  const float seg_len = (tx1 - te) / (float)P;
  const float occupied_dist = (float)total * seg_len;
  int nr = (int)floorf(occupied_dist / min_dist);
  nr = min(max(nr, 0), S);
  if (nr <= 2) nr = 0;
  const float dt_ray = nr > 0 ? occupied_dist / (float)max(nr, 1) : 0.f;

  for (int base = 0; base < S; base += 32) {  // warp-uniform: all lanes shuffle
    const int s = base + lane;
    const bool valid = s < nr;
    const float arc = ((float)s + st) * dt_ray;
    // searchsorted(cum, arc, side="right") over cum = count * seg_len, which
    // is monotone in the count: the sample lies at the c-th occupied probe,
    // c the smallest count with c * seg_len > arc (the same float product).
    int c = 0;
    if (valid) {
      c = (int)fminf(fmaxf(floorf(arc / seg_len), 0.f), (float)(total + 1));
      while (c > 0 && (float)(c - 1) * seg_len > arc) --c;
      while (c <= total && (float)c * seg_len <= arc) ++c;
    }
    // its round: the first lane whose inclusive count reaches c
    int j = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(PSDF_FULL_MASK, incl, j + step - 1) < c) j += step;
    const unsigned bj = __shfl_sync(PSDF_FULL_MASK, bal, j);
    const int ej = __shfl_sync(PSDF_FULL_MASK, excl, j);
    if (s >= S) continue;
    float zz = 0.f, d = 0.f;
    if (valid) {
      int idx;
      float cum_before;
      if (c > total) {  // past the last occupied probe: clamped to P - 1
        idx = P - 1;
        cum_before = (float)before_last * seg_len;
      } else if (c == 0) {
        idx = 0;
        cum_before = 0.f;
      } else {
        idx = 32 * j + (int)__fns(bj, 0, c - ej);
        cum_before = idx > 0 ? (float)(c - 1) * seg_len : 0.f;
      }
      const float into = fminf(fmaxf(arc - cum_before, 0.f), seg_len);
      zz = (te + (float)idx * seg_len) + into;
      d = s == nr - 1 ? fminf(fmaxf(tx1 - zz, 0.f), dt_ray) : dt_ray;
    }
    z[ray * S + s] = zz;
    dt[ray * S + s] = d;
    mask[ray * S + s] = valid ? 1 : 0;
  }
  if (lane == 0) ray_fixed_dt[ray] = nr > 0 ? dt_ray : 0.f;
}

// C3's spans: pass 1 tests runs of kSpan probes at once.
constexpr int kSpan = 16;  // half a warp: pass 2 probes two spans a round
static_assert(kSpan == 16, "pass 2 gives each span half a warp");

// Kernel C3: per ray, the start of the first occupied probe segment and
// whether there is one (t_exit without one), runs of probes ruled out by
// the grid's distance field `field`. kPow2: see probe_ijk.
template <bool kPow2>
__global__ void __launch_bounds__(128) first_occupied_kernel(
    int R, const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_entry, const float* __restrict__ t_exit,
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ field,
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
  int first = -1;
  for (int base = 0; base < P && first < 0; base += 32 * kSpan) {  // warp-uniform
    // pass 1: lane l tests span s = base / kSpan + l, probes [a, b] with
    // b = a + kSpan (the next span's first probe) or P - 1
    const int a = base + kSpan * lane;
    int ix, iy, iz;
    const bool a_in = probe_ijk<kPow2>(V, half_extent, tx, ty, tz, voxel_size,
                                       ox, oy, oz, dx, dy, dz, te, t1,
                                       min(a, P - 1), P, ix, iy, iz, inv_P,
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
      if (a_in) {
        const int k = field[((long long)ix * V + iy) * V + iz];
        const int reach = max(max(abs(jx - ix), abs(jy - iy)), abs(jz - iz));
        maybe = k == 0 || reach > k - 1;
      } else {
        maybe = max(min(ix, jx), 0) <= min(max(ix, jx), V - 1) &&
                max(min(iy, jy), 0) <= min(max(iy, jy), V - 1) &&
                max(min(iz, jz), 0) <= min(max(iz, jz), V - 1);
      }
    }
    unsigned spans = __ballot_sync(PSDF_FULL_MASK, maybe);
    // pass 2: the flagged spans in order, two a round (half a warp each)
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

// Kernel I2: at the probes' (distinct) voxels, value = max(density,
// old * decay) and occupied = value > thresh. A NaN on either side gives a
// NaN value, as jnp.maximum does.
__global__ void __launch_bounds__(256) density_update_kernel(
    int n, const int* __restrict__ lin, const float* __restrict__ density,
    float decay, float thresh, float* __restrict__ values,
    uint8_t* __restrict__ occupancy) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int at = lin[k];
  const float d = density[k];
  const float old = values[at] * decay;
  const float v = (d != d || old != old) ? d + old : fmaxf(d, old);
  values[at] = v;
  occupancy[at] = v > thresh ? 1 : 0;
}

}  // namespace

extern "C" int psdf_probe_sampler(int R, const void* origins, const void* dirs,
                                  const void* t_entry, const void* t_exit,
                                  const void* start, const void* occ, int V,
                                  float half_extent, float tx, float ty,
                                  float tz, float voxel_size, float min_dist, int S,
                                  int P, void* z, void* dt, void* mask,
                                  void* ray_fixed_dt, void* stream) {
  if (P <= 0 || P > 1024 || P % 32 != 0) return (int)cudaErrorInvalidValue;
  const int block = 128;  // 4 rays per block
  const int grid = psdf_blocks((long long)R * 32, block);
  if (grid == 0) return 0;
#define PSDF_PROBE_SAMPLER_ARGS                                              \
  R, (const float*)origins, (const float*)dirs, (const float*)t_entry,       \
      (const float*)t_exit, (const float*)start, (const uint8_t*)occ, V,     \
      half_extent, tx, ty, tz, voxel_size, min_dist, S, P, (float*)z,        \
      (float*)dt, (uint8_t*)mask, (float*)ray_fixed_dt
  if (P == 512)
    PSDF_LAUNCH(probe_sampler_kernel<16>, grid, block, 0, stream,
                PSDF_PROBE_SAMPLER_ARGS);
  else
    PSDF_LAUNCH(probe_sampler_kernel<0>, grid, block, 0, stream,
                PSDF_PROBE_SAMPLER_ARGS);
#undef PSDF_PROBE_SAMPLER_ARGS
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

extern "C" int psdf_first_occupied(int R, const void* origins, const void* dirs,
                                   const void* t_entry, const void* t_exit,
                                   const void* occ, const void* field, int V,
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
#define PSDF_FIRST_OCCUPIED_ARGS                                              \
  R, (const float*)origins, (const float*)dirs, (const float*)t_entry,        \
      (const float*)t_exit, (const uint8_t*)occ, (const uint8_t*)field, V,    \
      half_extent, tx, ty, tz, voxel_size, P, 1.0f / (float)P,                \
      ldexpf(1.0f, 1 - e), (float*)t_first, (uint8_t*)has
  if (pow2)
    PSDF_LAUNCH(first_occupied_kernel<true>, grid, block, 0, stream,
                PSDF_FIRST_OCCUPIED_ARGS);
  else
    PSDF_LAUNCH(first_occupied_kernel<false>, grid, block, 0, stream,
                PSDF_FIRST_OCCUPIED_ARGS);
#undef PSDF_FIRST_OCCUPIED_ARGS
  return (int)cudaGetLastError();
}

extern "C" int psdf_density_update(int n, const void* lin, const void* density,
                                   float decay, float thresh, void* values,
                                   void* occupancy, void* stream) {
  const int block = 256;
  const int grid = psdf_blocks(n, block);
  if (grid == 0) return 0;
  PSDF_LAUNCH(density_update_kernel, grid, block, 0, stream, n,
              (const int*)lin, (const float*)density, decay, thresh,
              (float*)values, (uint8_t*)occupancy);
  return (int)cudaGetLastError();
}
