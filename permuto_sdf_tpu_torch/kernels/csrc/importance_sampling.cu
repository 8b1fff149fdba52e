// Kernels E1 and E2: the SDF-guided importance stage of the volumetric
// renderer and the trainer.
//
// Replaces: permuto_sdf_tpu/ops/importance_sampling.py:38
// (`importance_sampling_sdf_model`), which runs two rounds of
// `_weights_cdf` (:26: `sdf2alpha_sectional`, volume_rendering.py:113, the
// exclusive transmittance, the normalized weights and `compute_cdf`, :95)
// and `importance_sample` (volume_rendering.py:242), each followed by
// `combine_uniform_samples_with_imp` (volume_rendering.py:294). XLA runs
// them as some thirty fused elementwise, scan, sort and gather ops per round;
// eager PyTorch dispatched ~300 ops per call.
//
// E1 (round 1): z, dt [R,S] f32, mask [R,S] bool (a prefix mask), the
// ray's uniform spacing fixed_dt [R], the samples' sdf [R,S], the stratum
// jitter [R,n] or null and the inv_s multiplier -> z_imp [R,n], mask_imp
// [R,n]. E2 (the merge, and round 2): two sample sets of one ray batch
// (their sdf, or none), t_exit [R] and fixed_dt -> z, dt, mask[, sdf] at
// S1 + S2 slots, in the order of a stable argsort of z with +inf at the
// invalid slots. E2 has three forms: (a) the merge alone; (b) the merge,
// then round 2 drawn from the merged ray (the sdf of both sets needed),
// returning the merged set and the draws; (c) as (b), then the draws
// merged in at once: z, dt, mask at S1 + S2 + n slots, no sdf.
//
// What bounds them on an H100: bytes. E1 reads 13 bytes per sample and
// writes 5 per drawn sample. E2 reads 9 (13 with sdf) bytes per input slot
// and writes 9 (13 with sdf) per merged slot: form (b) adds 5 written per
// draw, form (c) writes 9 per slot of the final set and not the first
// merge. The arithmetic is a few tens of operations per sample, and the
// merge ~log2(S) comparisons per slot.
//
// Design: one warp per ray, four rays per block; each ray's rows are
// staged in shared memory at once with asynchronous copies (cp.async, 16
// or 4 bytes as the rows' alignment allows), and stored back from shared
// memory in the widest units the same way. E1's
// round is a device function on such a staged ray (`importance_draw`):
// each lane owns a contiguous run of samples and forms their section
// alphas, its run's product of transmittance factors P and its weights'
// sum W from the run's start. One warp scan of the pairs (P, W) under
// (P1, W1) o (P2, W2) = (P1 P2, W1 + P1 W2), in double, gives each run its
// starting transmittance, the weights before it and the weight sum, from
// which each lane writes its exclusive CDF (the plain version's CPU cumsum
// and cumprod accumulate in double too). It replaced an exclusive product
// scan, a reduction of the weight sum and a sum scan of the normalized
// weights (three chains of five shuffle levels): 0.00664 device ms a
// launch on the exact frame (R = 2048, S = 64, n = 16; NVIDIA H100 80GB
// HBM3, 700 W, profiling/torch_encode_paths.py). The CDF stays in shared
// memory and each lane inverts it at its strata with the upper-bound
// binary search that `torch.searchsorted(right=True)` does. E2 keys both
// sets (+inf at the invalid slots) in shared memory and checks with one
// warp ballot whether each set is ascending. Where both are (every caller
// passes such sets: kernel C's samples, E1's draws, E2's own output), an
// element's slot is its index in its own set plus a binary search of the
// other set (the set-2 keys below it for set 1, the set-1 keys at or
// below it for set 2): the stable sort's position in ~log2(S) compares.
// Elsewhere the slot is the element's rank by a count over all S keys,
// the same position. z, the mask, the sdf and dt go to shared memory in
// slot order; form (b) and (c) run E1's round on that ray and (c) merges
// its draws in the same way, so a chunk's importance stage is E1 and one
// E2 (the eval render and the reference step), or E1 and two E2 (the
// train-time LOD step, which evaluates the draws' sdf in between).
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(PSDF_FULL_MASK, (unsigned)v);
}

// Exclusive scan of the runs' pairs (P, W) over the lanes under
// (P1, W1) o (P2, W2) = (P1 P2, W1 + P1 W2): P a run's product of
// transmittance factors, W its weights' sum relative to its start. Returns
// each run's starting transmittance in P and the weights before it in W,
// and the inclusive W of the last lane (the ray's weight sum).
__device__ __forceinline__ double warp_pair_scan(double& P, double& W) {
  const int lane = threadIdx.x & 31;
  double p = P, w = W;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double yp = __shfl_up_sync(PSDF_FULL_MASK, p, off);
    const double yw = __shfl_up_sync(PSDF_FULL_MASK, w, off);
    if (lane >= off) {
      w = yw + yp * w;
      p = yp * p;
    }
  }
  const double xp = __shfl_up_sync(PSDF_FULL_MASK, p, 1);
  const double xw = __shfl_up_sync(PSDF_FULL_MASK, w, 1);
  P = lane == 0 ? 1.0 : xp;
  W = lane == 0 ? 0.0 : xw;
  return __shfl_sync(PSDF_FULL_MASK, w, 31);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The index of the first entry of cdf[0:S) greater than u
// (`searchsorted(side="right")`), +inf at the invalid slots i >= nr.
__device__ __forceinline__ int upper_bound(const float* cdf, int S, int nr, float u) {
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const float v = mid < nr ? cdf[mid] : INFINITY;
    if (!(v > u)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The count of the entries of the ascending a[0:n) below k (`or_equal`:
// at or below k).
__device__ __forceinline__ int count_below(const float* a, int n, float k, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const float v = a[mid];
    if (v < k || (or_equal && v == k)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One importance round (kernel E1's body) on a ray staged in shared
// memory: z, sdf, dt and the mask bytes of its S slots, nr valid; sw is S
// floats of scratch. Writes the n draws to z_out (global or shared memory;
// 0 where the ray has no valid sample).
__device__ void importance_draw(int S, int n, int nr, const float* sz, const float* ssdf,
                                const float* sdt, const uint8_t* smask, float* sw,
                                float fixed_dt, const float* jitter, float inv_s_mult,
                                float* z_out) {
  const int lane = threadIdx.x & 31;
  // the ray's inv_s: map_range_val(fixed_dt, 1e-4, 1e-2, 1024, 64) * multiplier
  const float x = fminf(fmaxf(fixed_dt, (float)1e-4), (float)1e-2);
  const float k = (float)((64.0 - 1024.0) / (0.01 - 0.0001));
  const float s = (1024.0f + k * (x - (float)1e-4)) * inv_s_mult;

  // this lane's run of samples [i0, i1)
  const int per = (S + 31) / 32;
  const int i0 = min(lane * per, S), i1 = min(i0 + per, S);

  // section alphas (0 at the last valid sample and the invalid ones) and
  // this run's pair: the product of its transmittance factors, and its
  // weights alpha_i prod_{j<i} t_j from the run's start
  double P = 1.0, W = 0.0;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {  // unrolled: the run's alphas overlap
    const bool valid = smask[i] != 0;
    float alpha = 0.0f;
    if (valid && i < nr - 1) {
      const float a = ssdf[i], b = ssdf[i + 1], d = sdt[i];
      const float mid = (a + b) * 0.5f;
      const float cosv = fminf(fmaxf((b - a) / fmaxf(d, (float)1e-6), -1e3f), 0.0f);
      const float prev_cdf = sigmoid((mid - cosv * d * 0.5f) * s);
      const float next_cdf = sigmoid((mid + cosv * d * 0.5f) * s);
      alpha = fminf(fmaxf((prev_cdf - next_cdf + (float)1e-6) / (prev_cdf + (float)1e-6), 0.0f),
                    1.0f);
    }
    sw[i] = alpha;
    if (valid) {
      W += (double)alpha * P;
      P *= (double)(1.0f - alpha + (float)1e-7);
    }
  }

  // one scan: each run's starting transmittance T, the weights before it,
  // and the weight sum; then the exclusive CDF of the normalized weights
  double T = P, acc = W;
  const double wsum = warp_pair_scan(T, acc);
  const float norm = fmaxf((float)wsum, (float)1e-6);
  const double inv_norm = 1.0 / (double)norm;
  for (int i = i0; i < i1; ++i) {
    const bool valid = smask[i] != 0;
    const float alpha = sw[i];
    sw[i] = valid ? (float)(acc * inv_norm) : 0.0f;
    if (valid) {
      acc += (double)alpha * T;
      T *= (double)(1.0f - alpha + (float)1e-7);
    }
  }
  __syncwarp();

  // invert the CDF at the strata (i + 1) / (n + 1), moved by the jitter
#pragma unroll 2
  for (int j = lane; j < n; j += 32) {
    float u = ((float)j + 1.0f) / (float)(n + 1);
    if (jitter != nullptr) u = u + jitter[j];
    u = fminf(fmaxf(u, (float)1e-6), (float)(1.0 - 1e-5));
    const int imax = min(max(upper_bound(sw, S, nr, u), 1), max(nr - 1, 1));
    const int imin = imax - 1;
    const float cdf_min = sw[imin], cdf_max = sw[imax];
    const float z_min = sz[imin], z_max = sz[imax];
    const float diff = cdf_max - cdf_min;
    const float denom = fabsf(diff) < (float)1e-12 ? (float)1e-12 : diff;
    float zi = z_min + (u - cdf_min) / denom * (z_max - z_min);
    const float to_min = zi - z_min, to_max = z_max - zi;
    zi = to_min < to_max ? z_min + fminf(to_min, fixed_dt) : z_max - fminf(to_max, fixed_dt);
    z_out[j] = nr > 0 ? zi : 0.0f;
  }
}

// The merge of the two sets staged as key[0:S1) and key[S1:S1+S2) (+inf
// at the invalid slots; valid[e] their mask bytes): writes z (0 at the
// invalid slots), the mask and, when sv is set, the values sv into zs, ms
// and fs in the order of a stable argsort of the keys, then dt into ds.
// Returns the count of valid slots.
__device__ int merge_staged(int S1, int S2, const float* key, const uint8_t* valid,
                            const float* sv, float fixed_dt, float t_exit, float* zs,
                            uint8_t* ms, float* fs, float* ds) {
  const int lane = threadIdx.x & 31;
  const int S = S1 + S2;
  // are both sets ascending (no NaN)? then binary searches place them
  bool unsorted = false;
  int cnt = 0;
  for (int e = lane; e < S; e += 32) {
    const float k = key[e];
    const bool set_end = e == S1 - 1 || e == S - 1;
    unsorted |= !(k == k) || (!set_end && !(k <= key[e + 1]));
    cnt += valid[e] != 0;
  }
  const bool sorted = __ballot_sync(PSDF_FULL_MASK, unsorted) == 0;
  const int nr = warp_sum(cnt);
#pragma unroll 4
  for (int e = lane; e < S; e += 32) {  // unrolled: the searches overlap
    const float k = key[e];
    int slot;
    if (sorted) {
      slot = e < S1 ? e + count_below(key + S1, S2, k, false)
                    : e - S1 + count_below(key, S1, k, true);
    } else {  // the rank: the keys below k, and the equal ones earlier
      slot = 0;
      for (int j = 0; j < S; ++j) {
        const float kj = key[j];
        slot += (kj < k) || (kj == k && j < e);
      }
    }
    const bool v = valid[e] != 0;
    zs[slot] = v ? k : 0.0f;
    ms[slot] = v;
    if (sv != nullptr) fs[slot] = sv[e];
  }
  __syncwarp();
  for (int i = lane; i < S; i += 32) {
    float d = 0.0f;
    if (i < nr - 1) d = fminf(zs[i + 1] - zs[i], fixed_dt);
    else if (i == nr - 1) d = fminf(fmaxf(t_exit - zs[i], 0.0f), fixed_dt);
    ds[i] = d;
  }
  __syncwarp();
  return nr;
}

__global__ void __launch_bounds__(kThreads) importance_round_kernel(
    int R, int S, int n, const float* __restrict__ z, const float* __restrict__ dt,
    const uint8_t* __restrict__ mask, const float* __restrict__ fixed_dt,
    const float* __restrict__ sdf, const float* __restrict__ jitter, float inv_s_mult,
    float* __restrict__ z_imp, uint8_t* __restrict__ mask_imp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= R) return;  // the whole warp leaves together; no block barrier follows
  const int P = psdf_pad4(S);
  float* sz = psdf_dynamic_smem<float>() + (size_t)warp * (4 * P + psdf_pad16(S) / 4);
  float* ssdf = sz + P;
  float* sdt = ssdf + P;
  float* sw = sdt + P;
  uint8_t* smask = reinterpret_cast<uint8_t*>(sw + P);
  const long long row = (long long)r * S;
  psdf_warp_stage(sz, z + row, S * 4);
  psdf_warp_stage(ssdf, sdf + row, S * 4);
  psdf_warp_stage(sdt, dt + row, S * 4);
  psdf_warp_stage(smask, mask + row, S);
  psdf_stage_wait();
  int cnt = 0;
  for (int i = lane; i < S; i += 32) cnt += smask[i] != 0;
  const int nr = warp_sum(cnt);
  importance_draw(S, n, nr, sz, ssdf, sdt, smask, sw, fixed_dt[r],
                  jitter != nullptr ? jitter + (long long)r * n : nullptr, inv_s_mult,
                  z_imp + (long long)r * n);
  for (int j = lane; j < n; j += 32) mask_imp[(long long)r * n + j] = nr > 0;
}

// Shared memory of one E2 warp, in floats: key, z, dt and the mask bytes
// at T = S1 + S2 (+ n in form c) slots, the values staged, the values in
// slot order and E1's scratch at S1 + S2, and the valid bytes at T.
__host__ __device__ inline size_t merge_warp_floats(int S, int T) {
  return 3 * (size_t)psdf_pad4(T) + 3 * (size_t)psdf_pad4(S) + 2 * (size_t)psdf_pad16(T) / 4;
}

__global__ void __launch_bounds__(kThreads) merge_samples_kernel(
    int R, int S1, int S2, int n, const float* __restrict__ z1, const uint8_t* __restrict__ m1,
    const float* __restrict__ sdf1, const float* __restrict__ z2,
    const uint8_t* __restrict__ m2, const float* __restrict__ sdf2,
    const float* __restrict__ t_exit, const float* __restrict__ fixed_dt,
    const float* __restrict__ jitter, float inv_s_mult, int merge_draws,
    float* __restrict__ z_out, float* __restrict__ dt_out, uint8_t* __restrict__ mask_out,
    float* __restrict__ sdf_out, float* __restrict__ z_imp, uint8_t* __restrict__ mask_imp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= R) return;  // the whole warp leaves together; no block barrier follows
  const int S = S1 + S2;
  const int T = merge_draws ? S + n : S;
  const bool carry = sdf1 != nullptr;
  float* key = psdf_dynamic_smem<float>() + (size_t)warp * merge_warp_floats(S, T);
  float* zs = key + psdf_pad4(T);
  float* ds = zs + psdf_pad4(T);
  float* sv = ds + psdf_pad4(T);  // the values, staged in concatenation order
  float* fs = sv + psdf_pad4(S);  // ... and in slot order
  float* sw = fs + psdf_pad4(S);
  uint8_t* ms = reinterpret_cast<uint8_t*>(sw + psdf_pad4(S));
  uint8_t* mv = ms + psdf_pad16(T);
  const long long row1 = (long long)r * S1, row2 = (long long)r * S2;

  psdf_warp_stage(key, z1 + row1, S1 * 4);
  psdf_warp_stage(key + S1, z2 + row2, S2 * 4);
  psdf_warp_stage(mv, m1 + row1, S1);
  psdf_warp_stage(mv + S1, m2 + row2, S2);
  if (carry) {
    psdf_warp_stage(sv, sdf1 + row1, S1 * 4);
    psdf_warp_stage(sv + S1, sdf2 + row2, S2 * 4);
  }
  psdf_stage_wait();
  for (int e = lane; e < S; e += 32)
    if (mv[e] == 0) key[e] = INFINITY;
  __syncwarp();
  const float fdt = fixed_dt[r], te = t_exit[r];
  const int nr = merge_staged(S1, S2, key, mv, carry ? sv : nullptr, fdt, te, zs, ms, fs, ds);

  if (!merge_draws) {  // forms (a) and (b): the merged set
    const long long row = (long long)r * S;
    psdf_warp_copy(z_out + row, zs, S * 4);
    psdf_warp_copy(dt_out + row, ds, S * 4);
    psdf_warp_copy(mask_out + row, ms, S);
    if (sdf_out != nullptr) psdf_warp_copy(sdf_out + row, fs, S * 4);
  }
  if (n == 0) return;

  // round 2 on the merged ray: into z_imp (form b) or behind the merged
  // keys (form c)
  const float* jit = jitter != nullptr ? jitter + (long long)r * n : nullptr;
  if (!merge_draws) {
    importance_draw(S, n, nr, zs, fs, ds, ms, sw, fdt, jit, inv_s_mult,
                    z_imp + (long long)r * n);
    for (int j = lane; j < n; j += 32) mask_imp[(long long)r * n + j] = nr > 0;
    return;
  }
  importance_draw(S, n, nr, zs, fs, ds, ms, sw, fdt, jit, inv_s_mult, key + S);
  __syncwarp();
  for (int i = lane; i < T; i += 32) {
    const bool v = i < S ? ms[i] != 0 : nr > 0;
    if (i < S) key[i] = v ? zs[i] : INFINITY;
    else if (!v) key[i] = INFINITY;
    mv[i] = v;
  }
  __syncwarp();
  merge_staged(S, n, key, mv, nullptr, fdt, te, zs, ms, nullptr, ds);
  const long long row = (long long)r * T;
  psdf_warp_copy(z_out + row, zs, T * 4);
  psdf_warp_copy(dt_out + row, ds, T * 4);
  psdf_warp_copy(mask_out + row, ms, T);
}

}  // namespace

// One importance round (E1). jitter may be null. S >= 2.
extern "C" int psdf_importance_round(int R, int S, int n, const void* z, const void* dt,
                                     const void* mask, const void* fixed_dt, const void* sdf,
                                     const void* jitter, float inv_s_mult, void* z_imp,
                                     void* mask_imp, void* stream) {
  if (R < 0 || S < 2 || n < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return (int)cudaSuccess;
  const size_t smem =
      (size_t)kWarpsPerBlock * (4 * (size_t)psdf_pad4(S) + (size_t)psdf_pad16(S) / 4) *
      sizeof(float);
  PSDF_LAUNCH(importance_round_kernel, psdf_blocks(R, kWarpsPerBlock), kThreads, smem, stream,
              R, S, n, (const float*)z, (const float*)dt, (const uint8_t*)mask,
              (const float*)fixed_dt, (const float*)sdf, (const float*)jitter, inv_s_mult,
              (float*)z_imp, (uint8_t*)mask_imp);
  return (int)cudaGetLastError();
}

// The merge of two sample sets (E2). sdf1 and sdf2 are both null or both
// set; sdf_out may be set only with them. n = 0: form (a). n > 0 (needs
// sdf1, sdf2 and S1 + S2 >= 2) draws round 2 with the jitter [R, n] (or
// null) and inv_s_mult: merge_draws = 0, form (b), also writes z_imp and
// mask_imp [R, n]; merge_draws = 1, form (c), writes z, dt, mask at
// S1 + S2 + n slots and nothing else.
extern "C" int psdf_merge_samples(int R, int S1, int S2, int n, const void* z1, const void* m1,
                                  const void* sdf1, const void* z2, const void* m2,
                                  const void* sdf2, const void* t_exit, const void* fixed_dt,
                                  const void* jitter, float inv_s_mult, int merge_draws,
                                  void* z_out, void* dt_out, void* mask_out, void* sdf_out,
                                  void* z_imp, void* mask_imp, void* stream) {
  if (R < 0 || S1 < 0 || S2 < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if ((sdf1 == nullptr) != (sdf2 == nullptr) || (sdf_out != nullptr && sdf1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n > 0 && (sdf1 == nullptr || S1 + S2 < 2)) return (int)cudaErrorInvalidValue;
  if (R == 0 || S1 + S2 == 0) return (int)cudaSuccess;
  const int S = S1 + S2, T = merge_draws && n > 0 ? S + n : S;
  const size_t smem = (size_t)kWarpsPerBlock * merge_warp_floats(S, T) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_samples_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  PSDF_LAUNCH(merge_samples_kernel, psdf_blocks(R, kWarpsPerBlock), kThreads, smem, stream, R,
              S1, S2, n, (const float*)z1, (const uint8_t*)m1, (const float*)sdf1,
              (const float*)z2, (const uint8_t*)m2, (const float*)sdf2, (const float*)t_exit,
              (const float*)fixed_dt, (const float*)jitter, inv_s_mult,
              merge_draws && n > 0 ? 1 : 0, (float*)z_out, (float*)dt_out, (uint8_t*)mask_out,
              (float*)sdf_out, (float*)z_imp, (uint8_t*)mask_imp);
  return (int)cudaGetLastError();
}
