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
// E1 (one round): z, dt [R,S] f32, mask [R,S] bool (a prefix mask), the
// ray's uniform spacing fixed_dt [R], the samples' sdf [R,S], the stratum
// jitter [R,n] or null and the inv_s multiplier -> z_imp [R,n], mask_imp
// [R,n]. E2 (the merge): two prefix-masked sample sets of one ray batch
// (their sdf, or none), t_exit [R] and fixed_dt -> z, dt, mask[, sdf] at
// S1 + S2 slots, in the order of a stable argsort of z with +inf at the
// invalid slots.
//
// What bounds them on an H100: bytes. E1 reads 13 bytes per sample and
// writes 5 per drawn sample; E2 reads 9 (13 with sdf) and writes 13 (17)
// per slot. Their arithmetic is a few tens of operations per sample (E1)
// and S1 + S2 comparisons per slot (E2, at most 128 per ray here).
//
// Design: one warp per ray, four rays per block. E1 stages the ray's z and
// sdf in shared memory; each lane owns a contiguous run of samples, forms
// their section alphas, and the transmittance (a product) and the CDF (a
// sum) are warp scans over the lanes' runs, accumulated in double so the
// result is the correctly rounded sum whatever the association (the plain
// version's CPU cumsum and cumprod accumulate in double too). The CDF
// goes to shared memory and each lane inverts it at its strata with the
// upper-bound binary search that `torch.searchsorted(right=True)` does. E2
// computes each element's output slot as its rank (the elements with a
// smaller key, plus the equal ones earlier in the concatenation), which is
// exactly the stable sort's position; the sorted z then give dt.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(PSDF_FULL_MASK, v, off);
  return v;
}

// Exclusive scan of v over the lanes (product when `mul`, else sum).
__device__ __forceinline__ double warp_exclusive_scan(double v, bool mul) {
  const int lane = threadIdx.x & 31;
  double incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl = mul ? incl * y : incl + y;
  }
  const double excl = __shfl_up_sync(PSDF_FULL_MASK, incl, 1);
  return lane == 0 ? (mul ? 1.0 : 0.0) : excl;
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

__global__ void __launch_bounds__(kThreads) importance_round_kernel(
    int R, int S, int n, const float* __restrict__ z, const float* __restrict__ dt,
    const uint8_t* __restrict__ mask, const float* __restrict__ fixed_dt,
    const float* __restrict__ sdf, const float* __restrict__ jitter, float inv_s_mult,
    float* __restrict__ z_imp, uint8_t* __restrict__ mask_imp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= R) return;  // the whole warp leaves together; no block barrier follows
  float* sz = psdf_dynamic_smem<float>() + warp * 3 * S;
  float* ssdf = sz + S;
  float* sw = ssdf + S;  // alpha, then the CDF
  const long long row = (long long)r * S;
  int cnt = 0;
  for (int i = lane; i < S; i += 32) {
    sz[i] = z[row + i];
    ssdf[i] = sdf[row + i];
    cnt += mask[row + i] != 0;
  }
  const int nr = warp_sum(cnt);
  __syncwarp();

  // the ray's inv_s: map_range_val(fixed_dt, 1e-4, 1e-2, 1024, 64) * multiplier
  const float x = fminf(fmaxf(fixed_dt[r], (float)1e-4), (float)1e-2);
  const float k = (float)((64.0 - 1024.0) / (0.01 - 0.0001));
  const float s = (1024.0f + k * (x - (float)1e-4)) * inv_s_mult;

  // this lane's run of samples [i0, i1)
  const int per = (S + 31) / 32;
  const int i0 = min(lane * per, S), i1 = min(i0 + per, S);

  // section alphas (0 at the last valid sample and the invalid ones) and
  // the product of this run's transmittance factors
  double prod = 1.0;
  for (int i = i0; i < i1; ++i) {
    const bool valid = mask[row + i] != 0;
    float alpha = 0.0f;
    if (valid && i < nr - 1) {
      const float a = ssdf[i], b = ssdf[i + 1], d = dt[row + i];
      const float mid = (a + b) * 0.5f;
      const float cosv = fminf(fmaxf((b - a) / fmaxf(d, (float)1e-6), -1e3f), 0.0f);
      const float prev_cdf = sigmoid((mid - cosv * d * 0.5f) * s);
      const float next_cdf = sigmoid((mid + cosv * d * 0.5f) * s);
      alpha = fminf(fmaxf((prev_cdf - next_cdf + (float)1e-6) / (prev_cdf + (float)1e-6), 0.0f),
                    1.0f);
    }
    sw[i] = alpha;
    if (valid) prod *= (double)(1.0f - alpha + (float)1e-7);
  }

  // weights = alpha * T (T the exclusive product), and their sum
  double T = warp_exclusive_scan(prod, true);
  double wsum = 0.0;
  for (int i = i0; i < i1; ++i) {
    const bool valid = mask[row + i] != 0;
    const float alpha = sw[i];
    const float w = valid ? alpha * (float)T : 0.0f;
    sw[i] = w;
    wsum += w;
    if (valid) T *= (double)(1.0f - alpha + (float)1e-7);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(PSDF_FULL_MASK, wsum, off);
  const float norm = fmaxf((float)wsum, (float)1e-6);

  // the exclusive CDF of the normalized weights: (inclusive sum) - w
  double run = 0.0;
  for (int i = i0; i < i1; ++i) run += (double)(sw[i] / norm);
  run = warp_exclusive_scan(run, false);
  for (int i = i0; i < i1; ++i) {
    const float w = sw[i] / norm;
    run += (double)w;
    sw[i] = (mask[row + i] != 0) ? (float)run - w : 0.0f;
  }
  __syncwarp();

  // invert the CDF at the strata (i + 1) / (n + 1), moved by the jitter
  const float fdt = fixed_dt[r];
  for (int j = lane; j < n; j += 32) {
    float u = ((float)j + 1.0f) / (float)(n + 1);
    if (jitter != nullptr) u = u + jitter[(long long)r * n + j];
    u = fminf(fmaxf(u, (float)1e-6), (float)(1.0 - 1e-5));
    const int imax = min(max(upper_bound(sw, S, nr, u), 1), max(nr - 1, 1));
    const int imin = imax - 1;
    const float cdf_min = sw[imin], cdf_max = sw[imax];
    const float z_min = sz[imin], z_max = sz[imax];
    const float diff = cdf_max - cdf_min;
    const float denom = fabsf(diff) < (float)1e-12 ? (float)1e-12 : diff;
    float zi = z_min + (u - cdf_min) / denom * (z_max - z_min);
    const float to_min = zi - z_min, to_max = z_max - zi;
    zi = to_min < to_max ? z_min + fminf(to_min, fdt) : z_max - fminf(to_max, fdt);
    z_imp[(long long)r * n + j] = nr > 0 ? zi : 0.0f;
    mask_imp[(long long)r * n + j] = nr > 0;
  }
}

__global__ void __launch_bounds__(kThreads) merge_samples_kernel(
    int R, int S1, int S2, const float* __restrict__ z1, const uint8_t* __restrict__ m1,
    const float* __restrict__ sdf1, const float* __restrict__ z2,
    const uint8_t* __restrict__ m2, const float* __restrict__ sdf2,
    const float* __restrict__ t_exit, const float* __restrict__ fixed_dt,
    float* __restrict__ z_out, float* __restrict__ dt_out, uint8_t* __restrict__ mask_out,
    float* __restrict__ sdf_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= R) return;  // the whole warp leaves together; no block barrier follows
  const int S = S1 + S2;
  float* key = psdf_dynamic_smem<float>() + warp * 2 * S;
  float* zs = key + S;  // the merged z, in output order
  const long long row1 = (long long)r * S1, row2 = (long long)r * S2,
                  row = (long long)r * S;
  int cnt = 0;
  for (int e = lane; e < S; e += 32) {
    const bool first = e < S1;
    const bool valid = first ? m1[row1 + e] != 0 : m2[row2 + e - S1] != 0;
    key[e] = valid ? (first ? z1[row1 + e] : z2[row2 + e - S1]) : INFINITY;
    cnt += valid;
  }
  const int nr = warp_sum(cnt);
  __syncwarp();
  for (int e = lane; e < S; e += 32) {
    const float ke = key[e];
    int rank = 0;
    for (int j = 0; j < S; ++j) {
      const float kj = key[j];
      rank += (kj < ke) || (kj == ke && j < e);
    }
    const bool first = e < S1;
    const bool valid = first ? m1[row1 + e] != 0 : m2[row2 + e - S1] != 0;
    const float zv = valid ? ke : 0.0f;
    zs[rank] = zv;
    z_out[row + rank] = zv;
    mask_out[row + rank] = valid;
    if (sdf_out != nullptr) sdf_out[row + rank] = first ? sdf1[row1 + e] : sdf2[row2 + e - S1];
  }
  __syncwarp();
  const float fdt = fixed_dt[r], te = t_exit[r];
  for (int i = lane; i < S; i += 32) {
    float d = 0.0f;
    if (i < nr - 1) d = fminf(zs[i + 1] - zs[i], fdt);
    else if (i == nr - 1) d = fminf(fmaxf(te - zs[i], 0.0f), fdt);
    dt_out[row + i] = d;
  }
}

}  // namespace

// One importance round (E1). jitter may be null. S >= 2.
extern "C" int psdf_importance_round(int R, int S, int n, const void* z, const void* dt,
                                     const void* mask, const void* fixed_dt, const void* sdf,
                                     const void* jitter, float inv_s_mult, void* z_imp,
                                     void* mask_imp, void* stream) {
  if (R < 0 || S < 2 || n < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kWarpsPerBlock * 3 * S * sizeof(float);
  PSDF_LAUNCH(importance_round_kernel, psdf_blocks(R, kWarpsPerBlock), kThreads, smem, stream,
              R, S, n, (const float*)z, (const float*)dt, (const uint8_t*)mask,
              (const float*)fixed_dt, (const float*)sdf, (const float*)jitter, inv_s_mult,
              (float*)z_imp, (uint8_t*)mask_imp);
  return (int)cudaGetLastError();
}

// The merge of two sample sets (E2). sdf1, sdf2 and sdf_out are all null
// or all set.
extern "C" int psdf_merge_samples(int R, int S1, int S2, const void* z1, const void* m1,
                                  const void* sdf1, const void* z2, const void* m2,
                                  const void* sdf2, const void* t_exit, const void* fixed_dt,
                                  void* z_out, void* dt_out, void* mask_out, void* sdf_out,
                                  void* stream) {
  if (R < 0 || S1 < 0 || S2 < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || S1 + S2 == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kWarpsPerBlock * 2 * (S1 + S2) * sizeof(float);
  PSDF_LAUNCH(merge_samples_kernel, psdf_blocks(R, kWarpsPerBlock), kThreads, smem, stream, R,
              S1, S2, (const float*)z1, (const uint8_t*)m1, (const float*)sdf1,
              (const float*)z2, (const uint8_t*)m2, (const float*)sdf2, (const float*)t_exit,
              (const float*)fixed_dt, (float*)z_out, (float*)dt_out, (uint8_t*)mask_out,
              (float*)sdf_out);
  return (int)cudaGetLastError();
}
