// Kernels D and D': NeuS / NeRF weights and the weighted integration per
// ray, and their backward.
//
// Replaces: permuto_sdf_tpu/ops/volume_rendering.py:151
// `neus_compute_weights_from_cos` (with `neus_compute_weights` :194,
// `cumprod_alpha2transmittance` :47 and `integrate_with_weights` :67) in
// NeuS mode, and `nerf_compute_weights` :210 + `integrate_with_weights` in
// NeRF mode -- kernel D -- and the VJP of both that JAX's autodiff forms
// in the training step -- kernel D'. The JAX package leaves these to XLA.
//
// What bounds them on an H100: bytes. Per sample D reads sdf (or density),
// dt, the mask, rgb and (NeuS) the gradient, ~33 bytes, and writes the
// 4-byte weight; D' reads the same plus the weight cotangent and writes
// the sdf, gradient and rgb cotangents (~32 bytes); the math is a few
// dozen flops. At the exact frame's 2048 rays D moves ~7 MB: ~2 us at
// 3.35 TB/s, so a launch is mostly the latency of one warp's ray.
//
// Design of D: one warp per ray, four rays per block (2048 rays are 2048
// warps, all resident on the 132 SMs at once with any block size, so what
// a ray waits for is its own loads). The warp stages the ray's rows --
// val, dt, the mask and the contiguous 12 S-byte rgb and gradient rows --
// in shared memory with asynchronous copies (cp.async), 16 bytes each
// where the rows are aligned (S a multiple of 4), all in flight at once;
// the mask is read once. Each lane owns a contiguous run of ceil(S / 32) samples: their
// alphas and the product of their factors (1 - alpha + 1e-7), one warp
// scan of the runs' products, then each sample's weight and the run's
// seven weighted sums, reduced together at the end (a reduce-scatter over
// the lanes: 9 shuffles for the seven). The weights go back from
// shared memory in 16-byte stores. Results differ from a serial cumprod
// by the association of the product (~1e-7 absolute on a weight).
//
// D' (one warp per ray, four rays a block) stages the same rows and the
// weight cotangents once in the same way where a lane's run is longer than
// two samples (S > 64); below, each lane reads its own samples' rows
// directly, also in one trip, which measured faster there (PERF.md §6,
// PR 17). After that it reads no device memory but the ray's own
// cotangents. It recomputes the forward as D does (each lane's run, one
// warp scan of the runs' products: the same T as D's) while forming each
// sample's total weight cotangent Gw and the two coefficients of its
// alpha's VJP, which is linear in the alpha cotangent (so the sigmoids and
// divisions run once a sample, off the reverse walk's chain). The
// cotangent of each factor tau_j = 1 - alpha_j + 1e-7 is then T_j S_j with
// the reverse linear recurrence S_j = [j+1 valid] Gw_{j+1} alpha_{j+1} +
// tau'_{j+1} S_{j+1} (tau' = 1 at an invalid sample; plus the bg_T
// cotangent at j + 1 = nr - 1), which holds for any mask. Each lane
// composes its run's affine maps, one reverse warp scan of the composed
// maps gives each run's S at its end, and the lane walks its run backwards
// scaling the coefficients by each sample's alpha cotangent. It never
// divides by tau, which can be 1e-7. The three outputs go into the staged
// val, gradient and rgb rows' places and back in 16-byte stores where the
// rows are aligned. D' runs twice a step after ~1,000 other launches, so
// its code stays small: rolled loops, one noinline copy of the staging and
// the stores.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The warp's totals of eight per-lane values a[0..7], in 9 shuffles (a
// reduce-scatter) instead of 8 x 5: lane l returns the total of value
// (l >> 2) & 7 (so lane 4 v holds value v). a is overwritten.
__device__ __forceinline__ float transpose_reduce8(float* a, int lane) {
  bool up = (lane & 16) != 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = up ? a[j] : a[j + 4];
    const float keep = up ? a[j + 4] : a[j];
    a[j] = keep + __shfl_xor_sync(PSDF_FULL_MASK, send, 16);
  }
  up = (lane & 8) != 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = up ? a[j] : a[j + 2];
    const float keep = up ? a[j + 2] : a[j];
    a[j] = keep + __shfl_xor_sync(PSDF_FULL_MASK, send, 8);
  }
  up = (lane & 4) != 0;
  const float send = up ? a[0] : a[1];
  float v = (up ? a[1] : a[0]) + __shfl_xor_sync(PSDF_FULL_MASK, send, 4);
  v += __shfl_xor_sync(PSDF_FULL_MASK, v, 2);
  v += __shfl_xor_sync(PSDF_FULL_MASK, v, 1);
  return v;
}

// Kernel D's shared memory per ray, in floats: val, dt and the weights at
// S slots, rgb [S, 3], grads [S, 3] (mode 0 only) and the mask bytes.
__host__ __device__ inline int render_weights_warp_floats(int mode, int S) {
  return 3 * psdf_pad4(S) + (mode == 0 ? 2 : 1) * psdf_pad4(3 * S) + psdf_pad16(S) / 4;
}

// mode 0: NeuS (val = sdf, grads [R,S,3] and dirs [R,3] used);
// mode 1: NeRF (val = density). One warp per ray, blockDim.x / 32 rays
// per block.
__global__ void __launch_bounds__(128) render_weights_kernel(
    int mode, int R, int S, const float* __restrict__ val,
    const float* __restrict__ grads, const float* __restrict__ dirs,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ rgb, float inv_s, float cos_anneal_ratio,
    float* __restrict__ weights, float* __restrict__ weights_sum,
    float* __restrict__ bg_T, float* __restrict__ rgb_int,
    float* __restrict__ grad_int) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  float* sv = psdf_dynamic_smem<float>() +
              (size_t)warp * render_weights_warp_floats(mode, S);
  float* sd = sv + psdf_pad4(S);
  float* sw = sd + psdf_pad4(S);  // alpha, then the weight
  float* sc = sw + psdf_pad4(S);  // rgb
  float* sg = sc + psdf_pad4(3 * S);  // grads (mode 0)
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      sg + (mode == 0 ? psdf_pad4(3 * S) : 0));
  const long long row = ray * S;

  // the ray's rows, all in flight at once (cp.async)
  psdf_warp_stage(sv, val + row, S * 4);
  psdf_warp_stage(sd, dt + row, S * 4);
  psdf_warp_stage(sm, mask + row, S);
  psdf_warp_stage(sc, rgb + row * 3, S * 12);
  float d0 = 0.f, d1 = 0.f, d2 = 0.f;
  if (mode == 0) {
    psdf_warp_stage(sg, grads + row * 3, S * 12);
    d0 = dirs[ray * 3 + 0];
    d1 = dirs[ray * 3 + 1];
    d2 = dirs[ray * 3 + 2];
  }
  psdf_stage_wait();

  // this lane's run of samples [i0, i1): the alphas, the valid count and
  // the product of the run's transmittance factors
  const int per = (S + 31) / 32;
  const int i0 = min(lane * per, S), i1 = min(i0 + per, S);
  int cnt = 0;
  float prod = 1.0f;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {  // unrolled: the run's alphas overlap
    const bool valid = sm[i] != 0;
    float alpha = 0.f;
    if (valid) {
      const float v = sv[i];
      const float dist = sd[i];
      if (mode == 0) {
        const float true_cos =
            (d0 * sg[3 * i] + d1 * sg[3 * i + 1]) + d2 * sg[3 * i + 2];
        const float iter_cos =
            -(fmaxf(-true_cos * 0.5f + 0.5f, 0.f) * (1.0f - cos_anneal_ratio) +
              fmaxf(-true_cos, 0.f) * cos_anneal_ratio);
        const float est_next = v + iter_cos * dist * 0.5f;
        const float est_prev = v - iter_cos * dist * 0.5f;
        const float prev_cdf = sigmoid(est_prev * inv_s);
        const float next_cdf = sigmoid(est_next * inv_s);
        alpha = (prev_cdf - next_cdf + 1e-5f) / (prev_cdf + 1e-5f);
        alpha = fminf(fmaxf(alpha, 0.f), 1.f);
      } else {
        alpha = 1.0f - expf(-v * dist);
      }
      prod = prod * (1.0f - alpha + 1e-7f);
    }
    sw[i] = alpha;
    cnt += valid;
  }
  const int nr = (int)__reduce_add_sync(PSDF_FULL_MASK, (unsigned)cnt);

  // one exclusive scan of the runs' products, then the weights
  float incl = prod;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl = y * incl;
  }
  float T = __shfl_up_sync(PSDF_FULL_MASK, incl, 1);
  if (lane == 0) T = 1.0f;
  float wsum = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f,
        n2 = 0.f;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const bool valid = sm[i] != 0;
    if (i == nr - 1) bg_T[ray] = T;
    const float alpha = sw[i];
    const float w = alpha * (valid ? T : 0.f);
    sw[i] = w;
    if (valid) {
      wsum += w;
      c0 += w * sc[3 * i];
      c1 += w * sc[3 * i + 1];
      c2 += w * sc[3 * i + 2];
      if (mode == 0) {
        n0 += w * sg[3 * i];
        n1 += w * sg[3 * i + 1];
        n2 += w * sg[3 * i + 2];
      }
      T = T * (1.0f - alpha + 1e-7f);
    }
  }
  __syncwarp();
  psdf_warp_copy(weights + row, sw, S * 4);

  // the seven sums, reduced over the lanes at once: lane 4 v ends with the
  // total of sum v (wsum, rgb, gradient)
  float a[8] = {wsum, c0, c1, c2, n0, n1, n2, 0.f};
  float v = transpose_reduce8(a, lane);
  if ((lane & 3) == 0 && lane < 28) {
    const int k = lane >> 2;
    if (k == 0) {
      weights_sum[ray] = v;
      if (nr == 0) bg_T[ray] = 1.0f;
    } else if (k <= 3) {
      rgb_int[ray * 3 + k - 1] = v;
    } else if (grad_int != nullptr) {
      grad_int[ray * 3 + k - 4] = v;
    }
  }
}

// psdf_warp_stage and psdf_warp_copy, one copy each for every row of D',
// L, D2 and D2' (see above and below).
__device__ __attribute__((noinline)) void row_stage(void* dst, const void* src, int nbytes) {
  psdf_warp_stage(dst, src, nbytes);
}

__device__ __attribute__((noinline)) void row_store(void* dst, const void* src, int nbytes) {
  psdf_warp_copy(dst, src, nbytes);
}

// One sample's NeuS alpha as kernel D forms it, with the unclipped ratio,
// the sigmoids and the cos it came from.
struct AlphaParts {
  float alpha, raw, p, q, cos;
};

// The NeuS alpha of one sample from its sdf and its cos = dir . grad(sdf)
// (`neus_compute_weights_from_cos`).
__device__ __forceinline__ AlphaParts neus_alpha(float v, float dist,
                                                 float cos, float inv_s,
                                                 float cos_anneal_ratio) {
  AlphaParts a;
  a.cos = cos;
  const float iter_cos =
      -(fmaxf(-cos * 0.5f + 0.5f, 0.f) * (1.0f - cos_anneal_ratio) +
        fmaxf(-cos, 0.f) * cos_anneal_ratio);
  const float est_next = v + iter_cos * dist * 0.5f;
  const float est_prev = v - iter_cos * dist * 0.5f;
  a.p = sigmoid(est_prev * inv_s);
  a.q = sigmoid(est_next * inv_s);
  a.raw = (a.p - a.q + 1e-5f) / (a.p + 1e-5f);
  a.alpha = fminf(fmaxf(a.raw, 0.f), 1.f);
  return a;
}

// The VJP of `neus_alpha` for the cotangent dalpha of its alpha -> (d
// sdf, d cos). The clip passes half the cotangent at a bound that is hit
// exactly and none outside it, and relu passes none at 0, as JAX's
// derivatives do.
__device__ __forceinline__ void neus_alpha_vjp(const AlphaParts& a,
                                               float dalpha, float dist,
                                               float inv_s,
                                               float cos_anneal_ratio,
                                               float& dv, float& dcos) {
  const float clip = (a.raw > 0.f && a.raw < 1.f)
                         ? 1.f
                         : ((a.raw == 0.f || a.raw == 1.f) ? 0.5f : 0.f);
  const float draw = dalpha * clip;
  const float num = a.p - a.q + 1e-5f;
  const float den = a.p + 1e-5f;
  const float dp = draw / den - draw * num / (den * den);
  const float dq = -draw / den;
  const float d_prev = dp * (a.p * (1.0f - a.p)) * inv_s;
  const float d_next = dq * (a.q * (1.0f - a.q)) * inv_s;
  dv = d_next + d_prev;
  const float d_ic = (d_next - d_prev) * dist * 0.5f;
  const float slope =
      ((-a.cos * 0.5f + 0.5f > 0.f) ? (1.0f - cos_anneal_ratio) * 0.5f
                                     : 0.f) +
      ((-a.cos > 0.f) ? cos_anneal_ratio : 0.f);
  dcos = d_ic * slope;
}

// Kernel D''s shared memory per ray, in floats: kernel D's rows (val, dt,
// alpha, rgb, grads in mode 0, the mask), then the weight cotangents (then
// their totals Gw) and T at S slots.
__host__ __device__ inline int render_weights_bwd_warp_floats(int mode, int S) {
  return render_weights_warp_floats(mode, S) + 2 * psdf_pad4(S);
}

// Starts the staging of a ray's rows for D' into its shared memory at
// `base` (kernel D's layout, then g_weights), all in flight at once.
__device__ __attribute__((noinline)) void weights_bwd_stage(
    float* base, int mode, int S, long long ray, const float* __restrict__ val,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ rgb, const float* __restrict__ grads,
    const float* __restrict__ g_weights) {
  const long long row = ray * S;
  float* sc = base + 3 * psdf_pad4(S);
  float* sg = sc + psdf_pad4(3 * S);
  uint8_t* sm = reinterpret_cast<uint8_t*>(sg + (mode == 0 ? psdf_pad4(3 * S) : 0));
  row_stage(base, val + row, S * 4);
  row_stage(base + psdf_pad4(S), dt + row, S * 4);
  row_stage(sm, mask + row, S);
  row_stage(sc, rgb + row * 3, S * 12);
  if (mode == 0) row_stage(sg, grads + row * 3, S * 12);
  row_stage(sm + psdf_pad16(S), g_weights + row, S * 4);
}

// The affine map of D''s reverse recurrence at sample j: S_j = b + a
// S_{j+1} with a = 1 - alpha_{j+1} + 1e-7 and b = Gw_{j+1} alpha_{j+1} where
// sample j + 1 is valid, a = 1 and b = 0 where it is not or j + 1 = S, and
// the bg_T cotangent added to b at j + 1 = nr - 1.
__device__ __forceinline__ void weights_reverse_map(const float* s_alpha,
                                                    const float* s_Gw,
                                                    const uint8_t* s_mask, int j,
                                                    int S, int nr, float gbg,
                                                    float& a, float& b) {
  a = 1.f;
  b = 0.f;
  if (j + 1 < S && s_mask[j + 1] != 0) {
    const float a1 = s_alpha[j + 1];
    a = 1.0f - a1 + 1e-7f;
    b = s_Gw[j + 1] * a1;
  }
  if (j + 1 == nr - 1) b = b + gbg;
}

// Kernel D'. Cotangents in: g_weights [R,S], g_wsum [R], g_bgT [R],
// g_rgb [R,3], g_grad [R,3] (NeuS only). Out: d_val [R,S] (sdf or
// density), d_grads [R,S,3] (NeuS only), d_rgb [R,S,3]; zero at invalid
// samples. The clip of the NeuS alpha passes half the cotangent at a
// bound that is hit exactly and none outside it, and relu passes none at
// 0, as JAX's derivatives do. One warp per ray, blockDim.x / 32 rays per
// block.
__global__ void __launch_bounds__(128) render_weights_bwd_kernel(
    int mode, int R, int S, const float* __restrict__ val,
    const float* __restrict__ grads, const float* __restrict__ dirs,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ rgb, float inv_s, float cos_anneal_ratio,
    const float* __restrict__ g_weights, const float* __restrict__ g_wsum,
    const float* __restrict__ g_bgT, const float* __restrict__ g_rgb,
    const float* __restrict__ g_grad, float* __restrict__ d_val,
    float* __restrict__ d_grads, float* __restrict__ d_rgb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  float* sv = psdf_dynamic_smem<float>() +
              (size_t)warp * render_weights_bwd_warp_floats(mode, S);
  float* sd = sv + psdf_pad4(S);
  float* sw = sd + psdf_pad4(S);  // alpha
  float* sc = sw + psdf_pad4(S);  // rgb
  float* sg = sc + psdf_pad4(3 * S);  // grads (mode 0)
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      sg + (mode == 0 ? psdf_pad4(3 * S) : 0));
  float* sG = reinterpret_cast<float*>(sm + psdf_pad16(S));  // g_weights, then Gw
  float* sT = sG + psdf_pad4(S);
  const long long row = ray * S;

  // every row of the ray in flight at once, then the ray's cotangents; a
  // lane's run of one or two samples (S <= 64) reads its own rows directly
  // instead, in one trip as well, and skips the staging's cost (PERF.md
  // §6, PR 17)
  const bool staged = S > 64;
  if (staged) weights_bwd_stage(sv, mode, S, ray, val, dt, mask, rgb, grads, g_weights);
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, gg0 = 0.f, gg1 = 0.f, gg2 = 0.f;
  if (mode == 0) {
    d0 = dirs[ray * 3 + 0];
    d1 = dirs[ray * 3 + 1];
    d2 = dirs[ray * 3 + 2];
    gg0 = g_grad[ray * 3 + 0];
    gg1 = g_grad[ray * 3 + 1];
    gg2 = g_grad[ray * 3 + 2];
  }
  const float gr0 = g_rgb[ray * 3 + 0], gr1 = g_rgb[ray * 3 + 1],
              gr2 = g_rgb[ray * 3 + 2];
  const float gws = g_wsum[ray];
  const float gbg = g_bgT[ray];
  psdf_stage_wait();
  const float* in_v = staged ? sv : val + row;
  const float* in_d = staged ? sd : dt + row;
  const uint8_t* in_m = staged ? sm : mask + row;
  const float* in_c = staged ? sc : rgb + row * 3;
  const float* in_g = mode != 0 ? nullptr : staged ? sg : grads + row * 3;
  const float* in_G = staged ? sG : g_weights + row;

  // the forward again on this lane's run [i0, i1): each sample's alpha,
  // total cotangent Gw and the coefficients of its alpha's VJP (linear in
  // the alpha cotangent: d val = kv dalpha, d cos = kc dalpha, which take
  // the places of val and dt), the valid count and the run's product of
  // factors; one warp scan of the products, then T down the run
  const int per = (S + 31) / 32;
  const int i0 = min(lane * per, S), i1 = min(i0 + per, S);
  int cnt = 0;
  float prod = 1.0f;
#pragma unroll 1
  for (int i = i0; i < i1; ++i) {
    const bool valid = in_m[i] != 0;
    const float v = in_v[i], dist = in_d[i], gw = in_G[i];
    const float c0 = in_c[3 * i], c1 = in_c[3 * i + 1], c2 = in_c[3 * i + 2];
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if (mode == 0) {
      gx = in_g[3 * i];
      gy = in_g[3 * i + 1];
      gz = in_g[3 * i + 2];
    }
    float alpha = 0.f, Gw = 0.f, kv = 0.f, kc = 0.f;
    if (valid) {
      Gw = (gw + gws) + ((gr0 * c0 + gr1 * c1) + gr2 * c2);
      if (mode == 0) {
        const AlphaParts ap =
            neus_alpha(v, dist, (d0 * gx + d1 * gy) + d2 * gz, inv_s, cos_anneal_ratio);
        alpha = ap.alpha;
        neus_alpha_vjp(ap, 1.0f, dist, inv_s, cos_anneal_ratio, kv, kc);
        Gw = Gw + ((gg0 * gx + gg1 * gy) + gg2 * gz);
      } else {
        const float e = expf(-v * dist);
        alpha = 1.0f - e;
        kv = e * dist;
      }
      prod = prod * (1.0f - alpha + 1e-7f);
      ++cnt;
    }
    sm[i] = valid;
    sw[i] = alpha;
    sG[i] = Gw;
    sv[i] = kv;
    sd[i] = kc;
  }
  const int nr = (int)__reduce_add_sync(PSDF_FULL_MASK, (unsigned)cnt);
  float incl = prod;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl = y * incl;
  }
  float T = __shfl_up_sync(PSDF_FULL_MASK, incl, 1);
  if (lane == 0) T = 1.0f;
#pragma unroll 1
  for (int i = i0; i < i1; ++i) {
    const bool valid = sm[i] != 0;
    sT[i] = valid ? T : 0.f;
    if (valid) T = T * (1.0f - sw[i] + 1e-7f);
  }
  __syncwarp();

  // the reverse recurrence: the run's maps composed (A, B), one suffix scan
  // of the runs' maps, then S_i down the run and each sample's cotangents
  // from its coefficients; the outputs overwrite the lane's own rows
  float A = 1.f, B = 0.f;
#pragma unroll 1
  for (int i = i1 - 1; i >= i0; --i) {
    float a, b;
    weights_reverse_map(sw, sG, sm, i, S, nr, gbg, a, b);
    B = b + a * B;
    A = a * A;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float A2 = __shfl_down_sync(PSDF_FULL_MASK, A, off);
    const float B2 = __shfl_down_sync(PSDF_FULL_MASK, B, off);
    if (lane + off < 32) {
      B = B + A * B2;
      A = A * A2;
    }
  }
  float s_next = __shfl_down_sync(PSDF_FULL_MASK, B, 1);  // S at i1
  if (lane == 31) s_next = 0.f;
#pragma unroll 1
  for (int i = i1 - 1; i >= i0; --i) {
    float a, b;
    weights_reverse_map(sw, sG, sm, i, S, nr, gbg, a, b);
    s_next = b + a * s_next;  // S_i
    const float Ti = sT[i];
    const float w = sw[i] * Ti;
    const float dalpha = Ti * (sG[i] - s_next);  // 0 at an invalid sample
    const float dcos = dalpha * sd[i];
    sv[i] = dalpha * sv[i];
    if (mode == 0) {
      sg[3 * i + 0] = dcos * d0 + w * gg0;
      sg[3 * i + 1] = dcos * d1 + w * gg1;
      sg[3 * i + 2] = dcos * d2 + w * gg2;
    }
    sc[3 * i + 0] = w * gr0;
    sc[3 * i + 1] = w * gr1;
    sc[3 * i + 2] = w * gr2;
  }
  __syncwarp();
  row_store(d_val + row, sv, S * 4);
  if (mode == 0) row_store(d_grads + row * 3, sg, S * 12);
  row_store(d_rgb + row * 3, sc, S * 12);
}

// ---------------------------------------------------------------------------
// Kernels L, D2 and D2': the train-time LOD of the training step
// (permuto_sdf_tpu/train/train_permuto_sdf.py:533-622). The importance stage
// carries a proxy sdf for every sample; L ranks the samples of each ray by
// the NeuS weights of that sdf with a finite-difference cos and selects the
// K heaviest plus E random others (the fine set); the fields run on the fine
// set only; D2 renders the mixed chain (full-resolution sdf and analytic
// cos at the selected valid slots, carried sdf and finite-difference cos
// elsewhere) and integrates rgb and gradient over the selected slots; D2'
// is its VJP with respect to the fine set's sdf, gradient and rgb (the
// carried values are constants, as under JAX's stop_gradient).
//
// What bounds L, D2 and D2' on an H100: bytes (~1.8, ~2.7 and ~3.6 KB a
// ray; 0.00027, 0.00041 and 0.00055 ms at the lever step's 512 rays). At
// 512 rays a warp a ray leaves ~4 warps an SM, so a launch takes the
// latency of one warp's chain of loads and arithmetic, and the kernels
// launch once a step, after ~1,700 other launches, with a cold instruction
// cache. So all three stage each ray's
// rows in shared memory once (cp.async, all in flight before any
// arithmetic) and read no device memory after that, and both keep their
// code small: every loop over slots, rows, tiles or sort stages rolled
// (#pragma unroll 1), the staging and the sort one copy each (noinline). A
// lane takes slot lane + 32 i for the per-slot math (fd cos, alpha), then
// a contiguous run of ceil(S / 32) slots for kernel D's scan of the runs'
// products (one warp scan a ray). L selects with a bitonic sort of 64-bit
// keys (the weight's order-preserving bits over ~slot: larger first, ties
// by the lower slot) in registers, 128 keys a tile and 4 neighbours a lane
// (13 of a tile's 28 stages need no shuffle), tiles merged through shared
// memory above S = 128; once for the top K, once for the extras. D2 and
// D2' share the staging (`mixed_stage`) and the mixed chain
// (`mixed_chain`: the fine rows mapped to their slots in one pass of a row
// per lane with __match_any_sync on the slot, alpha, and the
// transmittance's one warp scan), so D2' differentiates the weights D2
// wrote. D2 then integrates the fine rows at a row per lane from shared
// memory; D2' runs the reverse affine recurrence as one suffix scan of the
// runs' composed maps and takes the chain rule through alpha at a row per
// lane. All write their outputs from shared memory in 16-byte stores where
// the rows are aligned.
// ---------------------------------------------------------------------------

// The sort's width: the next power of two of S, at least one tile of 128.
__host__ __device__ inline int lod_sort_width(int S) {
  int P = 128;
  while (P < S) P <<= 1;
  return P;
}

// Kernel L's shared memory per ray, in bytes: the sort's keys, then sdf,
// dt, scores, cos_fd and the alphas at S slots, the mask and the top-K
// flags.
__host__ __device__ inline int lod_select_warp_bytes(int S) {
  return 8 * lod_sort_width(S) + 20 * psdf_pad4(S) + 2 * psdf_pad16(S);
}

// The selection's key of value v at slot i: the order-preserving bits of v
// (v + 0 first, so that -0 ranks as +0, as the float compare has them
// equal) over ~i, so that a tie goes to the lower slot.
__device__ __forceinline__ unsigned long long rank_key(float v, int i) {
  unsigned u = __float_as_uint(v + 0.0f);
  u ^= (u & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return ((unsigned long long)u << 32) | (unsigned)~i;
}

__device__ __forceinline__ int key_slot(unsigned long long key) {
  return (int)~(unsigned)key;
}

__device__ __forceinline__ void cmp_swap(unsigned long long& a,
                                         unsigned long long& b, bool desc) {
  if (desc ? a < b : a > b) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }
}

// One compare-exchange stage (k, j) of a bitonic sort into descending order
// on a warp's register tile: key[r] holds element base + 4 lane + r of the
// sort (base a multiple of 128). Partners 1 or 2 apart are in the lane's
// own registers, farther ones one shuffle away; a pair sorts descending
// where its lower element has bit k clear.
__device__ __forceinline__ void tile_stage(unsigned long long (&key)[4],
                                           int base, int k, int j, int lane) {
  const bool lane_desc = ((base + 4 * lane) & k) == 0;  // for k >= 4
  if (j == 1) {
    cmp_swap(key[0], key[1], k == 2 || lane_desc);
    cmp_swap(key[2], key[3], k != 2 && lane_desc);
  } else if (j == 2) {
    cmp_swap(key[0], key[2], lane_desc);
    cmp_swap(key[1], key[3], lane_desc);
  } else {
    const int jl = j >> 2;  // the partner's lane distance
    const bool desc = ((base + 4 * (lane & ~jl)) & k) == 0;
    const bool take_max = ((lane & jl) == 0) == desc;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned long long o = __shfl_xor_sync(PSDF_FULL_MASK, key[r], jl);
      if ((o > key[r]) == take_max) key[r] = o;
    }
  }
}

__device__ __forceinline__ void tile_load(unsigned long long (&key)[4],
                                          const unsigned long long* s,
                                          int base, int lane) {
#pragma unroll
  for (int r = 0; r < 4; ++r) key[r] = s[base + 4 * lane + r];
}

__device__ __forceinline__ void tile_store(const unsigned long long (&key)[4],
                                           unsigned long long* s, int base,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 4; ++r) s[base + 4 * lane + r] = key[r];
}

// Sorts a warp's P keys in shared memory (P a power of two, at least 128)
// in descending order: each 128-key tile through every stage up to k = 128
// in registers, then for each k above that the stages 128 or more apart in
// shared memory and the closer ones by tiles in registers. One copy of the
// code for both of L's sorts.
__device__ __attribute__((noinline)) void warp_sort_desc(
    unsigned long long* s_key, int P, int lane) {
  unsigned long long key[4];
#pragma unroll 1
  for (int base = 0; base < P; base += 128) {
    tile_load(key, s_key, base, lane);
#pragma unroll 1
    for (int k = 2; k <= 128; k <<= 1) {
#pragma unroll 1
      for (int j = k >> 1; j > 0; j >>= 1) tile_stage(key, base, k, j, lane);
    }
    tile_store(key, s_key, base, lane);
  }
  __syncwarp();
#pragma unroll 1
  for (int k = 256; k <= P; k <<= 1) {
#pragma unroll 1
    for (int j = k >> 1; j >= 128; j >>= 1) {
#pragma unroll 1
      for (int t = lane; t < (P >> 1); t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const unsigned long long a = s_key[i], b = s_key[i + j];
        if ((i & k) == 0 ? a < b : a > b) {
          s_key[i] = b;
          s_key[i + j] = a;
        }
      }
      __syncwarp();
    }
#pragma unroll 1
    for (int base = 0; base < P; base += 128) {
      tile_load(key, s_key, base, lane);
#pragma unroll 1
      for (int j = 64; j > 0; j >>= 1) tile_stage(key, base, k, j, lane);
      tile_store(key, s_key, base, lane);
    }
    __syncwarp();
  }
}

// Kernel L. In: the carried sdf, dt, mask [R,S]; scores [R,S] in [0, 1)
// (read only when E > 0). Out: cos_fd [R,S] = (sdf_{i+1} - sdf_i) /
// max(dt_i, 1e-6) (sdf_S := sdf_{S-1}), and sel [R, K+E]: the K slots of
// largest NeuS weight (-1 at invalid slots), then the E slots of largest
// score among the valid slots outside them (-1 elsewhere), each in
// descending order with ties to the lower slot, as `lax.top_k`. One warp
// per ray, blockDim.x / 32 rays per block.
__global__ void __launch_bounds__(128) train_lod_select_kernel(
    int R, int S, int K, int E, const float* __restrict__ sdf,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ scores, float inv_s, float cos_anneal_ratio,
    float* __restrict__ cos_fd, long long* __restrict__ sel) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  const int P = lod_sort_width(S);
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(
      psdf_dynamic_smem<uint8_t>() + (size_t)warp * lod_select_warp_bytes(S));
  float* s_sdf = reinterpret_cast<float*>(s_key + P);
  float* s_dt = s_sdf + psdf_pad4(S);
  float* s_sc = s_dt + psdf_pad4(S);
  float* s_cos = s_sc + psdf_pad4(S);
  float* s_alpha = s_cos + psdf_pad4(S);
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_alpha + psdf_pad4(S));
  uint8_t* s_top = s_mask + psdf_pad16(S);
  const long long row = ray * S;

  row_stage(s_sdf, sdf + row, S * 4);
  row_stage(s_dt, dt + row, S * 4);
  row_stage(s_mask, mask + row, S);
  if (E > 0) row_stage(s_sc, scores + row, S * 4);
#pragma unroll 1
  for (int i = lane; i < S; i += 32) s_top[i] = 0;
  psdf_stage_wait();

  // fd cos and alpha
#pragma unroll 1
  for (int i = lane; i < S; i += 32) {
    const float v = s_sdf[i];
    const float dist = s_dt[i];
    const float c = (s_sdf[min(i + 1, S - 1)] - v) / fmaxf(dist, 1e-6f);
    s_cos[i] = c;
    s_alpha[i] = s_mask[i] != 0
                     ? neus_alpha(v, dist, c, inv_s, cos_anneal_ratio).alpha
                     : 0.f;
  }
  __syncwarp();
  row_store(cos_fd + row, s_cos, S * 4);

  // this lane's run [i0, i1): the product of its transmittance factors,
  // one exclusive scan of the runs' products, then the ranking keys
  const int per = (S + 31) / 32;
  const int i0 = min(lane * per, S), i1 = min(i0 + per, S);
  float prod = 1.0f;
#pragma unroll 1
  for (int i = i0; i < i1; ++i)
    if (s_mask[i] != 0) prod = prod * (1.0f - s_alpha[i] + 1e-7f);
  float incl = prod;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl = y * incl;
  }
  float T = __shfl_up_sync(PSDF_FULL_MASK, incl, 1);
  if (lane == 0) T = 1.0f;
#pragma unroll 1
  for (int i = i0; i < i1; ++i) {
    const bool valid = s_mask[i] != 0;
    const float alpha = s_alpha[i];
    s_key[i] = rank_key(valid ? alpha * T : -1.0f, i);
    if (valid) T = T * (1.0f - alpha + 1e-7f);
  }
#pragma unroll 1
  for (int i = S + lane; i < P; i += 32) s_key[i] = 0ull;  // below every key
  __syncwarp();
  warp_sort_desc(s_key, P, lane);
  long long* sel_r = sel + ray * (K + E);
#pragma unroll 1
  for (int k = lane; k < K; k += 32) {
    const int slot = key_slot(s_key[k]);
    sel_r[k] = slot;
    s_top[slot] = 1;
  }
  if (E == 0) return;
  __syncwarp();

  // the extras: the score at the valid slots outside the top K, -1 elsewhere
#pragma unroll 1
  for (int i = lane; i < P; i += 32) {
    const bool extra = i < S && s_mask[i] != 0 && s_top[i] == 0;
    s_key[i] = i >= S ? 0ull : rank_key(extra ? s_sc[i] : -1.0f, i);
  }
  __syncwarp();
  warp_sort_desc(s_key, P, lane);
#pragma unroll 1
  for (int k = lane; k < E; k += 32) sel_r[K + k] = key_slot(s_key[k]);
}

// Kernels D2 and D2''s shared memory per ray, in bytes: the fine rows' slot
// ids (int64), sdf, integration terms, gradients and rgb (D2' then writes
// their cotangents there); the carried sdf, cos_fd, dt, the weight
// cotangents (then their totals), alpha, T (D2: then the weights), the
// rows' sums of terms (then the reverse recurrence's S) and the
// representative row at S slots; the mask. D2 leaves the terms, the
// cotangents and the sums unused.
__host__ __device__ inline int mixed_warp_bytes(int S, int KE) {
  return 16 * psdf_pad4(KE) + 8 * psdf_pad4(3 * KE) + 32 * psdf_pad4(S) +
         psdf_pad16(S);
}

struct MixedRows {
  long long* sel;
  float *sdfc, *term, *gradc, *rgbc, *sdf, *cos, *dt, *Gw, *alpha, *T, *sum;
  int* rep;
  uint8_t* mask;
};

__device__ __forceinline__ MixedRows mixed_rows(uint8_t* base, int S, int KE) {
  MixedRows m;
  m.sel = reinterpret_cast<long long*>(base);
  m.sdfc = reinterpret_cast<float*>(m.sel + psdf_pad4(KE));
  m.term = m.sdfc + psdf_pad4(KE);
  m.gradc = m.term + psdf_pad4(KE);
  m.rgbc = m.gradc + psdf_pad4(3 * KE);
  m.sdf = m.rgbc + psdf_pad4(3 * KE);
  m.cos = m.sdf + psdf_pad4(S);
  m.dt = m.cos + psdf_pad4(S);
  m.Gw = m.dt + psdf_pad4(S);
  m.alpha = m.Gw + psdf_pad4(S);
  m.T = m.alpha + psdf_pad4(S);
  m.sum = m.T + psdf_pad4(S);
  m.rep = reinterpret_cast<int*>(m.sum + psdf_pad4(S));
  m.mask = reinterpret_cast<uint8_t*>(m.rep + psdf_pad4(S));
  return m;
}

// Starts the staging of a ray's rows that D2 and D2' both read (the fine
// rows, the carried sdf, cos_fd, dt and the mask) into its shared memory at
// `base`, all in flight at once. (The noinline helpers take `base` and
// carve the rows again: a MixedRows passed to them would live in local
// memory.)
__device__ __attribute__((noinline)) void mixed_stage(
    uint8_t* base, long long ray, int S, int KE,
    const float* __restrict__ sdf_carried, const float* __restrict__ cos_fd,
    const long long* __restrict__ sel, const float* __restrict__ sdf_c,
    const float* __restrict__ grads_c, const float* __restrict__ rgb_c,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask) {
  const MixedRows m = mixed_rows(base, S, KE);
  const long long row = ray * S, fine = ray * KE;
  row_stage(m.sel, sel + fine, KE * 8);
  row_stage(m.sdfc, sdf_c + fine, KE * 4);
  row_stage(m.gradc, grads_c + fine * 3, KE * 12);
  row_stage(m.rgbc, rgb_c + fine * 3, KE * 12);
  row_stage(m.sdf, sdf_carried + row, S * 4);
  row_stage(m.cos, cos_fd + row, S * 4);
  row_stage(m.dt, dt + row, S * 4);
  row_stage(m.mask, mask + row, S);
}

// The mixed chain of the ray staged at `base`, D2's forward and D2''s recompute (one
// copy of the code, so the backward differentiates the weights the forward
// wrote): the fine rows at a row per lane map to their slots
// (__match_any_sync on the slot; a slot selected twice takes its last row,
// as JAX's scatter keeps it, and with `terms`, each valid slot's sum of its
// rows' m.term in row order into m.sum); then every slot's alpha (the
// representative row's sdf and cos = dir . grad, else the carried sdf and
// cos_fd) and its exclusive transmittance T (0 at invalid slots), by kernel
// D's one warp scan of the products of contiguous runs of ceil(S / 32)
// slots. Returns the number of valid slots.
__device__ __attribute__((noinline)) int mixed_chain(
    uint8_t* base, int S, int KE, bool terms, float d0, float d1, float d2,
    float inv_s, float cos_anneal_ratio) {
  const MixedRows m = mixed_rows(base, S, KE);
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int i = lane; i < S; i += 32) {
    m.rep[i] = -1;
    if (terms) m.sum[i] = 0.f;
  }
  __syncwarp();
#pragma unroll 1
  for (int base = 0; base < KE; base += 32) {
    const int k = base + lane;
    const int slot = k < KE ? (int)m.sel[k] : -1;
    const unsigned same = __match_any_sync(PSDF_FULL_MASK, (unsigned)slot);
    if (k < KE && m.mask[slot] != 0 && (same >> lane) == 1u) {
      if (terms) {
        float acc = m.sum[slot];  // the earlier chunks' rows of this slot
#pragma unroll 1
        for (unsigned b = same; b != 0u; b &= b - 1u)
          acc = acc + m.term[base + __ffs(b) - 1];
        m.sum[slot] = acc;
      }
      m.rep[slot] = k;
    }
    __syncwarp();
  }

  int cnt = 0;
#pragma unroll 1
  for (int i = lane; i < S; i += 32) {
    float alpha = 0.f;
    if (m.mask[i] != 0) {
      const int rep = m.rep[i];
      float v, c;
      if (rep >= 0) {
        v = m.sdfc[rep];
        c = (d0 * m.gradc[3 * rep] + d1 * m.gradc[3 * rep + 1]) +
            d2 * m.gradc[3 * rep + 2];
      } else {
        v = m.sdf[i];
        c = m.cos[i];
      }
      alpha = neus_alpha(v, m.dt[i], c, inv_s, cos_anneal_ratio).alpha;
      ++cnt;
    }
    m.alpha[i] = alpha;
  }
  const int nr = (int)__reduce_add_sync(PSDF_FULL_MASK, (unsigned)cnt);
  __syncwarp();

  const int per = (S + 31) / 32;
  const int i0 = min(lane * per, S), i1 = min(i0 + per, S);
  float prod = 1.0f;
#pragma unroll 1
  for (int i = i0; i < i1; ++i)
    if (m.mask[i] != 0) prod = prod * (1.0f - m.alpha[i] + 1e-7f);
  float incl = prod;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl = y * incl;
  }
  float T = __shfl_up_sync(PSDF_FULL_MASK, incl, 1);
  if (lane == 0) T = 1.0f;
#pragma unroll 1
  for (int i = i0; i < i1; ++i) {
    const bool valid = m.mask[i] != 0;
    m.T[i] = valid ? T : 0.f;
    if (valid) T = T * (1.0f - m.alpha[i] + 1e-7f);
  }
  __syncwarp();
  return nr;
}

// Kernel D2. In: the carried sdf and cos_fd [R,S], sel [R,KE], the fine
// set's sdf_c [R*KE], grads_c [R*KE,3], rgb_c [R*KE,3], dirs [R,3], dt and
// mask [R,S]. Out: weights [R,S], weights_sum [R], bg_T [R] (T at the last
// valid slot; 1 without one), rgb_int [R,3] = sum over the fine rows at
// valid slots of w[sel] rgb_c, grad_int [R,3] likewise. Stages the ray's
// rows, runs `mixed_chain`, writes the weights from shared memory and
// integrates the fine rows from shared memory at a row per lane. One warp
// per ray, blockDim.x / 32 rays per block.
__global__ void __launch_bounds__(128) render_mixed_kernel(
    int R, int S, int KE, const float* __restrict__ sdf_carried,
    const float* __restrict__ cos_fd, const long long* __restrict__ sel,
    const float* __restrict__ sdf_c, const float* __restrict__ grads_c,
    const float* __restrict__ rgb_c, const float* __restrict__ dirs,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    float inv_s, float cos_anneal_ratio, float* __restrict__ weights,
    float* __restrict__ weights_sum, float* __restrict__ bg_T,
    float* __restrict__ rgb_int, float* __restrict__ grad_int) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  uint8_t* base = psdf_dynamic_smem<uint8_t>() + (size_t)warp * mixed_warp_bytes(S, KE);
  const MixedRows m = mixed_rows(base, S, KE);
  mixed_stage(base, ray, S, KE, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c, dt, mask);
  const float d0 = dirs[ray * 3 + 0], d1 = dirs[ray * 3 + 1],
              d2 = dirs[ray * 3 + 2];
  psdf_stage_wait();
  const int nr = mixed_chain(base, S, KE, false, d0, d1, d2, inv_s, cos_anneal_ratio);

  // the weights (in place of T), then out in whole vectors
  const float bg = nr > 0 && m.mask[nr - 1] != 0 ? m.T[nr - 1] : 1.0f;
  __syncwarp();
  float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int i = lane; i < S; i += 32) {
    const float w = m.alpha[i] * m.T[i];
    m.T[i] = w;
    a[0] += w;
  }
  __syncwarp();
  row_store(weights + ray * S, m.T, S * 4);

  // the fine rows at valid slots, a row per lane
#pragma unroll 1
  for (int k = lane; k < KE; k += 32) {
    const int slot = (int)m.sel[k];
    if (m.mask[slot] == 0) continue;
    const float w = m.T[slot];
    a[1] += w * m.rgbc[3 * k];
    a[2] += w * m.rgbc[3 * k + 1];
    a[3] += w * m.rgbc[3 * k + 2];
    a[4] += w * m.gradc[3 * k];
    a[5] += w * m.gradc[3 * k + 1];
    a[6] += w * m.gradc[3 * k + 2];
  }
  const float v = transpose_reduce8(a, lane);  // lane 4 v: the total of a[v]
  if ((lane & 3) == 0 && lane < 28) {
    const int k = lane >> 2;
    if (k == 0) {
      weights_sum[ray] = v;
    } else if (k <= 3) {
      rgb_int[ray * 3 + k - 1] = v;
    } else {
      grad_int[ray * 3 + k - 4] = v;
    }
  }
  if (lane == 0) bg_T[ray] = bg;
}

// The affine map of the backward's reverse recurrence at slot j: S_j = b +
// a S_{j+1} with a = 1 - alpha_{j+1} + 1e-7 and b = Gw_{j+1} alpha_{j+1}
// (+ g_bgT at j + 1 = nr - 1) for j < nr - 1, and S_j = 0 from nr - 1 on.
__device__ __forceinline__ void reverse_map(const float* s_alpha,
                                            const float* s_Gw, int j, int nr,
                                            float gbg, float& a, float& b) {
  a = 0.f;
  b = 0.f;
  if (j < nr - 1) {
    const float a1 = s_alpha[j + 1];
    a = 1.0f - a1 + 1e-7f;
    b = s_Gw[j + 1] * a1;
    if (j + 1 == nr - 1) b = b + gbg;
  }
}

// Kernel D2'. Cotangents in: g_weights [R,S], g_wsum [R], g_bgT [R], g_rgb
// [R,3], g_grad [R,3]. Out: d_sdf_c [R*KE], d_grads_c [R*KE,3], d_rgb_c
// [R*KE,3], zero at fine rows whose slot is invalid. D''s recompute and
// reverse recurrence on the mixed chain: the total cotangent of a weight
// is g_weights + g_wsum at every valid slot, plus g_rgb . rgb_c + g_grad .
// grads_c of each fine row at the slot (added in row order), so an
// unselected valid slot still moves the cotangents of the selected slots
// before it. The chain rule through alpha runs at the slots of a fine row
// (the others are constants) and lands on the slot's representative row
// (the last, as JAX's scatter); every fine row gets its integration terms.
// One warp per ray, blockDim.x / 32 rays per block.
__global__ void __launch_bounds__(128) render_mixed_bwd_kernel(
    int R, int S, int KE, const float* __restrict__ sdf_carried,
    const float* __restrict__ cos_fd, const long long* __restrict__ sel,
    const float* __restrict__ sdf_c, const float* __restrict__ grads_c,
    const float* __restrict__ rgb_c, const float* __restrict__ dirs,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    float inv_s, float cos_anneal_ratio, const float* __restrict__ g_weights,
    const float* __restrict__ g_wsum, const float* __restrict__ g_bgT,
    const float* __restrict__ g_rgb, const float* __restrict__ g_grad,
    float* __restrict__ d_sdf_c, float* __restrict__ d_grads_c,
    float* __restrict__ d_rgb_c) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  uint8_t* base = psdf_dynamic_smem<uint8_t>() + (size_t)warp * mixed_warp_bytes(S, KE);
  const MixedRows m = mixed_rows(base, S, KE);

  // every input of the ray, all in flight at once
  mixed_stage(base, ray, S, KE, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c, dt, mask);
  row_stage(m.Gw, g_weights + ray * S, S * 4);
  const float d0 = dirs[ray * 3 + 0], d1 = dirs[ray * 3 + 1],
              d2 = dirs[ray * 3 + 2];
  const float gg0 = g_grad[ray * 3 + 0], gg1 = g_grad[ray * 3 + 1],
              gg2 = g_grad[ray * 3 + 2];
  const float gr0 = g_rgb[ray * 3 + 0], gr1 = g_rgb[ray * 3 + 1],
              gr2 = g_rgb[ray * 3 + 2];
  const float gws = g_wsum[ray];
  const float gbg = g_bgT[ray];
  psdf_stage_wait();

  // each fine row's integration term; the forward again (D2's chain, with
  // each valid slot's sum of its rows' terms); then the total weight
  // cotangent of every valid slot
#pragma unroll 1
  for (int k = lane; k < KE; k += 32) {
    const float* cc = m.rgbc + 3 * k;
    const float* gc = m.gradc + 3 * k;
    m.term[k] = ((gr0 * cc[0] + gr1 * cc[1]) + gr2 * cc[2]) +
                ((gg0 * gc[0] + gg1 * gc[1]) + gg2 * gc[2]);
  }
  __syncwarp();
  const int nr = mixed_chain(base, S, KE, true, d0, d1, d2, inv_s, cos_anneal_ratio);
#pragma unroll 1
  for (int i = lane; i < S; i += 32)
    m.Gw[i] = m.mask[i] != 0 ? (m.Gw[i] + gws) + m.sum[i] : 0.f;
  __syncwarp();
  const int per = (S + 31) / 32;
  const int i0 = min(lane * per, S), i1 = min(i0 + per, S);
  // the reverse recurrence: the run's maps composed (A, B), one suffix scan
  // of the runs' maps, then S_i down the run
  float A = 1.f, B = 0.f;
#pragma unroll 1
  for (int i = i1 - 1; i >= i0; --i) {
    float a, b;
    reverse_map(m.alpha, m.Gw, i, nr, gbg, a, b);
    B = b + a * B;
    A = a * A;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float A2 = __shfl_down_sync(PSDF_FULL_MASK, A, off);
    const float B2 = __shfl_down_sync(PSDF_FULL_MASK, B, off);
    if (lane + off < 32) {
      B = B + A * B2;
      A = A * A2;
    }
  }
  float s_next = __shfl_down_sync(PSDF_FULL_MASK, B, 1);  // S at i1
  if (lane == 31) s_next = 0.f;
#pragma unroll 1
  for (int i = i1 - 1; i >= i0; --i) {
    float a, b;
    reverse_map(m.alpha, m.Gw, i, nr, gbg, a, b);
    s_next = b + a * s_next;
    m.sum[i] = s_next;
  }
  __syncwarp();

  // the fine rows, a row per lane: the integration terms, and the chain
  // through alpha at each slot's representative row; the rows' buffers
  // take their cotangents, then go out in whole vectors
#pragma unroll 1
  for (int k = lane; k < KE; k += 32) {
    const int slot = (int)m.sel[k];
    float dv = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f, c0 = 0.f, c1 = 0.f,
          c2 = 0.f;
    if (m.mask[slot] != 0) {
      const float Ts = m.T[slot];
      const float w = m.alpha[slot] * Ts;
      float dcos = 0.f;
      if (m.rep[slot] == k) {
        const float dalpha = Ts * (m.Gw[slot] - m.sum[slot]);
        const float dist = m.dt[slot];
        const float c = (d0 * m.gradc[3 * k] + d1 * m.gradc[3 * k + 1]) +
                        d2 * m.gradc[3 * k + 2];
        const AlphaParts ap =
            neus_alpha(m.sdfc[k], dist, c, inv_s, cos_anneal_ratio);
        neus_alpha_vjp(ap, dalpha, dist, inv_s, cos_anneal_ratio, dv, dcos);
      }
      g0 = dcos * d0 + w * gg0;
      g1 = dcos * d1 + w * gg1;
      g2 = dcos * d2 + w * gg2;
      c0 = w * gr0;
      c1 = w * gr1;
      c2 = w * gr2;
    }
    m.sdfc[k] = dv;
    m.gradc[3 * k + 0] = g0;
    m.gradc[3 * k + 1] = g1;
    m.gradc[3 * k + 2] = g2;
    m.rgbc[3 * k + 0] = c0;
    m.rgbc[3 * k + 1] = c1;
    m.rgbc[3 * k + 2] = c2;
  }
  __syncwarp();
  row_store(d_sdf_c + ray * KE, m.sdfc, KE * 4);
  row_store(d_grads_c + ray * KE * 3, m.gradc, KE * 12);
  row_store(d_rgb_c + ray * KE * 3, m.rgbc, KE * 12);
}

}  // namespace

extern "C" int psdf_render_weights(int mode, int R, int S, const void* val,
                                   const void* grads, const void* dirs,
                                   const void* dt, const void* mask,
                                   const void* rgb, float inv_s,
                                   float cos_anneal_ratio, void* weights,
                                   void* weights_sum, void* bg_T,
                                   void* rgb_int, void* grad_int,
                                   void* stream) {
  if (R <= 0) return 0;
  // four rays per block, fewer where a block's rows would not fit
  const size_t per_ray =
      (size_t)render_weights_warp_floats(mode, S) * sizeof(float);
  int rays = 4;
  while (rays > 1 && rays * per_ray > 232448) rays >>= 1;
  const size_t smem = rays * per_ray;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  PSDF_LAUNCH(render_weights_kernel, psdf_blocks(R, rays), 32 * rays, smem,
              stream, mode, R, S, (const float*)val, (const float*)grads,
              (const float*)dirs, (const float*)dt, (const uint8_t*)mask,
              (const float*)rgb, inv_s, cos_anneal_ratio, (float*)weights,
              (float*)weights_sum, (float*)bg_T, (float*)rgb_int,
              (float*)grad_int);
  return (int)cudaGetLastError();
}

// Kernel D' at `rays` rays a block (a warp each), fewer where a block's
// rows would not fit; above 48 KB the kernel opts in.
static int launch_render_weights_bwd(
    int rays, int mode, int R, int S, const void* val, const void* grads,
    const void* dirs, const void* dt, const void* mask, const void* rgb,
    float inv_s, float cos_anneal_ratio, const void* g_weights,
    const void* g_wsum, const void* g_bgT, const void* g_rgb,
    const void* g_grad, void* d_val, void* d_grads, void* d_rgb,
    void* stream) {
  if (R <= 0) return 0;
  const size_t per_ray =
      (size_t)render_weights_bwd_warp_floats(mode, S) * sizeof(float);
  while (rays > 1 && rays * per_ray > 232448) rays >>= 1;
  const size_t smem = rays * per_ray;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_weights_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  PSDF_LAUNCH(render_weights_bwd_kernel, psdf_blocks(R, rays), 32 * rays,
              smem, stream, mode, R, S, (const float*)val,
              (const float*)grads, (const float*)dirs, (const float*)dt,
              (const uint8_t*)mask, (const float*)rgb, inv_s,
              cos_anneal_ratio, (const float*)g_weights,
              (const float*)g_wsum, (const float*)g_bgT, (const float*)g_rgb,
              (const float*)g_grad, (float*)d_val, (float*)d_grads,
              (float*)d_rgb);
  return (int)cudaGetLastError();
}

// Kernel D' runs WEIGHTS_BWD_RAYS rays a block (PERF.md §6, PR 17).
constexpr int WEIGHTS_BWD_RAYS = 4;

extern "C" int psdf_render_weights_bwd(
    int mode, int R, int S, const void* val, const void* grads,
    const void* dirs, const void* dt, const void* mask, const void* rgb,
    float inv_s, float cos_anneal_ratio, const void* g_weights,
    const void* g_wsum, const void* g_bgT, const void* g_rgb,
    const void* g_grad, void* d_val, void* d_grads, void* d_rgb,
    void* stream) {
  return launch_render_weights_bwd(WEIGHTS_BWD_RAYS, mode, R, S, val, grads,
                                   dirs, dt, mask, rgb, inv_s,
                                   cos_anneal_ratio, g_weights, g_wsum, g_bgT,
                                   g_rgb, g_grad, d_val, d_grads, d_rgb,
                                   stream);
}

// Kernels L, D2 and D2' run LOD_RAYS rays a block (a warp each; at the
// lever step's shapes 1, 2 and 4 measured within 2.5% for L and D2', 4 the
// fastest: PERF.md §6), fewer where a block's shared memory would not fit;
// above 48 KB the kernel opts in.
constexpr int LOD_RAYS = 4;

template <class Kernel>
static int lod_block_shape(Kernel kernel, size_t per_ray, int& rays,
                           size_t& smem) {
  while (rays > 1 && rays * per_ray > 232448) rays >>= 1;
  smem = rays * per_ray;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static int launch_train_lod_select(int rays, int R, int S, int K, int E,
                                   const void* sdf, const void* dt,
                                   const void* mask, const void* scores,
                                   float inv_s, float cos_anneal_ratio,
                                   void* cos_fd, void* sel, void* stream) {
  if (R <= 0) return 0;
  size_t smem;
  const int err = lod_block_shape(train_lod_select_kernel,
                                  lod_select_warp_bytes(S), rays, smem);
  if (err != 0) return err;
  PSDF_LAUNCH(train_lod_select_kernel, psdf_blocks(R, rays), 32 * rays, smem,
              stream, R, S, K, E, (const float*)sdf, (const float*)dt,
              (const uint8_t*)mask, (const float*)scores, inv_s,
              cos_anneal_ratio, (float*)cos_fd, (long long*)sel);
  return (int)cudaGetLastError();
}

static int launch_render_mixed(int rays, int R, int S, int KE,
                               const void* sdf_carried, const void* cos_fd,
                               const void* sel, const void* sdf_c,
                               const void* grads_c, const void* rgb_c,
                               const void* dirs, const void* dt,
                               const void* mask, float inv_s,
                               float cos_anneal_ratio, void* weights,
                               void* weights_sum, void* bg_T, void* rgb_int,
                               void* grad_int, void* stream) {
  if (R <= 0) return 0;
  size_t smem;
  const int err = lod_block_shape(render_mixed_kernel,
                                  mixed_warp_bytes(S, KE), rays, smem);
  if (err != 0) return err;
  PSDF_LAUNCH(render_mixed_kernel, psdf_blocks(R, rays), 32 * rays, smem,
              stream, R, S, KE, (const float*)sdf_carried,
              (const float*)cos_fd, (const long long*)sel,
              (const float*)sdf_c, (const float*)grads_c,
              (const float*)rgb_c, (const float*)dirs, (const float*)dt,
              (const uint8_t*)mask, inv_s, cos_anneal_ratio, (float*)weights,
              (float*)weights_sum, (float*)bg_T, (float*)rgb_int,
              (float*)grad_int);
  return (int)cudaGetLastError();
}

static int launch_render_mixed_bwd(
    int rays, int R, int S, int KE, const void* sdf_carried,
    const void* cos_fd, const void* sel, const void* sdf_c,
    const void* grads_c, const void* rgb_c, const void* dirs, const void* dt,
    const void* mask, float inv_s, float cos_anneal_ratio,
    const void* g_weights, const void* g_wsum, const void* g_bgT,
    const void* g_rgb, const void* g_grad, void* d_sdf_c, void* d_grads_c,
    void* d_rgb_c, void* stream) {
  if (R <= 0) return 0;
  size_t smem;
  const int err = lod_block_shape(render_mixed_bwd_kernel,
                                  mixed_warp_bytes(S, KE), rays, smem);
  if (err != 0) return err;
  PSDF_LAUNCH(render_mixed_bwd_kernel, psdf_blocks(R, rays), 32 * rays, smem,
              stream, R, S, KE, (const float*)sdf_carried,
              (const float*)cos_fd, (const long long*)sel,
              (const float*)sdf_c, (const float*)grads_c,
              (const float*)rgb_c, (const float*)dirs, (const float*)dt,
              (const uint8_t*)mask, inv_s, cos_anneal_ratio,
              (const float*)g_weights, (const float*)g_wsum,
              (const float*)g_bgT, (const float*)g_rgb, (const float*)g_grad,
              (float*)d_sdf_c, (float*)d_grads_c, (float*)d_rgb_c);
  return (int)cudaGetLastError();
}

extern "C" int psdf_train_lod_select(int R, int S, int K, int E,
                                     const void* sdf, const void* dt,
                                     const void* mask, const void* scores,
                                     float inv_s, float cos_anneal_ratio,
                                     void* cos_fd, void* sel, void* stream) {
  return launch_train_lod_select(LOD_RAYS, R, S, K, E, sdf, dt, mask, scores,
                                 inv_s, cos_anneal_ratio, cos_fd, sel, stream);
}

extern "C" int psdf_render_mixed(int R, int S, int KE, const void* sdf_carried,
                                 const void* cos_fd, const void* sel,
                                 const void* sdf_c, const void* grads_c,
                                 const void* rgb_c, const void* dirs,
                                 const void* dt, const void* mask, float inv_s,
                                 float cos_anneal_ratio, void* weights,
                                 void* weights_sum, void* bg_T, void* rgb_int,
                                 void* grad_int, void* stream) {
  return launch_render_mixed(LOD_RAYS, R, S, KE, sdf_carried, cos_fd, sel,
                             sdf_c, grads_c, rgb_c, dirs, dt, mask, inv_s,
                             cos_anneal_ratio, weights, weights_sum, bg_T,
                             rgb_int, grad_int, stream);
}

extern "C" int psdf_render_mixed_bwd(
    int R, int S, int KE, const void* sdf_carried, const void* cos_fd,
    const void* sel, const void* sdf_c, const void* grads_c, const void* rgb_c,
    const void* dirs, const void* dt, const void* mask, float inv_s,
    float cos_anneal_ratio, const void* g_weights, const void* g_wsum,
    const void* g_bgT, const void* g_rgb, const void* g_grad, void* d_sdf_c,
    void* d_grads_c, void* d_rgb_c, void* stream) {
  return launch_render_mixed_bwd(LOD_RAYS, R, S, KE, sdf_carried, cos_fd, sel,
                                 sdf_c, grads_c, rgb_c, dirs, dt, mask, inv_s,
                                 cos_anneal_ratio, g_weights, g_wsum, g_bgT,
                                 g_rgb, g_grad, d_sdf_c, d_grads_c, d_rgb_c,
                                 stream);
}
