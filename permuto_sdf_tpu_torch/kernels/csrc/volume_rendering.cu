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
// dt, the mask, rgb and (NeuS) the gradient, ~30 bytes, and writes the
// 4-byte weight; D' reads the same plus the weight cotangent and writes
// the sdf, gradient and rgb cotangents (~32 bytes); the math is a few
// dozen flops.
//
// Design: one warp per ray. Lanes take 32 consecutive samples at a time,
// so every load is coalesced; the exclusive product of (1 - alpha + 1e-7)
// is a warp scan carried across the 32-sample chunks; the weighted sums
// are warp reductions. Results differ from a serial cumprod by the
// association of the product (~1e-6 relative). D' recomputes the forward
// into shared memory (alpha, T and the total weight cotangent per sample),
// then walks the ray backwards: the cotangent of each factor
// tau_j = 1 - alpha_j + 1e-7 is T_j S_j with the reverse linear recurrence
// S_j = Gw_{j+1} alpha_{j+1} + tau_{j+1} S_{j+1} (plus the bg_T cotangent at
// the last valid sample), done as a reverse warp scan of affine maps per
// 32-sample chunk with a carry. It never divides by tau, which can be
// 1e-7.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// mode 0: NeuS (val = sdf, grads [R,S,3] and dirs [R,3] used);
// mode 1: NeRF (val = density).
__global__ void __launch_bounds__(128) render_weights_kernel(
    int mode, int R, int S, const float* __restrict__ val,
    const float* __restrict__ grads, const float* __restrict__ dirs,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ rgb, float inv_s, float cos_anneal_ratio,
    float* __restrict__ weights, float* __restrict__ weights_sum,
    float* __restrict__ bg_T, float* __restrict__ rgb_int,
    float* __restrict__ grad_int) {
  const int lane = threadIdx.x & 31;
  const long long ray =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // whole warps leave together
  const long long base_rs = ray * S;

  int nr = 0;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool valid = i < S && mask[base_rs + i] != 0;
    nr += __popc(__ballot_sync(PSDF_FULL_MASK, valid));
  }

  float d0 = 0.f, d1 = 0.f, d2 = 0.f;
  if (mode == 0) {
    d0 = dirs[ray * 3 + 0];
    d1 = dirs[ray * 3 + 1];
    d2 = dirs[ray * 3 + 2];
  }
  float carry = 1.0f;
  float wsum = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f,
        n2 = 0.f;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool in_row = i < S;
    const bool valid = in_row && mask[base_rs + i] != 0;
    float alpha = 0.f;
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if (valid) {
      const float v = val[base_rs + i];
      const float dist = dt[base_rs + i];
      if (mode == 0) {
        gx = grads[(base_rs + i) * 3 + 0];
        gy = grads[(base_rs + i) * 3 + 1];
        gz = grads[(base_rs + i) * 3 + 2];
        const float true_cos = (d0 * gx + d1 * gy) + d2 * gz;
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
    }
    const float x = valid ? (1.0f - alpha + 1e-7f) : 1.0f;
    float incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
      if (lane >= off) incl = y * incl;
    }
    float excl = __shfl_up_sync(PSDF_FULL_MASK, incl, 1);
    if (lane == 0) excl = 1.0f;
    const float T_shifted = carry * excl;
    const float T = valid ? T_shifted : 0.f;
    const float w = alpha * T;
    if (in_row) weights[base_rs + i] = w;
    if (valid && i == nr - 1) bg_T[ray] = T_shifted;
    if (valid) {
      wsum += w;
      const float* c = rgb + (base_rs + i) * 3;
      c0 += w * c[0];
      c1 += w * c[1];
      c2 += w * c[2];
      n0 += w * gx;
      n1 += w * gy;
      n2 += w * gz;
    }
    carry = carry * __shfl_sync(PSDF_FULL_MASK, incl, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wsum += __shfl_xor_sync(PSDF_FULL_MASK, wsum, off);
    c0 += __shfl_xor_sync(PSDF_FULL_MASK, c0, off);
    c1 += __shfl_xor_sync(PSDF_FULL_MASK, c1, off);
    c2 += __shfl_xor_sync(PSDF_FULL_MASK, c2, off);
    n0 += __shfl_xor_sync(PSDF_FULL_MASK, n0, off);
    n1 += __shfl_xor_sync(PSDF_FULL_MASK, n1, off);
    n2 += __shfl_xor_sync(PSDF_FULL_MASK, n2, off);
  }
  if (lane == 0) {
    weights_sum[ray] = wsum;
    if (nr == 0) bg_T[ray] = 1.0f;
    rgb_int[ray * 3 + 0] = c0;
    rgb_int[ray * 3 + 1] = c1;
    rgb_int[ray * 3 + 2] = c2;
    if (grad_int != nullptr) {
      grad_int[ray * 3 + 0] = n0;
      grad_int[ray * 3 + 1] = n1;
      grad_int[ray * 3 + 2] = n2;
    }
  }
}

// One sample's NeuS alpha (mode 0) or NeRF alpha (mode 1), as kernel D
// forms it; also returns the unclipped NeuS ratio and the sigmoids.
struct AlphaParts {
  float alpha, raw, p, q, cos;
};

__device__ __forceinline__ AlphaParts sample_alpha(
    int mode, float v, float dist, float gx, float gy, float gz, float d0,
    float d1, float d2, float inv_s, float cos_anneal_ratio) {
  AlphaParts a;
  if (mode == 0) {
    a.cos = (d0 * gx + d1 * gy) + d2 * gz;
    const float iter_cos =
        -(fmaxf(-a.cos * 0.5f + 0.5f, 0.f) * (1.0f - cos_anneal_ratio) +
          fmaxf(-a.cos, 0.f) * cos_anneal_ratio);
    const float est_next = v + iter_cos * dist * 0.5f;
    const float est_prev = v - iter_cos * dist * 0.5f;
    a.p = sigmoid(est_prev * inv_s);
    a.q = sigmoid(est_next * inv_s);
    a.raw = (a.p - a.q + 1e-5f) / (a.p + 1e-5f);
    a.alpha = fminf(fmaxf(a.raw, 0.f), 1.f);
  } else {
    a.alpha = 1.0f - expf(-v * dist);
    a.raw = a.alpha;
    a.p = a.q = a.cos = 0.f;
  }
  return a;
}

// Kernel D'. Cotangents in: g_weights [R,S], g_wsum [R], g_bgT [R],
// g_rgb [R,3], g_grad [R,3] (NeuS only). Out: d_val [R,S] (sdf or
// density), d_grads [R,S,3] (NeuS only), d_rgb [R,S,3]; zero at invalid
// samples. The clip of the NeuS alpha passes half the cotangent at a
// bound that is hit exactly and none outside it, and relu passes none at
// 0, as JAX's derivatives do.
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
  const long long ray =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  float* s_alpha = psdf_dynamic_smem<float>() + (long long)warp * 3 * S;
  float* s_T = s_alpha + S;
  float* s_Gw = s_T + S;
  const long long base_rs = ray * S;

  int nr = 0;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool valid = i < S && mask[base_rs + i] != 0;
    nr += __popc(__ballot_sync(PSDF_FULL_MASK, valid));
  }
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

  // forward again: alpha, T and the total cotangent of each weight
  float carry = 1.0f;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool in_row = i < S;
    const bool valid = in_row && mask[base_rs + i] != 0;
    float alpha = 0.f, Gw = 0.f;
    if (valid) {
      float gx = 0.f, gy = 0.f, gz = 0.f;
      if (mode == 0) {
        gx = grads[(base_rs + i) * 3 + 0];
        gy = grads[(base_rs + i) * 3 + 1];
        gz = grads[(base_rs + i) * 3 + 2];
      }
      alpha = sample_alpha(mode, val[base_rs + i], dt[base_rs + i], gx, gy,
                           gz, d0, d1, d2, inv_s, cos_anneal_ratio)
                  .alpha;
      const float* c = rgb + (base_rs + i) * 3;
      Gw = g_weights[base_rs + i] + gws +
           ((gr0 * c[0] + gr1 * c[1]) + gr2 * c[2]) +
           ((gg0 * gx + gg1 * gy) + gg2 * gz);
    }
    const float x = valid ? (1.0f - alpha + 1e-7f) : 1.0f;
    float incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
      if (lane >= off) incl = y * incl;
    }
    float excl = __shfl_up_sync(PSDF_FULL_MASK, incl, 1);
    if (lane == 0) excl = 1.0f;
    if (in_row) {
      s_alpha[i] = alpha;
      s_T[i] = valid ? carry * excl : 0.f;
      s_Gw[i] = Gw;
    }
    carry = carry * __shfl_sync(PSDF_FULL_MASK, incl, 31);
  }
  __syncwarp();

  // backward: S_j = B_j + A_j S_{j+1} with A_j = tau_{j+1}, B_j =
  // Gw_{j+1} alpha_{j+1} (+ g_bgT at j + 1 = nr - 1) for j < nr - 1, and
  // S_{nr-1} = 0; a suffix scan of the affine maps per chunk
  float next = 0.f;  // S at the first index of the chunk after this one
  for (int base = ((S - 1) / 32) * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    float A = 0.f, B = 0.f;
    if (i < nr - 1) {
      const float a1 = s_alpha[i + 1];
      A = 1.0f - a1 + 1e-7f;
      B = s_Gw[i + 1] * a1;
      if (i + 1 == nr - 1) B = B + gbg;
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
    const float Sj = B + A * next;
    next = __shfl_sync(PSDF_FULL_MASK, Sj, 0);
    if (i >= S) continue;
    const bool valid = mask[base_rs + i] != 0;
    float dv = 0.f, dg0 = 0.f, dg1 = 0.f, dg2 = 0.f, dr0 = 0.f, dr1 = 0.f,
          dr2 = 0.f;
    if (valid) {
      const float T = s_T[i];
      const float alpha = s_alpha[i];
      const float w = alpha * T;
      const float dalpha = T * (s_Gw[i] - Sj);
      const float v = val[base_rs + i];
      const float dist = dt[base_rs + i];
      dr0 = w * gr0;
      dr1 = w * gr1;
      dr2 = w * gr2;
      if (mode == 0) {
        const float gx = grads[(base_rs + i) * 3 + 0];
        const float gy = grads[(base_rs + i) * 3 + 1];
        const float gz = grads[(base_rs + i) * 3 + 2];
        const AlphaParts a = sample_alpha(mode, v, dist, gx, gy, gz, d0, d1,
                                          d2, inv_s, cos_anneal_ratio);
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
        const float slope = ((-a.cos * 0.5f + 0.5f > 0.f)
                                 ? (1.0f - cos_anneal_ratio) * 0.5f
                                 : 0.f) +
                            ((-a.cos > 0.f) ? cos_anneal_ratio : 0.f);
        const float dcos = d_ic * slope;
        dg0 = dcos * d0 + w * gg0;
        dg1 = dcos * d1 + w * gg1;
        dg2 = dcos * d2 + w * gg2;
      } else {
        dv = dalpha * expf(-v * dist) * dist;
      }
    }
    d_val[base_rs + i] = dv;
    if (d_grads != nullptr) {
      d_grads[(base_rs + i) * 3 + 0] = dg0;
      d_grads[(base_rs + i) * 3 + 1] = dg1;
      d_grads[(base_rs + i) * 3 + 2] = dg2;
    }
    d_rgb[(base_rs + i) * 3 + 0] = dr0;
    d_rgb[(base_rs + i) * 3 + 1] = dr1;
    d_rgb[(base_rs + i) * 3 + 2] = dr2;
  }
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
  const int block = 128;  // 4 rays per block
  const int grid = psdf_blocks((long long)R * 32, block);
  if (grid == 0) return 0;
  PSDF_LAUNCH(render_weights_kernel, grid, block, 0, stream, mode, R, S,
              (const float*)val, (const float*)grads, (const float*)dirs,
              (const float*)dt, (const uint8_t*)mask, (const float*)rgb,
              inv_s, cos_anneal_ratio, (float*)weights, (float*)weights_sum,
              (float*)bg_T, (float*)rgb_int, (float*)grad_int);
  return (int)cudaGetLastError();
}

extern "C" int psdf_render_weights_bwd(
    int mode, int R, int S, const void* val, const void* grads,
    const void* dirs, const void* dt, const void* mask, const void* rgb,
    float inv_s, float cos_anneal_ratio, const void* g_weights,
    const void* g_wsum, const void* g_bgT, const void* g_rgb,
    const void* g_grad, void* d_val, void* d_grads, void* d_rgb,
    void* stream) {
  const int block = 128;  // 4 rays per block
  const int grid = psdf_blocks((long long)R * 32, block);
  if (grid == 0) return 0;
  const size_t smem = (size_t)(block / 32) * 3 * S * sizeof(float);
  PSDF_LAUNCH(render_weights_bwd_kernel, grid, block, smem, stream, mode, R,
              S, (const float*)val, (const float*)grads, (const float*)dirs,
              (const float*)dt, (const uint8_t*)mask, (const float*)rgb,
              inv_s, cos_anneal_ratio, (const float*)g_weights,
              (const float*)g_wsum, (const float*)g_bgT, (const float*)g_rgb,
              (const float*)g_grad, (float*)d_val, (float*)d_grads,
              (float*)d_rgb);
  return (int)cudaGetLastError();
}
