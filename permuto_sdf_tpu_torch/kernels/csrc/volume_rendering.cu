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

// One 32-sample chunk of the transmittance: the exclusive product of the
// factors x = 1 - alpha + 1e-7 (1 at invalid samples) before each lane's
// sample in the ray. `carry` holds the product over the earlier chunks and
// is advanced past this one.
__device__ __forceinline__ float transmittance_chunk(float x, int lane,
                                                     float& carry) {
  float incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl = y * incl;
  }
  float excl = __shfl_up_sync(PSDF_FULL_MASK, incl, 1);
  if (lane == 0) excl = 1.0f;
  const float T = carry * excl;
  carry = carry * __shfl_sync(PSDF_FULL_MASK, incl, 31);
  return T;
}

// One 32-sample chunk (lane = i - chunk start) of the backward's reverse
// recurrence S_j = B_j + A_j S_{j+1} with A_j = tau_{j+1} = 1 - alpha_{j+1}
// + 1e-7 and B_j = Gw_{j+1} alpha_{j+1} (+ g_bgT at j + 1 = nr - 1) for j
// < nr - 1, and S_{nr-1} = 0: a suffix scan of the affine maps. `next` is
// S at the first index of the chunk after this one and is advanced to this
// chunk's first. Returns S_i.
__device__ __forceinline__ float reverse_affine_chunk(const float* s_alpha,
                                                      const float* s_Gw,
                                                      int i, int nr,
                                                      float gbg, int lane,
                                                      float& next) {
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
  return Sj;
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
    const float T_shifted = transmittance_chunk(x, lane, carry);
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

__device__ __forceinline__ AlphaParts sample_alpha(
    int mode, float v, float dist, float gx, float gy, float gz, float d0,
    float d1, float d2, float inv_s, float cos_anneal_ratio) {
  AlphaParts a;
  if (mode == 0) {
    a = neus_alpha(v, dist, (d0 * gx + d1 * gy) + d2 * gz, inv_s,
                   cos_anneal_ratio);
  } else {
    a.alpha = 1.0f - expf(-v * dist);
    a.raw = a.alpha;
    a.p = a.q = a.cos = 0.f;
  }
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
    const float T = transmittance_chunk(x, lane, carry);
    if (in_row) {
      s_alpha[i] = alpha;
      s_T[i] = valid ? T : 0.f;
      s_Gw[i] = Gw;
    }
  }
  __syncwarp();

  // backward: the reverse recurrence of the affine maps, chunk by chunk
  float next = 0.f;  // S at the first index of the chunk after this one
  for (int base = ((S - 1) / 32) * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    const float Sj =
        reverse_affine_chunk(s_alpha, s_Gw, i, nr, gbg, lane, next);
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
        float dcos;
        neus_alpha_vjp(a, dalpha, dist, inv_s, cos_anneal_ratio, dv, dcos);
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
// ---------------------------------------------------------------------------

// Rank of v[i] in the descending order of v[0..S) that `lax.top_k` (and a
// stable descending sort) gives: larger values first, ties by lower index.
__device__ __forceinline__ int slot_rank(const float* v, int S, int i) {
  const float vi = v[i];
  int r = 0;
  for (int j = 0; j < S; ++j) {
    const float vj = v[j];
    r += (vj > vi || (vj == vi && j < i)) ? 1 : 0;
  }
  return r;
}

// Kernel L. In: the carried sdf, dt, mask [R,S]; scores [R,S] in [0, 1)
// (read only when E > 0). Out: cos_fd [R,S] = (sdf_{i+1} - sdf_i) /
// max(dt_i, 1e-6) (sdf_S := sdf_{S-1}), and sel [R, K+E]: the K slots of
// largest NeuS weight (-1 at invalid slots), then the E slots of largest
// score among the valid slots outside them (-1 elsewhere). One warp per
// ray; the weights' transmittance is kernel D's warp scan; a slot's rank
// is a count over the ray's slots in shared memory, and a slot of rank r
// writes sel[r] (the ranks are a permutation, so every entry is written).
__global__ void __launch_bounds__(128) train_lod_select_kernel(
    int R, int S, int K, int E, const float* __restrict__ sdf,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ scores, float inv_s, float cos_anneal_ratio,
    float* __restrict__ cos_fd, long long* __restrict__ sel) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  float* s_rank = psdf_dynamic_smem<float>() + (long long)warp * 2 * S;
  float* s_score = s_rank + S;
  const long long base_rs = ray * S;
  const int KE = K + E;
  long long* sel_r = sel + ray * KE;

  float carry = 1.0f;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool in_row = i < S;
    const bool valid = in_row && mask[base_rs + i] != 0;
    float alpha = 0.f;
    if (in_row) {
      const float v = sdf[base_rs + i];
      const float v_next = sdf[base_rs + (i + 1 < S ? i + 1 : S - 1)];
      const float dist = dt[base_rs + i];
      const float c = (v_next - v) / fmaxf(dist, 1e-6f);
      cos_fd[base_rs + i] = c;
      if (valid) alpha = neus_alpha(v, dist, c, inv_s, cos_anneal_ratio).alpha;
    }
    const float x = valid ? (1.0f - alpha + 1e-7f) : 1.0f;
    const float T = transmittance_chunk(x, lane, carry);
    if (in_row) s_rank[i] = valid ? alpha * T : -1.0f;
  }
  __syncwarp();
  for (int i = lane; i < S; i += 32) {
    const int r = slot_rank(s_rank, S, i);
    if (r < K) sel_r[r] = i;
    if (E > 0)
      s_score[i] = (r >= K && mask[base_rs + i] != 0) ? scores[base_rs + i]
                                                      : -1.0f;
  }
  if (E == 0) return;
  __syncwarp();
  for (int i = lane; i < S; i += 32) {
    const int r = slot_rank(s_score, S, i);
    if (r < E) sel_r[K + r] = i;
  }
}

// Shared by D2 and D2': the ray's sel row into s_sel, and s_rep[i] = the
// last fine row k (within the ray) with sel[k] == i when slot i is valid,
// else -1. A ray with fewer valid samples than K + E selects some slots
// twice (`lax.top_k` over ties at -1); JAX's scatter of the fine values
// into the chain keeps the last of them (the values agree: the same
// point), and its integration counts every fine row.
__device__ __forceinline__ void fine_rows_of_slots(
    int lane, long long ray, int S, int KE, const long long* __restrict__ sel,
    const uint8_t* __restrict__ mask, int* s_sel, int* s_rep) {
  for (int k = lane; k < KE; k += 32) s_sel[k] = (int)sel[ray * KE + k];
  __syncwarp();
  for (int i = lane; i < S; i += 32) {
    int rep = -1;
    if (mask[ray * S + i] != 0) {
      for (int k = KE - 1; k >= 0; --k) {
        if (s_sel[k] == i) {
          rep = k;
          break;
        }
      }
    }
    s_rep[i] = rep;
  }
  __syncwarp();
}

// The mixed chain's sdf and cos at slot i: the fine set's row rep (>= 0)
// or the carried sdf and cos_fd.
__device__ __forceinline__ void mixed_sample(
    int rep, long long ray, int KE, long long rs,
    const float* __restrict__ sdf_carried, const float* __restrict__ cos_fd,
    const float* __restrict__ sdf_c, const float* __restrict__ grads_c,
    float d0, float d1, float d2, float& v, float& c) {
  if (rep >= 0) {
    const long long f = ray * KE + rep;
    v = sdf_c[f];
    c = (d0 * grads_c[f * 3 + 0] + d1 * grads_c[f * 3 + 1]) +
        d2 * grads_c[f * 3 + 2];
  } else {
    v = sdf_carried[rs];
    c = cos_fd[rs];
  }
}

// Kernel D2. In: the carried sdf and cos_fd [R,S], sel [R,KE], the fine
// set's sdf_c [R*KE], grads_c [R*KE,3], rgb_c [R*KE,3], dirs [R,3], dt and
// mask [R,S]. Out: weights [R,S], weights_sum [R], bg_T [R], rgb_int [R,3]
// = sum over the fine rows at valid slots of w[sel] rgb_c, grad_int [R,3]
// likewise. The weights come from kernel D's warp scan over the slots; the
// integration is a pass over the fine rows once the weights are in shared
// memory.
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
  const long long ray =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  float* s_w = psdf_dynamic_smem<float>() + (long long)warp * (2 * S + KE);
  int* s_rep = reinterpret_cast<int*>(s_w + S);
  int* s_sel = s_rep + S;
  const long long base_rs = ray * S;
  fine_rows_of_slots(lane, ray, S, KE, sel, mask, s_sel, s_rep);

  int nr = 0;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool valid = i < S && mask[base_rs + i] != 0;
    nr += __popc(__ballot_sync(PSDF_FULL_MASK, valid));
  }
  const float d0 = dirs[ray * 3 + 0], d1 = dirs[ray * 3 + 1],
              d2 = dirs[ray * 3 + 2];
  float carry = 1.0f;
  float wsum = 0.f;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool in_row = i < S;
    const bool valid = in_row && mask[base_rs + i] != 0;
    float alpha = 0.f;
    if (valid) {
      float v, c;
      mixed_sample(s_rep[i], ray, KE, base_rs + i, sdf_carried, cos_fd, sdf_c,
                   grads_c, d0, d1, d2, v, c);
      alpha = neus_alpha(v, dt[base_rs + i], c, inv_s, cos_anneal_ratio).alpha;
    }
    const float x = valid ? (1.0f - alpha + 1e-7f) : 1.0f;
    const float T_shifted = transmittance_chunk(x, lane, carry);
    const float w = alpha * (valid ? T_shifted : 0.f);
    if (in_row) {
      weights[base_rs + i] = w;
      s_w[i] = w;
    }
    if (valid && i == nr - 1) bg_T[ray] = T_shifted;
    if (valid) wsum += w;
  }
  __syncwarp();
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  for (int k = lane; k < KE; k += 32) {
    const int slot = s_sel[k];
    if (mask[base_rs + slot] == 0) continue;
    const float w = s_w[slot];
    const long long f = ray * KE + k;
    c0 += w * rgb_c[f * 3 + 0];
    c1 += w * rgb_c[f * 3 + 1];
    c2 += w * rgb_c[f * 3 + 2];
    n0 += w * grads_c[f * 3 + 0];
    n1 += w * grads_c[f * 3 + 1];
    n2 += w * grads_c[f * 3 + 2];
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
    grad_int[ray * 3 + 0] = n0;
    grad_int[ray * 3 + 1] = n1;
    grad_int[ray * 3 + 2] = n2;
  }
}

// Kernel D2'. Cotangents in: g_weights [R,S], g_wsum [R], g_bgT [R], g_rgb
// [R,3], g_grad [R,3]. Out: d_sdf_c [R*KE], d_grads_c [R*KE,3], d_rgb_c
// [R*KE,3], zero at fine rows whose slot is invalid. D''s recompute and
// reverse affine scan on the mixed chain: the total cotangent of a weight
// is g_weights + g_wsum at every valid slot, plus g_rgb . rgb_c + g_grad .
// grads_c of each fine row at the slot, so an unselected valid slot still
// moves the cotangents of the selected slots before it. The chain rule
// through alpha runs at the slots of a fine row (the others are constants)
// and lands on the slot's representative row (the last, as JAX's scatter);
// every fine row gets its integration terms.
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
  const long long ray =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // whole warps leave together; no block barrier below
  float* s_alpha = psdf_dynamic_smem<float>() + (long long)warp * (6 * S + KE);
  float* s_T = s_alpha + S;
  float* s_Gw = s_T + S;
  float* s_dv = s_Gw + S;
  float* s_dcos = s_dv + S;
  int* s_rep = reinterpret_cast<int*>(s_dcos + S);
  int* s_sel = s_rep + S;
  const long long base_rs = ray * S;
  fine_rows_of_slots(lane, ray, S, KE, sel, mask, s_sel, s_rep);

  int nr = 0;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool valid = i < S && mask[base_rs + i] != 0;
    nr += __popc(__ballot_sync(PSDF_FULL_MASK, valid));
  }
  const float d0 = dirs[ray * 3 + 0], d1 = dirs[ray * 3 + 1],
              d2 = dirs[ray * 3 + 2];
  const float gg0 = g_grad[ray * 3 + 0], gg1 = g_grad[ray * 3 + 1],
              gg2 = g_grad[ray * 3 + 2];
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
      const int rep = s_rep[i];
      float v, c;
      mixed_sample(rep, ray, KE, base_rs + i, sdf_carried, cos_fd, sdf_c,
                   grads_c, d0, d1, d2, v, c);
      alpha = neus_alpha(v, dt[base_rs + i], c, inv_s, cos_anneal_ratio).alpha;
      Gw = g_weights[base_rs + i] + gws;
      for (int k = 0; k <= rep; ++k) {
        if (s_sel[k] != i) continue;
        const long long f = ray * KE + k;
        const float* cc = rgb_c + f * 3;
        const float* gc = grads_c + f * 3;
        Gw = Gw + ((gr0 * cc[0] + gr1 * cc[1]) + gr2 * cc[2]) +
             ((gg0 * gc[0] + gg1 * gc[1]) + gg2 * gc[2]);
      }
    }
    const float x = valid ? (1.0f - alpha + 1e-7f) : 1.0f;
    const float T = transmittance_chunk(x, lane, carry);
    if (in_row) {
      s_alpha[i] = alpha;
      s_T[i] = valid ? T : 0.f;
      s_Gw[i] = Gw;
    }
  }
  __syncwarp();

  // backward: kernel D''s suffix scan of the affine maps S_j = B_j + A_j
  // S_{j+1}, then the chain rule through alpha at the slots of a fine row
  float next = 0.f;
  for (int base = ((S - 1) / 32) * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    const float Sj =
        reverse_affine_chunk(s_alpha, s_Gw, i, nr, gbg, lane, next);
    if (i >= S || s_rep[i] < 0) continue;  // invalid, or a carried constant
    const float T = s_T[i];
    const float dalpha = T * (s_Gw[i] - Sj);
    const float dist = dt[base_rs + i];
    float v, c;
    mixed_sample(s_rep[i], ray, KE, base_rs + i, sdf_carried, cos_fd, sdf_c,
                 grads_c, d0, d1, d2, v, c);
    const AlphaParts a = neus_alpha(v, dist, c, inv_s, cos_anneal_ratio);
    neus_alpha_vjp(a, dalpha, dist, inv_s, cos_anneal_ratio, s_dv[i],
                   s_dcos[i]);
  }
  __syncwarp();

  // the fine rows: the integration terms, and the chain through alpha at
  // each slot's representative row
  for (int k = lane; k < KE; k += 32) {
    const long long f = ray * KE + k;
    const int slot = s_sel[k];
    float dv = 0.f, dcos = 0.f, w = 0.f;
    if (mask[base_rs + slot] != 0) {
      w = s_alpha[slot] * s_T[slot];
      if (s_rep[slot] == k) {
        dv = s_dv[slot];
        dcos = s_dcos[slot];
      }
    }
    d_sdf_c[f] = dv;
    d_grads_c[f * 3 + 0] = dcos * d0 + w * gg0;
    d_grads_c[f * 3 + 1] = dcos * d1 + w * gg1;
    d_grads_c[f * 3 + 2] = dcos * d2 + w * gg2;
    d_rgb_c[f * 3 + 0] = w * gr0;
    d_rgb_c[f * 3 + 1] = w * gr1;
    d_rgb_c[f * 3 + 2] = w * gr2;
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

extern "C" int psdf_train_lod_select(int R, int S, int K, int E,
                                     const void* sdf, const void* dt,
                                     const void* mask, const void* scores,
                                     float inv_s, float cos_anneal_ratio,
                                     void* cos_fd, void* sel, void* stream) {
  const int block = 128;  // 4 rays per block
  const int grid = psdf_blocks((long long)R * 32, block);
  if (grid == 0) return 0;
  const size_t smem = (size_t)(block / 32) * 2 * S * sizeof(float);
  PSDF_LAUNCH(train_lod_select_kernel, grid, block, smem, stream, R, S, K, E,
              (const float*)sdf, (const float*)dt, (const uint8_t*)mask,
              (const float*)scores, inv_s, cos_anneal_ratio, (float*)cos_fd,
              (long long*)sel);
  return (int)cudaGetLastError();
}

extern "C" int psdf_render_mixed(int R, int S, int KE, const void* sdf_carried,
                                 const void* cos_fd, const void* sel,
                                 const void* sdf_c, const void* grads_c,
                                 const void* rgb_c, const void* dirs,
                                 const void* dt, const void* mask, float inv_s,
                                 float cos_anneal_ratio, void* weights,
                                 void* weights_sum, void* bg_T, void* rgb_int,
                                 void* grad_int, void* stream) {
  const int block = 128;  // 4 rays per block
  const int grid = psdf_blocks((long long)R * 32, block);
  if (grid == 0) return 0;
  const size_t smem = (size_t)(block / 32) * (2 * S + KE) * sizeof(float);
  PSDF_LAUNCH(render_mixed_kernel, grid, block, smem, stream, R, S, KE,
              (const float*)sdf_carried, (const float*)cos_fd,
              (const long long*)sel, (const float*)sdf_c,
              (const float*)grads_c, (const float*)rgb_c, (const float*)dirs,
              (const float*)dt, (const uint8_t*)mask, inv_s, cos_anneal_ratio,
              (float*)weights, (float*)weights_sum, (float*)bg_T,
              (float*)rgb_int, (float*)grad_int);
  return (int)cudaGetLastError();
}

extern "C" int psdf_render_mixed_bwd(
    int R, int S, int KE, const void* sdf_carried, const void* cos_fd,
    const void* sel, const void* sdf_c, const void* grads_c, const void* rgb_c,
    const void* dirs, const void* dt, const void* mask, float inv_s,
    float cos_anneal_ratio, const void* g_weights, const void* g_wsum,
    const void* g_bgT, const void* g_rgb, const void* g_grad, void* d_sdf_c,
    void* d_grads_c, void* d_rgb_c, void* stream) {
  const int block = 128;  // 4 rays per block
  const int grid = psdf_blocks((long long)R * 32, block);
  if (grid == 0) return 0;
  const size_t smem = (size_t)(block / 32) * (6 * S + KE) * sizeof(float);
  PSDF_LAUNCH(render_mixed_bwd_kernel, grid, block, smem, stream, R, S, KE,
              (const float*)sdf_carried, (const float*)cos_fd,
              (const long long*)sel, (const float*)sdf_c,
              (const float*)grads_c, (const float*)rgb_c, (const float*)dirs,
              (const float*)dt, (const uint8_t*)mask, inv_s, cos_anneal_ratio,
              (const float*)g_weights, (const float*)g_wsum,
              (const float*)g_bgT, (const float*)g_rgb, (const float*)g_grad,
              (float*)d_sdf_c, (float*)d_grads_c, (float*)d_rgb_c);
  return (int)cudaGetLastError();
}
