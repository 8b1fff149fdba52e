// Kernel D: NeuS / NeRF weights and the weighted integration per ray.
//
// Replaces: permuto_sdf_tpu/ops/volume_rendering.py:151
// `neus_compute_weights_from_cos` (with `neus_compute_weights` :194,
// `cumprod_alpha2transmittance` :47 and `integrate_with_weights` :67) in
// NeuS mode, and `nerf_compute_weights` :210 + `integrate_with_weights` in
// NeRF mode. The JAX package leaves these to XLA.
//
// What bounds it on an H100: bytes. Per sample it reads sdf (or density),
// dt, the mask, rgb and (NeuS) the gradient, ~30 bytes, and writes the
// 4-byte weight; the math is a few dozen flops.
//
// Design: one warp per ray. Lanes take 32 consecutive samples at a time,
// so every load is coalesced; the exclusive product of (1 - alpha + 1e-7)
// is a warp scan carried across the 32-sample chunks; the weighted sums
// are warp reductions. Results differ from a serial cumprod by the
// association of the product (~1e-6 relative).
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
