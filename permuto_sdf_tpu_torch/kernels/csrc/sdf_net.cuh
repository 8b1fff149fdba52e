// The flagship SDF evaluated inside a launch, shared by the sphere tracers'
// kernels J3f and J2f (sphere_trace.cu) and the grid refresh's kernel If
// (occupancy_grid.cu): the weights staged in shared memory once a block,
// then per tile of 32 points (lane = point) the encoding's K coarsest
// levels (kernel A's code, permuto_lattice.cuh), the point columns and the
// MLP [2L + 3, 32, 32, 32, w3_cols] with tanh GELU, split among the block's
// warps. It replaces models/fields.py:113 `sdf_apply(...)[0]` inside those
// launches (the JAX package leaves it to XLA). The helpers take the hidden
// width kH (32 by default): the SIMT forms of kernel I2f that the port
// measured (profiling/density_refresh_variant.cu) run them at 64 on NeRF's
// density field; the port's I2f evaluates it on the tensor cores
// (density_net.cuh).
//
// Per evaluation: K levels of A's lattice math and 4 gathers of 8 bytes,
// and the MLP's ~7.4 kFLOP at K = 24 (51 x 32 + 2 x 32 x 32 + 32 products),
// float32 on the SIMT units (TF32 stays off, as for the plain version's
// matmuls). The warps split the levels, then each layer's hidden units
// (kH / kWarps a warp), which pass through shared memory (two buffers,
// four block barriers an evaluation); every warp sums the last layer on
// the same values, so the warps take the same branches. The weights are
// read as shared-memory broadcasts, four units a 16-byte load; each unit's
// sum runs over its inputs in order with fmaf, which the plain version's
// matmuls block differently (float rounding only). The features are A's
// bit for bit.
#pragma once

#include "permuto_lattice.cuh"

// The flagship SDF's tensors: models/fields.py::sdf_apply(...)[0] on the K
// coarsest levels reads W0's rows [0, 2K) and [2L, 2L + 3) and the last
// layer's column 0. Mirrored by ops/sdf_net.py::SdfNet; the entry points
// take a pointer to it and pass it to the kernels by value. NeRF's density
// field (DensityNet, ops/sdf_net.py::DensityNet) has the same tensors at
// hidden width 64, with K = L.
struct SdfNet {
  const float2* table;  // the interleaved [L, C, 2] copy of the table
  const float* shift;   // [L, 3]
  const float* scales;  // [L]
  const float* window;  // [L], or null
  const float* E;       // [4, 3]
  const float* w0;      // [2L + 3, H] (H the hidden width: 32, or 64 for NeRF's density)
  const float* b0;      // [H]
  const float* w1;      // [H, H]
  const float* b1;      // [H]
  const float* w2;      // [H, H]
  const float* b2;      // [H]
  const float* w3;      // [H, w3_cols]
  const float* b3;      // [w3_cols]
  int capacity, L, K, w3_cols;
  float concat_scaling;
};
using DensityNet = SdfNet;

namespace {

constexpr int kHid = 32;  // the SDF MLP's hidden width
constexpr int kDensityHid = 64;  // NeRF's density MLP's hidden width

// Shared floats of the staged weights: W0's n_in = 2K + 3 rows, W1, W2,
// b0, b1, b2, W3's column 0, b3 (padded to 16 bytes).
template <int kH = kHid>
__host__ __device__ __forceinline__ int net_floats(int n_in) {
  return n_in * kH + 2 * kH * kH + 4 * kH + 4;
}

// Shared floats of a block's tile of 32 points: the inputs [n_in][32] and
// two buffers of hidden units [2][kH][32], one column per lane.
template <int kH = kHid>
__host__ __device__ __forceinline__ int tile_floats(int n_in) {
  return n_in * 32 + 2 * kH * 32;
}

// A block's shared memory: the staged weights and one tile.
template <int kH = kHid>
__host__ __forceinline__ size_t net_smem_bytes(int n_in) {
  return sizeof(float) * (size_t)(net_floats<kH>(n_in) + tile_floats<kH>(n_in));
}

// Whether the kernels can evaluate `net` (K of L levels, a power-of-two
// table).
static bool net_ok(const SdfNet& net) {
  return net.K >= 1 && net.K <= net.L && net.w3_cols >= 1 && net.capacity > 0 &&
         (net.capacity & (net.capacity - 1)) == 0;
}

// GELU, tanh form (torch.nn.functional.gelu(approximate="tanh")).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// Stages the block's copy of the weights (every thread of the block).
template <int kH = kHid>
__device__ __forceinline__ void stage_net(const SdfNet& net, int n_in, float* __restrict__ sw) {
  float* w0 = sw;
  float* w1 = w0 + n_in * kH;
  float* w2 = w1 + kH * kH;
  float* b0 = w2 + kH * kH;
  for (int i = threadIdx.x; i < n_in * kH; i += blockDim.x) {
    const int row = i / kH;
    const int src = row < 2 * net.K ? row : 2 * net.L + (row - 2 * net.K);
    w0[i] = net.w0[src * kH + (i - row * kH)];
  }
  for (int i = threadIdx.x; i < kH * kH; i += blockDim.x) {
    w1[i] = net.w1[i];
    w2[i] = net.w2[i];
  }
  for (int i = threadIdx.x; i < kH; i += blockDim.x) {
    b0[i] = net.b0[i];
    b0[kH + i] = net.b1[i];
    b0[2 * kH + i] = net.b2[i];
    b0[3 * kH + i] = net.w3[i * net.w3_cols];
  }
  if (threadIdx.x == 0) b0[4 * kH] = net.b3[0];
  __syncthreads();
}

// The calling warp's kH / kWarps units of one layer for the calling
// lane: h[u] = gelu(sum_i x_i W[i][u0 + u] + b[u0 + u]), the sum over i in
// order (fmaf); x_i = in[i * 32 + lane], the weights read as shared-memory
// broadcasts, 4 units a load.
template <int kWarps, int kH = kHid>
__device__ __forceinline__ void layer_units(const float* __restrict__ in, int n, int lane,
                                            const float* __restrict__ W,
                                            const float* __restrict__ b, int u0,
                                            float (&h)[kH / kWarps]) {
  constexpr int kUnits = kH / kWarps;
  static_assert(kUnits % 4 == 0, "a warp's units are read four a load");
  float acc[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) acc[u] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float x = in[i * 32 + lane];
    const float4* wr = reinterpret_cast<const float4*>(W + i * kH + u0);
#pragma unroll
    for (int q = 0; q < kUnits / 4; ++q) {
      const float4 v = wr[q];
      acc[4 * q] = fmaf(x, v.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(x, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(x, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(x, v.w, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u) h[u] = gelu_tanh(acc[u] + b[u0 + u]);
}

// The SDF at the calling lane's point p (column 0 of the MLP's last layer
// plus b3[0]), called by every warp of a block of
// kWarps warps with the same points: the warps split the levels and then
// each layer's hidden units, which pass through the tile's two buffers
// (four block barriers an evaluation), and every warp sums the last layer.
// Lanes that are not `active` skip the encoding (the MLP runs for all 32);
// their value is not used. Every warp returns the same value.
template <int kWarps, int kH = kHid>
__device__ __forceinline__ float sdf_at(const SdfNet& net, int n_in, const float* __restrict__ sw,
                                        float* __restrict__ xt, const float (&p)[3],
                                        bool active) {
  constexpr int kUnits = kH / kWarps;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const float* w0 = sw;
  const float* w1 = w0 + n_in * kH;
  const float* w2 = w1 + kH * kH;
  const float* b0 = w2 + kH * kH;
  const float* b1 = b0 + kH;
  const float* b2 = b1 + kH;
  const float* w3 = b2 + kH;
  const float b3 = w3[kH];
  float* h0 = xt + n_in * 32;
  float* h1 = h0 + kH * 32;
  if (active) {
    for (int l = w; l < net.K; l += kWarps) {
      float f0, f1;
      encode_level<3>(p, net.table, net.capacity, net.shift, net.scales, net.window, net.E, l,
                      f0, f1);
      xt[(2 * l) * 32 + lane] = f0;
      xt[(2 * l + 1) * 32 + lane] = f1;
    }
    if (w == kWarps - 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) xt[(2 * net.K + c) * 32 + lane] = p[c] * net.concat_scaling;
    }
  }
  __syncthreads();
  const int u0 = w * kUnits;
  float h[kUnits];
  layer_units<kWarps, kH>(xt, n_in, lane, w0, b0, u0, h);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) h0[(u0 + u) * 32 + lane] = h[u];
  __syncthreads();
  layer_units<kWarps, kH>(h0, kH, lane, w1, b1, u0, h);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) h1[(u0 + u) * 32 + lane] = h[u];
  __syncthreads();
  layer_units<kWarps, kH>(h1, kH, lane, w2, b2, u0, h);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) h0[(u0 + u) * 32 + lane] = h[u];
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < kH; ++i) s = fmaf(h0[i * 32 + lane], w3[i], s);
  return s + b3;
}

}  // namespace
