// NeRF's density field evaluated inside a launch, for the grid refresh's
// kernel I2f (occupancy_grid.cu): per tile of 32 points (lane = point) the
// encoding's L levels (kernel A's code, permuto_lattice.cuh), the point
// columns, and the MLP [2L + 3, 64, 64, 64] with tanh GELU on the tensor
// cores, then column 0 of the last layer plus b3[0]. It replaces
// models/fields.py:286 `nerf_hash_density` before its softplus inside that
// launch (the JAX package leaves it to XLA).
//
// The three 64-wide layers are mma.sync m16n8k8 TF32 products in the
// 3xTF32 split: x = x_big + x_small (each rounded to TF32), and d +=
// a_small b_big + a_big b_small + a_big b_big, accumulated in float32. It
// drops a_small b_small (~2^-22 of a product) and sums in the tensor
// cores' order, so a density agrees with the plain version's float32
// matmuls within float rounding (TF32 alone, 10 mantissa bits, stays off,
// as for the plain version). The warps split the levels, then the layers'
// output tiles: 2 row tiles of 16 points x 64 / 8 / (kWarps / 2) column
// tiles of 8 a warp. The weights are read through the L1 cache and not
// staged, so a block holds only a tile's activations (two buffers of 32
// rows, ~17 KB) and many blocks share a multiprocessor, which hides the
// encoding's gathers. The features are A's bit for bit.
#pragma once

#include "sdf_net.cuh"

namespace {

// The activations' row stride (floats): at least the inputs' columns k0 =
// n_in rounded up to 8 and the 64 hidden units, and 4 mod 32, so the
// A-fragment loads of a warp (rows g, columns t) hit 32 banks.
__host__ __device__ __forceinline__ int density_k0(int n_in) { return (n_in + 7) & ~7; }
__host__ __device__ __forceinline__ int density_xs(int n_in) {
  return ((max(density_k0(n_in), kDensityHid) - 4 + 31) / 32) * 32 + 4;
}

// A block's shared memory: a tile's two activation buffers.
__host__ __forceinline__ size_t density_smem_bytes(int n_in) {
  return sizeof(float) * (size_t)(2 * 32 * density_xs(n_in));
}

// x = big + small, each a TF32 bit pattern
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = psdf_tf32(x);
  small = psdf_tf32(x - __uint_as_float(big));
}

// One 64-wide layer of a tile: the calling warp's 16 rows from m0 and kNT
// column tiles of 8 from n0 of H = gelu(X W + b). X [32][xs] holds ksteps x
// 8 columns; W [k_rows][64] and b [64] are in global memory, W's rows from
// k_rows on read as zero.
template <int kNT>
__device__ __forceinline__ void density_layer(const float* __restrict__ X, int xs, int ksteps,
                                              const float* __restrict__ W, int k_rows,
                                              const float* __restrict__ bias,
                                              float* __restrict__ H, int m0, int n0) {
  constexpr int kH = kDensityHid;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const float* xa = X + (m0 + g) * xs + t;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 8;
    uint32_t ab[4], as[4];
    tf32_split(xa[k], ab[0], as[0]);
    tf32_split(xa[8 * xs + k], ab[1], as[1]);
    tf32_split(xa[k + 4], ab[2], as[2]);
    tf32_split(xa[8 * xs + k + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* wb = W + (k + t) * kH + n0 + 8 * j + g;
      uint32_t bb[2], bs[2];
      tf32_split(k + t < k_rows ? __ldg(wb) : 0.f, bb[0], bs[0]);
      tf32_split(k + t + 4 < k_rows ? __ldg(wb + 4 * kH) : 0.f, bb[1], bs[1]);
      psdf_mma_tf32(acc[j], as, bb);
      psdf_mma_tf32(acc[j], ab, bs);
      psdf_mma_tf32(acc[j], ab, bb);
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
    H[(m0 + g) * xs + c] = gelu_tanh(acc[j][0] + b0);
    H[(m0 + g) * xs + c + 1] = gelu_tanh(acc[j][1] + b1);
    H[(m0 + g + 8) * xs + c] = gelu_tanh(acc[j][2] + b0);
    H[(m0 + g + 8) * xs + c + 1] = gelu_tanh(acc[j][3] + b1);
  }
}

// The density field's raw value (column 0 of the last layer plus b3[0])
// at the calling lane's point p, called by every warp of a block of kWarps
// warps with the same points (xt: a tile's two activation buffers, 2 x 32
// rows of density_xs(n_in)); four block barriers an evaluation. Lanes that
// are not `active` skip the encoding; their rows are not used. The value is
// returned to warp 0's lanes (the other warps return 0).
template <int kWarps>
__device__ __forceinline__ float density_at(const DensityNet& net, int n_in,
                                            float* __restrict__ xt, const float (&p)[3],
                                            bool active) {
  constexpr int kH = kDensityHid;
  constexpr int kNT = kH / 8 / (kWarps / 2);
  static_assert(kWarps % 2 == 0 && kNT * 8 * (kWarps / 2) == kH,
                "the warps split 2 row tiles x 64 columns");
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int k0 = density_k0(n_in), xs = density_xs(n_in);
  const int m0 = (w & 1) * 16, n0 = (w >> 1) * kNT * 8;
  float* ht = xt + 32 * xs;  // layer 0's and 2's outputs; xt: the inputs, then layer 1's
  float* row = xt + lane * xs;
  if (active) {
    for (int l = w; l < net.L; l += kWarps) {
      float f0, f1;
      encode_level<3>(p, net.table, net.capacity, net.shift, net.scales, net.window, net.E, l,
                      f0, f1);
      row[2 * l] = f0;
      row[2 * l + 1] = f1;
    }
  }
  if (w == kWarps - 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) row[2 * net.L + c] = p[c] * net.concat_scaling;
    for (int c = n_in; c < k0; ++c) row[c] = 0.f;
  }
  __syncthreads();
  density_layer<kNT>(xt, xs, k0 / 8, net.w0, n_in, net.b0, ht, m0, n0);
  __syncthreads();
  density_layer<kNT>(ht, xs, kH / 8, net.w1, kH, net.b1, xt, m0, n0);
  __syncthreads();
  density_layer<kNT>(xt, xs, kH / 8, net.w2, kH, net.b2, ht, m0, n0);
  __syncthreads();
  float s = 0.f;
  if (w == 0) {
    for (int i = 0; i < kH; ++i) s = fmaf(ht[lane * xs + i], __ldg(net.w3 + i * net.w3_cols), s);
    s = s + __ldg(net.b3);
  }
  return s;
}

}  // namespace
