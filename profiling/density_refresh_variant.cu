// Kernel I2f (occupancy_grid.cu) in the forms and shapes the port measured
// against its own, for measurement only. Forms: 0 kernel If's SIMT
// evaluation (sdf_net.cuh) at hidden width 64, the weights (~46 KB) staged
// in shared memory by every block with plain loads; 1 form 0 staged by
// cp.async (every copy of a thread in flight at once); 2 the three 64-wide
// layers on the tensor cores (mma.sync TF32 in the 3xTF32 split, as
// density_net.cuh), the weights staged by cp.async; 3 the port's kernel
// (the tensor cores, the weights read through the L1 cache and not
// staged); 4 form 3 and 5 form 2 with a warp's levels encoded in batches of
// three (the simplices first, then all their gathers, then the blends:
// encode_level's float operations, up to 12 gathers of a lane in flight);
// 6 form 0's evaluation with the weights read through the L1 cache and not
// staged. Shapes: 2, 4 or 8 warps a tile of 32 probes, and one block for
// every `tiles_per_block` tiles, each block taking its tiles one after
// another (1: one block a tile). Forms 0, 1 and 6 write one grid bit for
// bit, forms 2-5 another (the tensor cores' sums); the two agree within
// float rounding. Built and timed by profiling/density_refresh_designs.py
// and run by the CPU tests; no path of the port calls it.
#include "occupancy_grid.cu"

namespace {

// Form 0: sdf_at<kWarps, 64> on the weights stage_net<64> staged.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32) density_refresh_simt_kernel(
    int n, uint32_t update_idx, int V, uint32_t lin_mask, float voxel_size, float half_extent,
    float tx, float ty, float tz, const float* __restrict__ jitter, DensityNet net, int n_in,
    float decay, float thresh, float* __restrict__ values, uint8_t* __restrict__ occupancy) {
  float* sw = psdf_dynamic_smem<float>();
  stage_net<kDensityHid>(net, n_in, sw);
  float* xt = sw + net_floats<kDensityHid>(n_in);
  const int n_tiles = (n + 31) / 32;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int k = tile * 32 + (threadIdx.x & 31);
    const bool real = k < n;
    float p[3] = {0.f, 0.f, 0.f};
    uint32_t lin = 0;
    if (real)
      lin = grid_probe(k, n, update_idx, V, lin_mask, voxel_size, half_extent, tx, ty, tz,
                       jitter, p);
    const float x = sdf_at<kWarps, kDensityHid>(net, n_in, sw, xt, p, real);
    if (real && threadIdx.x < 32) {
      const float d = softplus_torch(x);
      const float old = values[lin] * decay;
      const float v = (d != d || old != old) ? d + old : fmaxf(d, old);
      values[lin] = v;
      occupancy[lin] = v > thresh ? 1 : 0;
    }
  }
}

// Form 1's staging: sdf_net.cuh's stage_net<64> for a density net (K = L:
// W0's rows are contiguous), W0, W1 and W2 by 16-byte cp.async where the
// addresses allow, the rest by plain loads.
__device__ __forceinline__ void stage_density_async(const DensityNet& net, int n_in,
                                                    float* __restrict__ sw) {
  constexpr int kH = kDensityHid;
  float* w0 = sw;
  float* w1 = w0 + n_in * kH;
  float* w2 = w1 + kH * kH;
  float* b0 = w2 + kH * kH;
  const bool vec = (((uintptr_t)net.w0 | (uintptr_t)net.w1 | (uintptr_t)net.w2) & 15) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < n_in * kH / 4; i += blockDim.x)
      psdf_cp_async16(w0 + 4 * i, net.w0 + 4 * i);
    for (int i = threadIdx.x; i < kH * kH / 4; i += blockDim.x) {
      psdf_cp_async16(w1 + 4 * i, net.w1 + 4 * i);
      psdf_cp_async16(w2 + 4 * i, net.w2 + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < n_in * kH; i += blockDim.x) w0[i] = net.w0[i];
    for (int i = threadIdx.x; i < kH * kH; i += blockDim.x) {
      w1[i] = net.w1[i];
      w2[i] = net.w2[i];
    }
  }
  for (int i = threadIdx.x; i < kH; i += blockDim.x) {
    b0[i] = net.b0[i];
    b0[kH + i] = net.b1[i];
    b0[2 * kH + i] = net.b2[i];
    b0[3 * kH + i] = net.w3[i * net.w3_cols];
  }
  if (threadIdx.x == 0) b0[4 * kH] = net.b3[0];
  psdf_cp_async_wait();
  __syncthreads();
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32) density_refresh_async_kernel(
    int n, uint32_t update_idx, int V, uint32_t lin_mask, float voxel_size, float half_extent,
    float tx, float ty, float tz, const float* __restrict__ jitter, DensityNet net, int n_in,
    float decay, float thresh, float* __restrict__ values, uint8_t* __restrict__ occupancy) {
  float* sw = psdf_dynamic_smem<float>();
  stage_density_async(net, n_in, sw);
  float* xt = sw + net_floats<kDensityHid>(n_in);
  const int n_tiles = (n + 31) / 32;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int k = tile * 32 + (threadIdx.x & 31);
    const bool real = k < n;
    float p[3] = {0.f, 0.f, 0.f};
    uint32_t lin = 0;
    if (real)
      lin = grid_probe(k, n, update_idx, V, lin_mask, voxel_size, half_extent, tx, ty, tz,
                       jitter, p);
    const float x = sdf_at<kWarps, kDensityHid>(net, n_in, sw, xt, p, real);
    if (real && threadIdx.x < 32) {
      const float d = softplus_torch(x);
      const float old = values[lin] * decay;
      const float v = (d != d || old != old) ? d + old : fmaxf(d, old);
      values[lin] = v;
      occupancy[lin] = v > thresh ? 1 : 0;
    }
  }
}

// Forms 2 and 5's shared memory (floats): the weights W0 (density_k0
// rows, zero-padded), W1, W2 at a row stride of kMmaWS (= 8 mod 32, so a
// warp's B fragment hits 32 banks), b0, b1, b2, W3's column 0 and b3; then
// a tile's two activation buffers (density_net.cuh).
constexpr int kMmaWS = 72;

__host__ __device__ __forceinline__ int mma_weight_floats(int n_in) {
  return (density_k0(n_in) + 2 * kDensityHid) * kMmaWS + 4 * kDensityHid + 4;
}
__host__ __forceinline__ size_t mma_smem_bytes(int n_in) {
  return sizeof(float) * (size_t)mma_weight_floats(n_in) + density_smem_bytes(n_in);
}

__device__ __forceinline__ void stage_density_mma(const DensityNet& net, int n_in,
                                                  float* __restrict__ sw) {
  constexpr int kH = kDensityHid;
  const int k0 = density_k0(n_in);
  float* w0 = sw;
  float* w1 = w0 + k0 * kMmaWS;
  float* w2 = w1 + kH * kMmaWS;
  float* b0 = w2 + kH * kMmaWS;
  const bool vec = (((uintptr_t)net.w0 | (uintptr_t)net.w1 | (uintptr_t)net.w2) & 15) == 0;
  // a row of 64 floats is 16 chunks of 16 bytes
  for (int i = threadIdx.x; i < (n_in + 2 * kH) * 16; i += blockDim.x) {
    const int row = i >> 4, c = (i & 15) * 4;
    const float* src = row < n_in ? net.w0 + row * kH
                                  : (row < n_in + kH ? net.w1 + (row - n_in) * kH
                                                     : net.w2 + (row - n_in - kH) * kH);
    float* dst = row < n_in ? w0 + row * kMmaWS
                            : (row < n_in + kH ? w1 + (row - n_in) * kMmaWS
                                               : w2 + (row - n_in - kH) * kMmaWS);
    if (vec) {
      psdf_cp_async16(dst + c, src + c);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[c + j] = src[c + j];
    }
  }
  for (int i = threadIdx.x; i < (k0 - n_in) * kMmaWS; i += blockDim.x)
    w0[n_in * kMmaWS + i] = 0.f;
  for (int i = threadIdx.x; i < kH; i += blockDim.x) {
    b0[i] = net.b0[i];
    b0[kH + i] = net.b1[i];
    b0[2 * kH + i] = net.b2[i];
    b0[3 * kH + i] = net.w3[i * net.w3_cols];
  }
  if (threadIdx.x == 0) b0[4 * kH] = net.b3[0];
  psdf_cp_async_wait();
  __syncthreads();
}

// Levels w, w + kWarps, ... of point p into row[2 l], row[2 l + 1], in
// batches of three levels: the three simplices, then their 12 gathers, then
// the blends, each level's float operations encode_level's.
template <int kWarps>
__device__ __forceinline__ void encode_levels_batched(const float (&p)[3], const DensityNet& net,
                                                      int w, float* __restrict__ row) {
  const uint32_t cap_mask = (uint32_t)(net.capacity - 1);
  for (int l0 = w; l0 < net.L; l0 += 3 * kWarps) {
    Simplex<3> sx[3];
    float2 v[3][4];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int l = l0 + j * kWarps;
      if (l < net.L) {
        float lat[3];
        lattice_point<3>(p, net.shift, net.scales, l, lat);
        find_simplex<3>(lat, net.E, cap_mask, sx[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int l = l0 + j * kWarps;
      if (l < net.L) {
        const float2* t = net.table + (long long)l * net.capacity;
#pragma unroll
        for (int r = 0; r < 4; ++r) v[j][r] = __ldg(t + sx[j].slot[r]);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int l = l0 + j * kWarps;
      if (l < net.L) {
        float f0 = sx[j].bary[0] * v[j][0].x;
        float f1 = sx[j].bary[0] * v[j][0].y;
#pragma unroll
        for (int r = 1; r < 4; ++r) {
          f0 = f0 + sx[j].bary[r] * v[j][r].x;
          f1 = f1 + sx[j].bary[r] * v[j][r].y;
        }
        if (net.window != nullptr) {
          f0 = f0 * net.window[l];
          f1 = f1 * net.window[l];
        }
        row[2 * l] = f0;
        row[2 * l + 1] = f1;
      }
    }
  }
}

// density_layer with the weights and bias staged: W [.][kMmaWS].
template <int kNT>
__device__ __forceinline__ void staged_layer(const float* __restrict__ X, int xs, int ksteps,
                                             const float* __restrict__ W,
                                             const float* __restrict__ bias,
                                             float* __restrict__ H, int m0, int n0) {
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
      const float* wb = W + (k + t) * kMmaWS + n0 + 8 * j + g;
      uint32_t bb[2], bs[2];
      tf32_split(wb[0], bb[0], bs[0]);
      tf32_split(wb[4 * kMmaWS], bb[1], bs[1]);
      psdf_mma_tf32(acc[j], as, bb);
      psdf_mma_tf32(acc[j], ab, bs);
      psdf_mma_tf32(acc[j], ab, bb);
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    H[(m0 + g) * xs + c] = gelu_tanh(acc[j][0] + bias[c]);
    H[(m0 + g) * xs + c + 1] = gelu_tanh(acc[j][1] + bias[c + 1]);
    H[(m0 + g + 8) * xs + c] = gelu_tanh(acc[j][2] + bias[c]);
    H[(m0 + g + 8) * xs + c + 1] = gelu_tanh(acc[j][3] + bias[c + 1]);
  }
}

// Forms 2, 4 and 5: density_at's tile with the weights staged (kStaged)
// and the levels encoded in batches (kBatched).
template <int kWarps, bool kStaged, bool kBatched>
__global__ void __launch_bounds__(kWarps * 32) density_refresh_mma_kernel(
    int n, uint32_t update_idx, int V, uint32_t lin_mask, float voxel_size, float half_extent,
    float tx, float ty, float tz, const float* __restrict__ jitter, DensityNet net, int n_in,
    float decay, float thresh, float* __restrict__ values, uint8_t* __restrict__ occupancy) {
  constexpr int kH = kDensityHid;
  constexpr int kNT = kH / 8 / (kWarps / 2);  // n-tiles a warp: 2 m-tiles of 16 rows
  static_assert(kNT >= 1 && kNT * 8 * (kWarps / 2) == kH, "warps split the 64 columns");
  float* sw = psdf_dynamic_smem<float>();
  const int k0 = density_k0(n_in), xs = density_xs(n_in);
  const float *w0, *w1, *w2, *b0, *b1, *b2;
  float* xt;  // inputs, then layer 1's outputs
  if constexpr (kStaged) {
    stage_density_mma(net, n_in, sw);
    w0 = sw;
    w1 = w0 + k0 * kMmaWS;
    w2 = w1 + kH * kMmaWS;
    b0 = w2 + kH * kMmaWS;
    b1 = b0 + kH;
    b2 = b1 + kH;
    xt = sw + mma_weight_floats(n_in);
  } else {
    w0 = net.w0;
    w1 = net.w1;
    w2 = net.w2;
    b0 = net.b0;
    b1 = net.b1;
    b2 = net.b2;
    xt = sw;
  }
  float* ht = xt + 32 * xs;                  // layer 0's and 2's outputs
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int m0 = (w & 1) * 16, n0 = (w >> 1) * kNT * 8;
  const int n_tiles = (n + 31) / 32;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {  // block-uniform
    const int k = tile * 32 + lane;
    const bool real = k < n;
    float p[3] = {0.f, 0.f, 0.f};
    uint32_t lin = 0;
    if (real)
      lin = grid_probe(k, n, update_idx, V, lin_mask, voxel_size, half_extent, tx, ty, tz,
                       jitter, p);
    float* row = xt + lane * xs;
    if (real) {
      if constexpr (kBatched) {
        encode_levels_batched<kWarps>(p, net, w, row);
      } else {
        for (int l = w; l < net.L; l += kWarps) {
          float f0, f1;
          encode_level<3>(p, net.table, net.capacity, net.shift, net.scales, net.window, net.E,
                          l, f0, f1);
          row[2 * l] = f0;
          row[2 * l + 1] = f1;
        }
      }
    }
    if (w == kWarps - 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) row[2 * net.L + c] = p[c] * net.concat_scaling;
      for (int c = n_in; c < k0; ++c) row[c] = 0.f;
    }
    __syncthreads();
    if constexpr (kStaged) {
      staged_layer<kNT>(xt, xs, k0 / 8, w0, b0, ht, m0, n0);
      __syncthreads();
      staged_layer<kNT>(ht, xs, kH / 8, w1, b1, xt, m0, n0);
      __syncthreads();
      staged_layer<kNT>(xt, xs, kH / 8, w2, b2, ht, m0, n0);
    } else {
      density_layer<kNT>(xt, xs, k0 / 8, w0, n_in, b0, ht, m0, n0);
      __syncthreads();
      density_layer<kNT>(ht, xs, kH / 8, w1, kH, b1, xt, m0, n0);
      __syncthreads();
      density_layer<kNT>(xt, xs, kH / 8, w2, kH, b2, ht, m0, n0);
    }
    __syncthreads();
    if (w == 0 && real) {
      float s = 0.f;
      if constexpr (kStaged) {
        const float* w3 = b0 + 3 * kH;
        for (int i = 0; i < kH; ++i) s = fmaf(ht[lane * xs + i], w3[i], s);
        s = s + w3[kH];
      } else {
        for (int i = 0; i < kH; ++i)
          s = fmaf(ht[lane * xs + i], __ldg(net.w3 + i * net.w3_cols), s);
        s = s + __ldg(net.b3);
      }
      const float d = softplus_torch(s);
      const float old = values[lin] * decay;
      const float v = (d != d || old != old) ? d + old : fmaxf(d, old);
      values[lin] = v;
      occupancy[lin] = v > thresh ? 1 : 0;
    }
  }
}

// Form 6: sdf_at<kWarps, 64> with W0, W1, W2 and the biases read from
// global memory (the same float operations: bit for bit form 0's).
template <int kWarps>
__device__ __forceinline__ float density_at_global(const DensityNet& net, int n_in,
                                                   float* __restrict__ xt, const float (&p)[3],
                                                   bool active) {
  constexpr int kH = kDensityHid;
  constexpr int kUnits = kH / kWarps;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  float* h0 = xt + n_in * 32;
  float* h1 = h0 + kH * 32;
  if (active) {
    for (int l = w; l < net.L; l += kWarps) {
      float f0, f1;
      encode_level<3>(p, net.table, net.capacity, net.shift, net.scales, net.window, net.E, l,
                      f0, f1);
      xt[(2 * l) * 32 + lane] = f0;
      xt[(2 * l + 1) * 32 + lane] = f1;
    }
    if (w == kWarps - 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) xt[(2 * net.L + c) * 32 + lane] = p[c] * net.concat_scaling;
    }
  }
  __syncthreads();
  const int u0 = w * kUnits;
  float h[kUnits];
  layer_units<kWarps, kH>(xt, n_in, lane, net.w0, net.b0, u0, h);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) h0[(u0 + u) * 32 + lane] = h[u];
  __syncthreads();
  layer_units<kWarps, kH>(h0, kH, lane, net.w1, net.b1, u0, h);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) h1[(u0 + u) * 32 + lane] = h[u];
  __syncthreads();
  layer_units<kWarps, kH>(h1, kH, lane, net.w2, net.b2, u0, h);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) h0[(u0 + u) * 32 + lane] = h[u];
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < kH; ++i) s = fmaf(h0[i * 32 + lane], __ldg(net.w3 + i * net.w3_cols), s);
  return s + __ldg(net.b3);
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32) density_refresh_global_kernel(
    int n, uint32_t update_idx, int V, uint32_t lin_mask, float voxel_size, float half_extent,
    float tx, float ty, float tz, const float* __restrict__ jitter, DensityNet net, int n_in,
    float decay, float thresh, float* __restrict__ values, uint8_t* __restrict__ occupancy) {
  float* xt = psdf_dynamic_smem<float>();
  const int n_tiles = (n + 31) / 32;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int k = tile * 32 + (threadIdx.x & 31);
    const bool real = k < n;
    float p[3] = {0.f, 0.f, 0.f};
    uint32_t lin = 0;
    if (real)
      lin = grid_probe(k, n, update_idx, V, lin_mask, voxel_size, half_extent, tx, ty, tz,
                       jitter, p);
    const float x = density_at_global<kWarps>(net, n_in, xt, p, real);
    if (real && threadIdx.x < 32) {
      const float d = softplus_torch(x);
      const float old = values[lin] * decay;
      const float v = (d != d || old != old) ? d + old : fmaxf(d, old);
      values[lin] = v;
      occupancy[lin] = v > thresh ? 1 : 0;
    }
  }
}

template <int kWarps, int kForm>
int launch_design(int n, unsigned int update_idx, int V, float voxel_size, float half_extent,
                  float tx, float ty, float tz, const void* jitter, const DensityNet* net_ptr,
                  float decay, float thresh, void* values, void* occupancy, int grid,
                  void* stream) {
  if constexpr (kForm == 3) {
    return launch_density_refresh<kWarps>(n, update_idx, V, voxel_size, half_extent, tx, ty, tz,
                                          jitter, net_ptr, decay, thresh, values, occupancy,
                                          grid, stream);
  } else {
    const long long nv = (long long)V * V * V;
    if ((nv & (nv - 1)) != 0 || nv > (1ll << 31) || n < 0 || n > nv || grid < 0 ||
        net_ptr == nullptr || !net_ok(*net_ptr) || net_ptr->K != net_ptr->L)
      return (int)cudaErrorInvalidValue;
    const int n_tiles = psdf_blocks(n, 32);
    if (n_tiles == 0) return 0;
    const DensityNet net = *net_ptr;
    const int n_in = 2 * net.L + 3;
    const auto kernel = kForm == 0   ? density_refresh_simt_kernel<kWarps>
                        : kForm == 1 ? density_refresh_async_kernel<kWarps>
                        : kForm == 2 ? density_refresh_mma_kernel<kWarps, true, false>
                        : kForm == 4 ? density_refresh_mma_kernel<kWarps, false, true>
                        : kForm == 5 ? density_refresh_mma_kernel<kWarps, true, true>
                                     : density_refresh_global_kernel<kWarps>;
    const size_t smem = kForm <= 1   ? net_smem_bytes<kDensityHid>(n_in)
                        : kForm == 4 ? density_smem_bytes(n_in)
                        : kForm == 6 ? sizeof(float) * tile_floats<kDensityHid>(n_in)
                                     : mma_smem_bytes(n_in);
    if (smem > 48 * 1024) {
      const int err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != 0) return err;
    }
    PSDF_LAUNCH(kernel, grid > 0 ? min(grid, n_tiles) : n_tiles, kWarps * 32, smem, stream, n,
                (uint32_t)update_idx, V, (uint32_t)(nv - 1), voxel_size, half_extent, tx, ty,
                tz, (const float*)jitter, net, n_in, decay, thresh, (float*)values,
                (uint8_t*)occupancy);
    return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" int psdf_density_refresh_design(int n, unsigned int update_idx, int V,
                                           float voxel_size, float half_extent, float tx,
                                           float ty, float tz, const void* jitter,
                                           const DensityNet* net, float decay, float thresh,
                                           void* values, void* occupancy, int form, int warps,
                                           int tiles_per_block, void* stream) {
  if (tiles_per_block < 1) return (int)cudaErrorInvalidValue;
  const int grid = tiles_per_block == 1 ? 0 : psdf_blocks(psdf_blocks(n, 32), tiles_per_block);
#define PSDF_DESIGN(W, F)                                                                  \
  if (warps == W && form == F)                                                             \
    return launch_design<W, F>(n, update_idx, V, voxel_size, half_extent, tx, ty, tz, jitter, \
                               net, decay, thresh, values, occupancy, grid, stream);
  PSDF_DESIGN(4, 0)
  PSDF_DESIGN(8, 0)
  PSDF_DESIGN(4, 1)
  PSDF_DESIGN(8, 1)
  PSDF_DESIGN(4, 2)
  PSDF_DESIGN(8, 2)
  PSDF_DESIGN(4, 3)
  PSDF_DESIGN(8, 3)
  PSDF_DESIGN(4, 4)
  PSDF_DESIGN(8, 4)
  PSDF_DESIGN(4, 5)
  PSDF_DESIGN(8, 5)
  PSDF_DESIGN(2, 3)
  PSDF_DESIGN(4, 6)
  PSDF_DESIGN(8, 6)
#undef PSDF_DESIGN
  return (int)cudaErrorInvalidValue;
}
