// Kernels A and B: permutohedral hash encoding, forward and point gradient.
//
// Replaces: permuto_sdf_tpu/ops/permuto_encoding.py:504 `permuto_encode`
// (with `_simplex_nminor` :276, the hash :551-556 and `row2_gather_pair`
// :458) -- kernel A -- and the point VJP of that op which
// permuto_sdf_tpu/models/fields.py:167 `_sdf_with_gradient_rev` takes --
// kernel B. The JAX package leaves both to XLA (no Pallas kernel exists:
// a TPU v5e cannot express a gather over 2^18-slot tables).
//
// What bounds them on an H100: bytes. Each (point, level) does ~150 flops
// of lattice math but gathers (d+1) vertices x 2 features of 4 bytes from
// a 2 MiB level table at random slots; each gather costs a 32-byte sector,
// so the kernels are bound by L2/HBM sector traffic of the gathers, with
// the 50 MB full table just about fitting the 50 MB L2.
//
// Design: kernel A runs one thread per (point, level), level minor, so a
// warp writes contiguous output features and shares the point's loads.
// Kernel B runs one thread per point looping over the levels, so the sum
// over levels stays in registers (no atomics). The table stays in the
// parameter layout [L, F=2, C]: a vertex costs two 4-byte loads C apart
// (two sectors). A [L, C, 2] copy would make it one 8-byte load; that is
// left for a later change. Both kernels compute the lattice in exactly the
// float order of the plain PyTorch version (built with --fmad=false), so
// slot ids match it bit for bit.
#include "common.cuh"

namespace {

__device__ __constant__ uint32_t kHashPrimes[6] = {
    2654435761u, 805459861u, 3674653429u, 2097192037u, 1434869437u,
    2165219737u};

template <int D>
struct Simplex {
  int rank[D + 1];
  float bary[D + 1];
  uint32_t slot[D + 1];
};

// Simplex lookup of one point in lattice units (permuto_encoding.py:276):
// elevate, round to the nearest remainder-0 point, rank the differential,
// fix the rounding, barycentric weights, hash the d+1 vertices.
template <int D>
__device__ __forceinline__ void find_simplex(const float (&lat)[D],
                                             const float* __restrict__ E,
                                             uint32_t cap_mask,
                                             Simplex<D>& s) {
  const float dp1 = (float)(D + 1);
  float elevated[D + 1];
  float rem0f[D + 1];
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    float acc = E[i * D] * lat[0];
#pragma unroll
    for (int j = 1; j < D; ++j) acc = acc + E[i * D + j] * lat[j];
    elevated[i] = acc;
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    const float v = elevated[i] / dp1;
    const float up = ceilf(v) * dp1;
    const float down = floorf(v) * dp1;
    rem0f[i] = (up - elevated[i] < elevated[i] - down) ? up : down;
    sum = sum + rem0f[i];
  }
  const int sum_val = (int)(sum / dp1);

  float diff[D + 1];
#pragma unroll
  for (int i = 0; i <= D; ++i) diff[i] = elevated[i] - rem0f[i];
  int rem0[D + 1];
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j <= D; ++j) {
      if (j > i) r += (diff[i] < diff[j]) ? 1 : 0;
      if (j < i) r += (diff[j] >= diff[i]) ? 1 : 0;
    }
    r += sum_val;
    int q = (int)rem0f[i];
    if (r < 0) {
      r += D + 1;
      q += D + 1;
    } else if (r > D) {
      r -= D + 1;
      q -= D + 1;
    }
    s.rank[i] = r;
    rem0[i] = q;
  }

  // bary_full[k] = sum_i delta_i ([d - rank_i == k] - [d + 1 - rank_i == k])
  float bfull[D + 2];
#pragma unroll
  for (int k = 0; k < D + 2; ++k) bfull[k] = 0.f;
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    const float delta = (elevated[i] - (float)rem0[i]) / dp1;
    bfull[D - s.rank[i]] = bfull[D - s.rank[i]] + delta;
    bfull[D + 1 - s.rank[i]] = bfull[D + 1 - s.rank[i]] - delta;
  }
  s.bary[0] = (bfull[0] + 1.0f) + bfull[D + 1];
#pragma unroll
  for (int k = 1; k <= D; ++k) s.bary[k] = bfull[k];

  // vertex keys: key[i] = rem0[i] + r - (d+1)[rank[i] > d - r], i < d
#pragma unroll
  for (int r = 0; r <= D; ++r) {
    uint32_t h = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      int key = rem0[i] + r;
      if (s.rank[i] > D - r) key -= D + 1;
      const uint32_t term = (uint32_t)key * kHashPrimes[i];
      h = (i == 0) ? term : (h ^ term);
    }
    s.slot[r] = h & cap_mask;
  }
}

template <int D>
__device__ __forceinline__ void lattice_point(const float* __restrict__ p,
                                              const float* __restrict__ shift,
                                              const float* __restrict__ scales,
                                              int l, float (&lat)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) lat[j] = p[j] / scales[l] + shift[l * D + j];
}

// Kernel A. out [N, out_stride]: K levels x 2 features (level major,
// feature minor), then the d point columns x concat_scaling if concat.
template <int D>
__global__ void __launch_bounds__(256) encode_fwd_kernel(
    const float* __restrict__ points, int n_points,
    const float* __restrict__ table, int capacity,
    const float* __restrict__ shift, const float* __restrict__ scales,
    const float* __restrict__ window, const float* __restrict__ E, int K,
    float concat_scaling, int concat, float* __restrict__ out,
    int out_stride) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_points * K) return;
  const int n = (int)(idx / K);
  const int l = (int)(idx - (long long)n * K);
  float p[D];
#pragma unroll
  for (int j = 0; j < D; ++j) p[j] = points[(long long)n * D + j];
  float lat[D];
  lattice_point<D>(p, shift, scales, l, lat);
  Simplex<D> s;
  find_simplex<D>(lat, E, (uint32_t)(capacity - 1), s);

  const float* t0 = table + (long long)l * 2 * capacity;
  const float* t1 = t0 + capacity;
  float f0 = s.bary[0] * __ldg(t0 + s.slot[0]);
  float f1 = s.bary[0] * __ldg(t1 + s.slot[0]);
#pragma unroll
  for (int r = 1; r <= D; ++r) {
    f0 = f0 + s.bary[r] * __ldg(t0 + s.slot[r]);
    f1 = f1 + s.bary[r] * __ldg(t1 + s.slot[r]);
  }
  if (window != nullptr) {
    f0 = f0 * window[l];
    f1 = f1 * window[l];
  }
  float* o = out + (long long)n * out_stride;
  o[2 * l] = f0;
  o[2 * l + 1] = f1;
  if (concat && l == 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) o[2 * K + j] = p[j] * concat_scaling;
  }
}

// Kernel B. grad_points [N, D] = d/dpoints of sum(g * encode(points)):
// through the barycentric weights only (gathers and rounding are piecewise
// constant), then E^T and 1/sigma_l, plus concat_scaling * g on the point
// columns. d bary_k / d elevated_i = ([d - rank_i == k] -
// [d + 1 - rank_i == k]) / (d + 1), the k = d + 1 term folded into k = 0.
template <int D>
__global__ void __launch_bounds__(128) encode_point_grad_kernel(
    const float* __restrict__ points, int n_points,
    const float* __restrict__ table, int capacity,
    const float* __restrict__ shift, const float* __restrict__ scales,
    const float* __restrict__ window, const float* __restrict__ E, int K,
    float concat_scaling, int concat, const float* __restrict__ g,
    int g_stride, float* __restrict__ grad_points) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  float p[D];
#pragma unroll
  for (int j = 0; j < D; ++j) p[j] = points[(long long)n * D + j];
  const float* gn = g + (long long)n * g_stride;
  const float dp1 = (float)(D + 1);
  float acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = 0.f;

  for (int l = 0; l < K; ++l) {
    float lat[D];
    lattice_point<D>(p, shift, scales, l, lat);
    Simplex<D> s;
    find_simplex<D>(lat, E, (uint32_t)(capacity - 1), s);
    const float w = (window != nullptr) ? window[l] : 1.0f;
    const float g0 = gn[2 * l] * w;
    const float g1 = gn[2 * l + 1] * w;
    const float* t0 = table + (long long)l * 2 * capacity;
    const float* t1 = t0 + capacity;
    // cotangent of each barycentric weight: sum_f g_f * feat_{r,f}
    float gb[D + 1];
#pragma unroll
    for (int r = 0; r <= D; ++r)
      gb[r] = g0 * __ldg(t0 + s.slot[r]) + g1 * __ldg(t1 + s.slot[r]);
    float gel[D + 1];
#pragma unroll
    for (int i = 0; i <= D; ++i) {
      const int lo = D - s.rank[i];
      const int hi = (D + 1 - s.rank[i]) % (D + 1);
      gel[i] = (gb[lo] - gb[hi]) / dp1;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float gl = E[j] * gel[0];
#pragma unroll
      for (int i = 1; i <= D; ++i) gl = gl + E[i * D + j] * gel[i];
      acc[j] = acc[j] + gl / scales[l];
    }
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float v = acc[j];
    if (concat) v = v + gn[2 * K + j] * concat_scaling;
    grad_points[(long long)n * D + j] = v;
  }
}

}  // namespace

extern "C" int psdf_encode_fwd(int d, const void* points, int n_points,
                               const void* table, int capacity,
                               const void* shift, const void* scales,
                               const void* window, const void* E, int K,
                               float concat_scaling, int concat, void* out,
                               int out_stride, void* stream) {
  const int block = 256;
  const int grid = psdf_blocks((long long)n_points * K, block);
  if (grid == 0) return 0;
#define PSDF_ENC_ARGS                                                        \
  (const float*)points, n_points, (const float*)table, capacity,              \
      (const float*)shift, (const float*)scales, (const float*)window,        \
      (const float*)E, K, concat_scaling, concat, (float*)out, out_stride
  if (d == 3) {
    PSDF_LAUNCH(encode_fwd_kernel<3>, grid, block, 0, stream, PSDF_ENC_ARGS);
  } else if (d == 4) {
    PSDF_LAUNCH(encode_fwd_kernel<4>, grid, block, 0, stream, PSDF_ENC_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSDF_ENC_ARGS
  return (int)cudaGetLastError();
}

extern "C" int psdf_encode_point_grad(int d, const void* points, int n_points,
                                      const void* table, int capacity,
                                      const void* shift, const void* scales,
                                      const void* window, const void* E, int K,
                                      float concat_scaling, int concat,
                                      const void* g, int g_stride,
                                      void* grad_points, void* stream) {
  const int block = 128;
  const int grid = psdf_blocks(n_points, block);
  if (grid == 0) return 0;
#define PSDF_GRAD_ARGS                                                       \
  (const float*)points, n_points, (const float*)table, capacity,              \
      (const float*)shift, (const float*)scales, (const float*)window,        \
      (const float*)E, K, concat_scaling, concat, (const float*)g, g_stride,  \
      (float*)grad_points
  if (d == 3) {
    PSDF_LAUNCH(encode_point_grad_kernel<3>, grid, block, 0, stream,
                PSDF_GRAD_ARGS);
  } else if (d == 4) {
    PSDF_LAUNCH(encode_point_grad_kernel<4>, grid, block, 0, stream,
                PSDF_GRAD_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSDF_GRAD_ARGS
  return (int)cudaGetLastError();
}
