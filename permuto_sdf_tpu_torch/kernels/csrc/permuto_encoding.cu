// Kernels A, B, F and G: permutohedral hash encoding, forward, point
// gradient, table gradient and double backward.
//
// Replaces: permuto_sdf_tpu/ops/permuto_encoding.py:504 `permuto_encode`
// (with `_simplex_nminor` :276, the hash :551-556 and `row2_gather_pair`
// :458) -- kernel A -- and the point VJP of that op which
// permuto_sdf_tpu/models/fields.py:167 `_sdf_with_gradient_rev` takes --
// kernel B. Kernel F is the table gradient, the transpose of the gather
// (`_row2_gather_bwd` :475). Kernel G is the backward of kernel B, which
// JAX forms by differentiating the point VJP again under `value_and_grad`
// for the eikonal and curvature losses (oracle:
// tests/test_encoding.py:223). The JAX package leaves all four to XLA (no
// Pallas kernel exists: a TPU v5e cannot express a gather over 2^18-slot
// tables).
//
// What bounds them on an H100: bytes. Each (point, level) does ~150 flops
// of lattice math but gathers (d+1) vertices x 2 features of 4 bytes from
// a 2 MiB level table at random slots; each gather costs a 32-byte sector,
// so the kernels are bound by L2/HBM sector traffic of the gathers, with
// the 50 MB full table just about fitting the 50 MB L2. F and G scatter
// into a zeroed [L, 2, C] gradient table with float atomics: at the
// coarsest levels (sigma ~ 1) most points of a batch hit a handful of
// slots, so those atomics serialize on a few addresses.
//
// Design: kernels A and F run one thread per (point, level), level minor,
// so a warp shares the point's loads. Kernels B and G run one thread per
// point looping over the levels, so the per-point sums stay in registers.
// The table stays in the parameter layout [L, F=2, C]: a vertex costs two
// 4-byte loads C apart (two sectors). A [L, C, 2] copy would make it one
// 8-byte load; that is left for a later change. All kernels compute the
// lattice in exactly the float order of the plain PyTorch versions (built
// with --fmad=false), so slot ids match them bit for bit. F and G add with
// atomicAdd in no fixed order, so their sums vary by float rounding from
// run to run; a later change can aggregate per warp or sort the slots.
//
// Alternating-level table gradients (JAX `grad_level_parity`,
// permuto_encoding.py:561-609, where the frozen levels gather through
// stop_gradient): F and G take (phase, period) and scatter only into the
// levels l with l % period == phase (period <= 1: every level). The other
// levels issue no atomics and their slice of the zeroed output stays zero;
// G still writes the feature cotangent of every level.
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

__device__ __forceinline__ bool level_gets_grad(int l, int phase, int period) {
  return period <= 1 || l % period == phase;
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

// Kernel F. d_table [L, 2, C] (zeroed by the caller) += the transpose of
// kernel A's gather: d table[l, f, slot_r] += bary_r * (window_l *
// g[n, 2l + f]) for the K computed levels that get gradients. One thread
// per (point, level).
template <int D>
__global__ void __launch_bounds__(256) encode_table_grad_kernel(
    const float* __restrict__ points, int n_points, int capacity,
    const float* __restrict__ shift, const float* __restrict__ scales,
    const float* __restrict__ window, const float* __restrict__ E, int K,
    const float* __restrict__ g, int g_stride, int phase, int period,
    float* __restrict__ d_table) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_points * K) return;
  const int n = (int)(idx / K);
  const int l = (int)(idx - (long long)n * K);
  if (!level_gets_grad(l, phase, period)) return;  // a frozen level
  const float w = (window != nullptr) ? window[l] : 1.0f;
  const float* gn = g + (long long)n * g_stride;
  const float g0 = gn[2 * l] * w;
  const float g1 = gn[2 * l + 1] * w;
  if (g0 == 0.f && g1 == 0.f) return;  // adds nothing
  float p[D];
#pragma unroll
  for (int j = 0; j < D; ++j) p[j] = points[(long long)n * D + j];
  float lat[D];
  lattice_point<D>(p, shift, scales, l, lat);
  Simplex<D> s;
  find_simplex<D>(lat, E, (uint32_t)(capacity - 1), s);
  float* t0 = d_table + (long long)l * 2 * capacity;
  float* t1 = t0 + capacity;
#pragma unroll
  for (int r = 0; r <= D; ++r) {
    atomicAdd(t0 + s.slot[r], s.bary[r] * g0);
    atomicAdd(t1 + s.slot[r], s.bary[r] * g1);
  }
}

// Kernel G: the backward of kernel B. Kernel B computes, per level,
// gb_r = w (g0 feat_{r,0} + g1 feat_{r,1}), gel_i = (gb[lo_i] - gb[hi_i]) /
// (d+1) and grad_j += sum_i E[i][j] gel_i / sigma_l. Given the cotangent u
// [N, D] of the point gradient, set c_i = (E u)_i / sigma_l / (d+1) and
// h_r = sum_i c_i ([lo_i = r] - [hi_i = r]); then
//   d table[l, f, slot_r] += (h_r w) g_f   (scatter, atomics, at the levels
//                                          that get gradients; d_table
//                                          zeroed by the caller),
//   d g[n, 2l + f] = w sum_r h_r feat_{r,f} (gather, no atomics),
//   d g[n, 2K + j] = u_j concat_scaling,
// and d points = 0 (the barycentric weights are piecewise linear in the
// points, so kernel B's output does not move with them for a fixed g).
template <int D>
__global__ void __launch_bounds__(128) encode_double_backward_kernel(
    const float* __restrict__ points, int n_points,
    const float* __restrict__ table, int capacity,
    const float* __restrict__ shift, const float* __restrict__ scales,
    const float* __restrict__ window, const float* __restrict__ E, int K,
    float concat_scaling, int concat, const float* __restrict__ g,
    int g_stride, const float* __restrict__ u, int phase, int period,
    float* __restrict__ d_table, float* __restrict__ d_g) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  float p[D], un[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    p[j] = points[(long long)n * D + j];
    un[j] = u[(long long)n * D + j];
  }
  const float* gn = g + (long long)n * g_stride;
  float* dgn = d_g + (long long)n * g_stride;
  const float dp1 = (float)(D + 1);
  float Eu[D + 1];
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    float acc = E[i * D] * un[0];
#pragma unroll
    for (int j = 1; j < D; ++j) acc = acc + E[i * D + j] * un[j];
    Eu[i] = acc;
  }

  for (int l = 0; l < K; ++l) {
    const float w = (window != nullptr) ? window[l] : 1.0f;
    if (w == 0.f) {  // the level contributes nothing either way
      dgn[2 * l] = 0.f;
      dgn[2 * l + 1] = 0.f;
      continue;
    }
    float lat[D];
    lattice_point<D>(p, shift, scales, l, lat);
    Simplex<D> s;
    find_simplex<D>(lat, E, (uint32_t)(capacity - 1), s);
    float c[D + 1];
#pragma unroll
    for (int i = 0; i <= D; ++i) c[i] = Eu[i] / scales[l] / dp1;
    float h[D + 1];
#pragma unroll
    for (int r = 0; r <= D; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i <= D; ++i) {
        const int lo = D - s.rank[i];
        const int hi = (D + 1 - s.rank[i]) % (D + 1);
        if (lo == r) acc = acc + c[i];
        if (hi == r) acc = acc - c[i];
      }
      h[r] = acc;
    }
    const float* t0 = table + (long long)l * 2 * capacity;
    const float* t1 = t0 + capacity;
    float dg0 = h[0] * __ldg(t0 + s.slot[0]);
    float dg1 = h[0] * __ldg(t1 + s.slot[0]);
#pragma unroll
    for (int r = 1; r <= D; ++r) {
      dg0 = dg0 + h[r] * __ldg(t0 + s.slot[r]);
      dg1 = dg1 + h[r] * __ldg(t1 + s.slot[r]);
    }
    dgn[2 * l] = w * dg0;
    dgn[2 * l + 1] = w * dg1;
    if (!level_gets_grad(l, phase, period)) continue;  // a frozen level
    const float g0 = gn[2 * l];
    const float g1 = gn[2 * l + 1];
    float* d0 = d_table + (long long)l * 2 * capacity;
    float* d1 = d0 + capacity;
#pragma unroll
    for (int r = 0; r <= D; ++r) {
      const float hw = h[r] * w;
      atomicAdd(d0 + s.slot[r], hw * g0);
      atomicAdd(d1 + s.slot[r], hw * g1);
    }
  }
  if (concat) {
#pragma unroll
    for (int j = 0; j < D; ++j) dgn[2 * K + j] = un[j] * concat_scaling;
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

extern "C" int psdf_encode_table_grad(int d, const void* points, int n_points,
                                      int capacity, const void* shift,
                                      const void* scales, const void* window,
                                      const void* E, int K, const void* g,
                                      int g_stride, int phase, int period,
                                      void* d_table, void* stream) {
  const int block = 256;
  const int grid = psdf_blocks((long long)n_points * K, block);
  if (grid == 0) return 0;
#define PSDF_TGRAD_ARGS                                                      \
  (const float*)points, n_points, capacity, (const float*)shift,              \
      (const float*)scales, (const float*)window, (const float*)E, K,         \
      (const float*)g, g_stride, phase, period, (float*)d_table
  if (d == 3) {
    PSDF_LAUNCH(encode_table_grad_kernel<3>, grid, block, 0, stream,
                PSDF_TGRAD_ARGS);
  } else if (d == 4) {
    PSDF_LAUNCH(encode_table_grad_kernel<4>, grid, block, 0, stream,
                PSDF_TGRAD_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSDF_TGRAD_ARGS
  return (int)cudaGetLastError();
}

extern "C" int psdf_encode_double_backward(
    int d, const void* points, int n_points, const void* table, int capacity,
    const void* shift, const void* scales, const void* window, const void* E,
    int K, float concat_scaling, int concat, const void* g, int g_stride,
    const void* u, int phase, int period, void* d_table, void* d_g,
    void* stream) {
  const int block = 128;
  const int grid = psdf_blocks(n_points, block);
  if (grid == 0) return 0;
#define PSDF_DBWD_ARGS                                                       \
  (const float*)points, n_points, (const float*)table, capacity,              \
      (const float*)shift, (const float*)scales, (const float*)window,        \
      (const float*)E, K, concat_scaling, concat, (const float*)g, g_stride,  \
      (const float*)u, phase, period, (float*)d_table, (float*)d_g
  if (d == 3) {
    PSDF_LAUNCH(encode_double_backward_kernel<3>, grid, block, 0, stream,
                PSDF_DBWD_ARGS);
  } else if (d == 4) {
    PSDF_LAUNCH(encode_double_backward_kernel<4>, grid, block, 0, stream,
                PSDF_DBWD_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSDF_DBWD_ARGS
  return (int)cudaGetLastError();
}
