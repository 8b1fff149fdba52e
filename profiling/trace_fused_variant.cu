// Kernels J3f and J2f in the two designs the port measured against its own
// (8 warps a 32-ray tile, sphere_trace.cu), for measurement only: with 1
// warp a tile a lane computes its ray's levels and its 32 hidden units in
// registers (4 tiles a block of 128 threads); with 4 warps a tile the warps
// split the levels and the hidden units, 8 each, as the port's 8 warps
// split them 4 each. The loops, the update and the sums' order are the
// port's, so both designs give the port's state bit for bit. Built and
// timed by profiling/trace_fused_designs.py; no path of the port calls it.
#include "sphere_trace.cu"

namespace {

// A ray tile is 32 rays (lane = ray) taken by WARPS warps: with 1, a warp
// evaluates its lanes' SDF alone, the hidden units in registers; with more,
// the warps split the levels and the hidden units, which pass through
// shared memory. Per tile: the inputs [n_in][32] and, with WARPS > 1, two
// buffers of hidden units [2][32][32], one column per lane.
template <int WARPS>
__host__ __device__ __forceinline__ int design_tile_floats(int n_in) {
  return n_in * 32 + (WARPS > 1 ? 2 * kHid * 32 : 0);
}
template <int WARPS>
__host__ __device__ constexpr int design_block() { return 128; }
template <int WARPS>
__host__ __device__ constexpr int design_tiles() { return design_block<WARPS>() / (32 * WARPS); }

template <int WARPS>
__device__ __forceinline__ void tile_sync() {
  if constexpr (WARPS == 1) {
    __syncwarp();
  } else {
    __syncthreads();  // one tile a block
  }
}

// U units of one layer for the calling lane: h[u] = gelu(sum_i x_i W[i][u0
// + u] + b[u0 + u]), the sum over i in order (fmaf); x_i = in[i * 32 +
// lane], the weights read as shared-memory broadcasts, 4 units a load.
template <int U>
__device__ __forceinline__ void design_units(const float* __restrict__ in, int n, int lane,
                                             const float* __restrict__ W,
                                             const float* __restrict__ b, int u0, float (&h)[U]) {
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float x = in[i * 32 + lane];
    const float4* wr = reinterpret_cast<const float4*>(W + i * kHid + u0);
#pragma unroll
    for (int q = 0; q < U / 4; ++q) {
      const float4 v = wr[q];
      acc[4 * q] = fmaf(x, v.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(x, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(x, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(x, v.w, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) h[u] = gelu_tanh(acc[u] + b[u0 + u]);
}

// The same for a hidden layer whose 32 inputs the lane holds in registers
// (WARPS == 1).
__device__ __forceinline__ void layer_regs(const float (&x)[kHid], const float* __restrict__ W,
                                           const float* __restrict__ b, float (&h)[kHid]) {
  float acc[kHid];
#pragma unroll
  for (int u = 0; u < kHid; ++u) acc[u] = 0.f;
#pragma unroll
  for (int i = 0; i < kHid; ++i) {
    const float4* wr = reinterpret_cast<const float4*>(W + i * kHid);
#pragma unroll
    for (int q = 0; q < kHid / 4; ++q) {
      const float4 v = wr[q];
      acc[4 * q] = fmaf(x[i], v.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(x[i], v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(x[i], v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(x[i], v.w, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int u = 0; u < kHid; ++u) h[u] = gelu_tanh(acc[u] + b[u]);
}

// The SDF at the calling lane's point p, called by every warp of the tile
// with the same points. Lanes that are not `active` skip the encoding (the
// tile's MLP runs for all 32); their value is not used. Every warp of the
// tile returns the same value, and the sums run in the same order whatever
// WARPS is, so the designs agree bit for bit.
template <int WARPS>
__device__ __forceinline__ float design_sdf_at(const SdfNet& net, int n_in,
                                               const float* __restrict__ sw,
                                               float* __restrict__ xt, float* __restrict__ ht,
                                               const float (&p)[3], bool active) {
  constexpr int U = kHid / WARPS;
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) % WARPS;
  const float* w0 = sw;
  const float* w1 = w0 + n_in * kHid;
  const float* w2 = w1 + kHid * kHid;
  const float* b0 = w2 + kHid * kHid;
  const float* b1 = b0 + kHid;
  const float* b2 = b1 + kHid;
  const float* w3 = b2 + kHid;
  const float b3 = w3[kHid];
  if (active) {
    for (int l = w; l < net.K; l += WARPS) {
      float f0, f1;
      encode_level<3>(p, net.table, net.capacity, net.shift, net.scales, net.window, net.E, l,
                      f0, f1);
      xt[(2 * l) * 32 + lane] = f0;
      xt[(2 * l + 1) * 32 + lane] = f1;
    }
    if (w == WARPS - 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) xt[(2 * net.K + c) * 32 + lane] = p[c] * net.concat_scaling;
    }
  }
  tile_sync<WARPS>();
  const int u0 = w * U;
  float h[U];
  design_units<U>(xt, n_in, lane, w0, b0, u0, h);
  float s = 0.f;
  if constexpr (WARPS == 1) {
    float g[kHid];
    layer_regs(h, w1, b1, g);
    layer_regs(g, w2, b2, h);
#pragma unroll
    for (int i = 0; i < kHid; ++i) s = fmaf(h[i], w3[i], s);
  } else {
    float* h0 = ht;
    float* h1 = ht + kHid * 32;
#pragma unroll
    for (int u = 0; u < U; ++u) h0[(u0 + u) * 32 + lane] = h[u];
    tile_sync<WARPS>();
    design_units<U>(h0, kHid, lane, w1, b1, u0, h);
#pragma unroll
    for (int u = 0; u < U; ++u) h1[(u0 + u) * 32 + lane] = h[u];
    tile_sync<WARPS>();
    design_units<U>(h1, kHid, lane, w2, b2, u0, h);
#pragma unroll
    for (int u = 0; u < U; ++u) h0[(u0 + u) * 32 + lane] = h[u];
    tile_sync<WARPS>();
    for (int i = 0; i < kHid; ++i) s = fmaf(h0[i * 32 + lane], w3[i], s);
  }
  return s + b3;
}

// Kernel J3f in the design of WARPS warps a tile: `iters` iterations of
// J3 on slot j's row r = idx[j] (or j
// without idx; fill slots, r >= R, do nothing), the SDF evaluated in the
// launch: the row's state stays in registers, and a tile stops once none
// of its rows is active (an inactive row is a fixed point of J3's update).
// The tile's first warp writes the state back, and with sdf_f the last
// sdf of an active row.
template <int WARPS>
__global__ void __launch_bounds__(design_block<WARPS>()) trace_loop_pos_design_kernel(
    int B, long long R, const long long* __restrict__ idx, SdfNet net, int n_in,
    const float* __restrict__ dirs, float* __restrict__ pos_f, uint8_t* __restrict__ alive_f,
    uint8_t* __restrict__ conv_f, float* __restrict__ sdf_f, const uint8_t* __restrict__ field,
    GridArgs g, int iters, float mult, float thr, float gate, float cx, float cy, float cz,
    float r2) {
  float* sw = psdf_dynamic_smem<float>();
  stage_net(net, n_in, sw);
  const int tile = threadIdx.x / (32 * WARPS);
  float* xt = sw + net_floats(n_in) + tile * design_tile_floats<WARPS>(n_in);
  const long long j =
      ((long long)blockIdx.x * design_tiles<WARPS>() + tile) * 32 + (threadIdx.x & 31);
  const long long r = j < B ? (idx != nullptr ? idx[j] : j) : R;
  const bool real = r < R;
  float d[3] = {0.f, 0.f, 0.f}, p[3] = {0.f, 0.f, 0.f}, sdf = 0.f;
  bool alive = false, conv = false;
  if (real) {
    for (int c = 0; c < 3; ++c) {
      d[c] = dirs[r * 3 + c];
      p[c] = pos_f[r * 3 + c];
    }
    alive = alive_f[r] != 0;
    conv = conv_f[r] != 0;
    if (sdf_f != nullptr) sdf = sdf_f[r];
  }
  bool active = alive && !conv;
  for (int it = 0; it < iters; ++it) {
    if (!__any_sync(PSDF_FULL_MASK, active)) break;  // the same vote in every warp of the tile
    const float s = design_sdf_at<WARPS>(net, n_in, sw, xt, xt + n_in * 32, p, active);
    if (!active) continue;
    sdf = s;
    const float m = s * mult;
    for (int c = 0; c < 3; ++c) p[c] = p[c] + d[c] * m;
    conv = fabsf(s) < thr;
    if (field != nullptr && !conv && s > gate) {
      const int k = field_at(field, g, p[0], p[1], p[2]);
      const float jump = (float)max(k - 1, 0) * g.voxel_size;
      for (int c = 0; c < 3; ++c) p[c] = p[c] + jump * d[c];
    }
    const float ex = p[0] - cx, ey = p[1] - cy, ez = p[2] - cz;
    alive = conv || (ex * ex + ey * ey) + ez * ez < r2;
    active = alive && !conv;
  }
  if (real && (threadIdx.x >> 5) % WARPS == 0) {
    for (int c = 0; c < 3; ++c) pos_f[r * 3 + c] = p[c];
    alive_f[r] = alive ? 1 : 0;
    conv_f[r] = conv ? 1 : 0;
    if (sdf_f != nullptr) sdf_f[r] = sdf;
  }
}

// Kernel J2f in the design of WARPS warps a tile: one round of the
// adaptive tracer on bucket slot j's ray r =
// idx[j] (fill slots, r >= R, do nothing): `iters` times the position o +
// t d, the SDF there and J2's update (the step, the convergence test,
// `substeps` chained jumps gated on s > gate, death past t_exit), the state
// in registers; a tile stops once none of its rays is active. Then the
// round's counts: still active, and converged and alive.
template <int WARPS>
__global__ void __launch_bounds__(design_block<WARPS>()) trace_round_design_kernel(
    int B, long long R, const long long* __restrict__ idx, SdfNet net, int n_in,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_exit, float* __restrict__ t_f, uint8_t* __restrict__ alive_f,
    uint8_t* __restrict__ conv_f, float* __restrict__ sdf_f, const uint8_t* __restrict__ field,
    GridArgs g, int iters, float mult, float thr, float gate, int substeps,
    int* __restrict__ counts) {
  float* sw = psdf_dynamic_smem<float>();
  stage_net(net, n_in, sw);
  const int tile = threadIdx.x / (32 * WARPS);
  float* xt = sw + net_floats(n_in) + tile * design_tile_floats<WARPS>(n_in);
  const long long j =
      ((long long)blockIdx.x * design_tiles<WARPS>() + tile) * 32 + (threadIdx.x & 31);
  const long long r = j < B ? idx[j] : R;
  const bool real = r < R;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, t = 0.f, texit = 0.f, sdf = 0.f;
  bool alive = false, conv = false;
  if (real) {
    for (int c = 0; c < 3; ++c) {
      o[c] = origins[r * 3 + c];
      d[c] = dirs[r * 3 + c];
    }
    t = t_f[r];
    texit = t_exit[r];
    sdf = sdf_f[r];
    alive = alive_f[r] != 0;
    conv = conv_f[r] != 0;
  }
  bool active = alive && !conv;
  for (int it = 0; it < iters; ++it) {
    if (!__any_sync(PSDF_FULL_MASK, active)) break;
    const float p[3] = {o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]};
    const float s = design_sdf_at<WARPS>(net, n_in, sw, xt, xt + n_in * 32, p, active);
    if (!active) continue;
    sdf = s;
    conv = fabsf(s) < thr;
    float t_new = t + s * mult;
    if (field != nullptr) {
      if (conv) t_new = t;
      if (!conv && s > gate)
        t_new = jump_along(field, g, o[0], o[1], o[2], d[0], d[1], d[2], t_new, substeps);
    }
    alive = conv || !(t_new > texit);
    if (!conv) t = t_new;
    active = alive && !conv;
  }
  if ((threadIdx.x >> 5) % WARPS != 0) return;
  if (real) {
    t_f[r] = t;
    alive_f[r] = alive ? 1 : 0;
    conv_f[r] = conv ? 1 : 0;
    sdf_f[r] = sdf;
  }
  if (counts != nullptr) {
    const unsigned na = __ballot_sync(PSDF_FULL_MASK, active);
    const unsigned nh = __ballot_sync(PSDF_FULL_MASK, alive && conv);
    if ((threadIdx.x & 31) == 0) {
      if (na != 0) atomicAdd(&counts[0], __popc(na));
      if (nh != 0) atomicAdd(&counts[1], __popc(nh));
    }
  }
}

}  // namespace

// The shared memory of a block (the staged weights and its tiles), and the
// launch. `warps` picks the design: 1 or 4 warps a ray tile.
template <int WARPS>
static size_t design_smem(int n_in) {
  return sizeof(float) *
         (net_floats(n_in) + (size_t)design_tiles<WARPS>() * design_tile_floats<WARPS>(n_in));
}

template <int WARPS, typename Kernel, typename... Args>
static int launch_design(Kernel kernel, int B, int n_in, void* stream, Args... args) {
  const int grid = psdf_blocks(B, 32 * design_tiles<WARPS>());
  if (grid == 0) return 0;
  const size_t smem = design_smem<WARPS>(n_in);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
    if (err != 0) return err;
  }
  PSDF_LAUNCH(kernel, grid, design_block<WARPS>(), smem, stream, args...);
  return (int)cudaGetLastError();
}

extern "C" int psdf_trace_loop_pos_design(int B, int R, const void* idx, SdfNet net,
                                          int warps, const void* dirs, void* pos, void* alive,
                                          void* conv, void* sdf, const void* field, int V,
                                          float half_extent, float tx, float ty, float tz,
                                          float voxel_size, int cap, int iters, float mult,
                                          float thr, float gate, float cx, float cy, float cz,
                                          float r2, void* stream) {
  if (!net_ok(net)) return (int)cudaErrorInvalidValue;
  const int n_in = 2 * net.K + 3;
  const GridArgs g = grid_args(V, half_extent, tx, ty, tz, voxel_size, cap);
#define PSDF_J3F_ARGS                                                                    \
  B, (long long)R, (const long long*)idx, net, n_in, (const float*)dirs, (float*)pos,      \
      (uint8_t*)alive, (uint8_t*)conv, (float*)sdf, (const uint8_t*)field, g, iters, mult, \
      thr, gate, cx, cy, cz, r2
  if (warps == 1)
    return launch_design<1>(trace_loop_pos_design_kernel<1>, B, n_in, stream, PSDF_J3F_ARGS);
  if (warps == 4)
    return launch_design<4>(trace_loop_pos_design_kernel<4>, B, n_in, stream, PSDF_J3F_ARGS);
#undef PSDF_J3F_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int psdf_trace_round_design(int B, int R, const void* idx, SdfNet net, int warps,
                                       const void* origins, const void* dirs,
                                       const void* t_exit, void* t, void* alive, void* conv,
                                       void* sdf, const void* field, int V, float half_extent,
                                       float tx, float ty, float tz, float voxel_size, int cap,
                                       int iters, float mult, float thr, float gate,
                                       int substeps, void* counts, void* stream) {
  if (!net_ok(net)) return (int)cudaErrorInvalidValue;
  const int n_in = 2 * net.K + 3;
  const GridArgs g = grid_args(V, half_extent, tx, ty, tz, voxel_size, cap);
#define PSDF_J2F_ARGS                                                                       \
  B, (long long)R, (const long long*)idx, net, n_in, (const float*)origins,                   \
      (const float*)dirs, (const float*)t_exit, (float*)t, (uint8_t*)alive, (uint8_t*)conv,   \
      (float*)sdf, (const uint8_t*)field, g, iters, mult, thr, gate, substeps, (int*)counts
  if (warps == 1)
    return launch_design<1>(trace_round_design_kernel<1>, B, n_in, stream, PSDF_J2F_ARGS);
  if (warps == 4)
    return launch_design<4>(trace_round_design_kernel<4>, B, n_in, stream, PSDF_J2F_ARGS);
#undef PSDF_J2F_ARGS
  return (int)cudaErrorInvalidValue;
}
