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
// What bounds A and B on an H100: the gathers' sectors. Each (point,
// level) does ~110-150 flops of lattice math and gathers d+1 vertices x 2
// features from a 2 MiB level table at hashed slots. At N = 196,608 and
// K = 24 that is 4.72 M (point, level) pairs and 18.9 M vertex loads, each
// pulling a 32-byte sector (0.6 GB) that mostly misses L2 at the fine
// levels: the 48 MiB table of 24 levels x 2^18 slots fills the 50 MB L2,
// and a fine level's vertices are distinct per point. The coarse levels
// hit a handful of slots. The lattice math is not the bound (~0.04 ms of
// instructions at that N). Their bounds over HBM bytes (each distinct slot read
// once) are ~0.02 ms; A takes 0.19-0.29 ms there and B 0.13-0.19 ms.
//
// Design kept for A and B (measured on an H100 against the alternatives
// below, on random points, on one eval chunk's samples in ray order and on
// one 64^3 mesh block in grid order; PERF.md keeps their times):
// - They read an interleaved [L, C, 2] copy of the table, so a vertex is
//   one 8-byte float2 load, one sector, where the parameter layout [L, 2,
//   C] cost two 4-byte loads C slots apart. The copy is made once per
//   table state by the caller (ops/permuto_encoding.py::interleaved_table);
//   G's gathers read it too, and F and G write gradients in the parameter
//   layout.
// - One block per tile of points x all K levels, the warps taking the
//   levels: A 16 points per tile, B 32. A stages the tile's rows in shared
//   memory and stores them as one contiguous span; B stages the tile's
//   cotangent rows, writes each (point, level) term to shared memory and
//   sums them per point in level order, with no atomics.
// - Measured and not kept: a level-major grid for A (the blocks in
//   flight reading one level table, to keep it in L2) was 1.1-2.4x slower:
//   each pass writes 8 bytes of every 204-byte output row, so the output
//   leaves as partial sectors 24 times. With four levels per block it beat
//   the tiles on the d = 4 background case only (0.117 against 0.143 ms at
//   N = 65,536) and lost on every d = 3 case. One thread per point looping
//   over the levels (every warp on the same few tables at once) was
//   1.1-1.8x slower for A and B; B level major through a [K, N, 3] scratch
//   1.3-2.0x. A's tiles of 8-64 points in blocks of 64-256 threads were
//   within 7% of each other; B's 64-point tile was 1.2-1.3x slower than its
//   32- and 16-point ones.
//
// The lattice is computed in exactly the float order of the plain PyTorch
// versions (built with --fmad=false), so slot ids match them bit for bit.
//
// What bounds F and G on an H100: their float atomics. Each (point, level)
// adds 2 (d+1) terms into the zeroed [L, 2, C] gradient, 9.4 M at N =
// 49,152 and K = 24, each a reduction in L2 at a hashed slot; their byte
// bound is the dense 50 MB output (0.018 ms; G adds its gathers: 0.026).
// At the coarse levels (sigma ~ 1 next to a batch's spread) most points hit
// a handful of slots and those atomics serialize on a few addresses; at
// the fine levels the slots are distinct and the L2's rate of scattered
// reductions is the limit (~40-60 G a second measured).
// Design kept for F and G (measured on an H100 against the alternatives
// below on random, ray-ordered and clustered points, d = 3 and d = 4, with
// and without parity; PERF.md keeps the times):
// - One block per tile of 32 points x the K levels, warp w taking levels
//   w, w + 8, ..., lane = point (F walks only the levels that get
//   gradients); the tile's points, cotangent rows (and G's u) are staged in
//   shared memory with coalesced loads.
// - Before the atomics a warp's lanes that hold the same slot sum their
//   terms (__match_any_sync and a tree of shuffles); one lane per distinct
//   slot adds the sum. At the fine levels this costs a match and a vote.
// - G gathers one float2 per vertex from the interleaved [L, C, 2] copy that
//   A made for the same table state, builds the tile's d g rows in shared
//   memory and stores them as one contiguous span.
// - Measured and not kept: one 8-byte float2 atomic per vertex into a
//   zeroed [L, C, 2] scratch plus a pass that writes [L, 2, C]: the
//   atomics took ~35% less time, but the scratch's memset and the pass
//   (150 MB) cost ~0.035 ms a call more, which lost on the step's mix of
//   calls (the d = 4 background, the small encodes, parity, clustered
//   points) and cost 50 MB a call. Combining only at levels with sigma >=
//   0.01 matched combining everywhere on random and ray-ordered points
//   and lost on clustered ones; not combining at all was the old kernels'
//   time. Blocks of 128 or 512 threads instead of 256, and G held to 6
//   blocks an SM (fewer registers), each won some cases and lost others
//   by up to ~15%.
//
// Alternating-level table gradients (JAX `grad_level_parity`,
// permuto_encoding.py:561-609, where the frozen levels gather through
// stop_gradient): F and G take (phase, period) and scatter only into the
// levels l with l % period == phase (period <= 1: every level). The other
// levels issue no atomics and their slice of the zeroed output stays zero;
// G still writes the feature cotangent of every level.
#include "permuto_lattice.cuh"

namespace {

__device__ __forceinline__ bool level_gets_grad(int l, int phase, int period) {
  return period <= 1 || l % period == phase;
}

// Kernel A. out [N, out_stride]: K levels x 2 features (level major,
// feature minor), then the d point columns x concat_scaling if concat.
// One block per tile of P points x all K levels; the warps take the
// levels (pair q: level q / P, point q % P), so each block has several
// level tables in flight and a warp's gathers hit one or two of them. Each
// vertex is one 8-byte load of the interleaved [L, C, 2] table. The tile's
// rows are staged in shared memory (row stride padded to odd: the level
// writes of a warp hit distinct banks) and leave as one contiguous span
// of P * out_stride floats, so the stores are coalesced whatever the row's
// alignment (a row is 4 (2K + d) bytes: 204 for d = 3).
constexpr int kFwdBlock = 256;
constexpr int kFwdTile = 16;

template <int D, int P>
__global__ void __launch_bounds__(kFwdBlock) encode_fwd_kernel(
    const float* __restrict__ points, int n_points,
    const float2* __restrict__ table, int capacity,
    const float* __restrict__ shift, const float* __restrict__ scales,
    const float* __restrict__ window, const float* __restrict__ E, int K,
    float concat_scaling, int concat, float* __restrict__ out,
    int out_stride) {
  const int srow = out_stride | 1;
  float* o_tile = psdf_dynamic_smem<float>();  // [P][srow]
  const int n0 = blockIdx.x * P;
  const int rows = min(P, n_points - n0);
  for (int q = threadIdx.x; q < K * P; q += blockDim.x) {
    const int l = q / P;
    const int pi = q - l * P;
    if (pi >= rows) continue;
    float p[D];
#pragma unroll
    for (int j = 0; j < D; ++j) p[j] = points[(long long)(n0 + pi) * D + j];
    float f0, f1;
    encode_level<D>(p, table, capacity, shift, scales, window, E, l, f0, f1);
    o_tile[pi * srow + 2 * l] = f0;
    o_tile[pi * srow + 2 * l + 1] = f1;
  }
  if (concat) {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int pi = i / D;
      o_tile[pi * srow + 2 * K + (i - pi * D)] =
          points[(long long)n0 * D + i] * concat_scaling;
    }
  }
  __syncthreads();
  float* dst = out + (long long)n0 * out_stride;
  for (int i = threadIdx.x; i < rows * out_stride; i += blockDim.x) {
    const int r = i / out_stride;
    dst[i] = o_tile[r * srow + (i - r * out_stride)];
  }
}

// Kernel B. grad_points [N, D] = d/dpoints of sum(g * encode(points)):
// through the barycentric weights only (gathers and rounding are piecewise
// constant), then E^T and 1/sigma_l, plus concat_scaling * g on the point
// columns. d bary_k / d elevated_i = ([d - rank_i == k] -
// [d + 1 - rank_i == k]) / (d + 1), the k = d + 1 term folded into k = 0.
// One block per tile of P points x all K levels, the warps taking the
// levels as in kernel A. The tile's points and cotangent rows (one
// contiguous span each) are staged in shared memory with coalesced loads;
// each (point, level) writes its term gl / sigma_l to shared memory as
// [K][P][D]; then one thread per point sums the terms in level order from
// 0.f and adds the concat term last: the plain version's order, with no
// atomics, so the result does not depend on the schedule.
constexpr int kGradBlock = 256;
constexpr int kGradTile = 32;

template <int D, int P>
__global__ void __launch_bounds__(kGradBlock) encode_point_grad_kernel(
    const float* __restrict__ points, int n_points,
    const float2* __restrict__ table, int capacity,
    const float* __restrict__ shift, const float* __restrict__ scales,
    const float* __restrict__ window, const float* __restrict__ E, int K,
    float concat_scaling, int concat, const float* __restrict__ g,
    int g_stride, float* __restrict__ grad_points) {
  float* pts = psdf_dynamic_smem<float>();  // [P][D]
  float* g_tile = pts + P * D;              // [P][g_stride]
  float* terms = g_tile + P * g_stride;     // [K][P][D]
  const int n0 = blockIdx.x * P;
  const int rows = min(P, n_points - n0);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    pts[i] = points[(long long)n0 * D + i];
  const float* g_src = g + (long long)n0 * g_stride;
  for (int i = threadIdx.x; i < rows * g_stride; i += blockDim.x) g_tile[i] = g_src[i];
  __syncthreads();

  const float dp1 = (float)(D + 1);
  for (int q = threadIdx.x; q < K * P; q += blockDim.x) {
    const int l = q / P;
    const int pi = q - l * P;
    if (pi >= rows) continue;
    float p[D];
#pragma unroll
    for (int j = 0; j < D; ++j) p[j] = pts[pi * D + j];
    float lat[D];
    lattice_point<D>(p, shift, scales, l, lat);
    Simplex<D> s;
    find_simplex<D>(lat, E, (uint32_t)(capacity - 1), s);
    const float w = (window != nullptr) ? window[l] : 1.0f;
    const float* gn = g_tile + pi * g_stride;
    const float g0 = gn[2 * l] * w;
    const float g1 = gn[2 * l + 1] * w;
    const float2* t = table + (long long)l * capacity;
    // cotangent of each barycentric weight: sum_f g_f * feat_{r,f}
    float gb[D + 1];
#pragma unroll
    for (int r = 0; r <= D; ++r) {
      const float2 v = __ldg(t + s.slot[r]);
      gb[r] = g0 * v.x + g1 * v.y;
    }
    float gel[D + 1];
#pragma unroll
    for (int i = 0; i <= D; ++i) {
      const int lo = D - s.rank[i];
      const int hi = (D + 1 - s.rank[i]) % (D + 1);
      gel[i] = (gb[lo] - gb[hi]) / dp1;
    }
    float* term = terms + (l * P + pi) * D;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float gl = E[j] * gel[0];
#pragma unroll
      for (int i = 1; i <= D; ++i) gl = gl + E[i * D + j] * gel[i];
      term[j] = gl / scales[l];
    }
  }
  __syncthreads();

  const int pi = threadIdx.x;
  if (pi >= rows) return;
  float acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = 0.f;
  for (int l = 0; l < K; ++l) {
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = acc[j] + terms[(l * P + pi) * D + j];
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float v = acc[j];
    if (concat) v = v + g_tile[pi * g_stride + 2 * K + j] * concat_scaling;
    grad_points[(long long)(n0 + pi) * D + j] = v;
  }
}

// Kernels F and G add into the [L, 2, C] gradient of a level table. A warp
// holds 32 points of one level (lane = point), so where the level is coarse
// next to the points' spread its lanes hit the same vertices: the lanes that
// hold the same slot sum their terms first (__match_any_sync, then a tree of
// shuffles over each group's lanes), and one lane per distinct slot adds the
// sum. The sum order differs from the plain version's index_add_ (float
// rounding only), as the atomics' order does anyway. A lane with key
// kNoSlot (past the tile's end, or a zero cotangent) adds nothing.
constexpr uint32_t kNoSlot = 0xffffffffu;

// The lanes of the calling warp that share `key` sum (v0, v1) into the
// group's lowest lane, which returns true; every other lane returns false.
// All 32 lanes call it. Where no two lanes share a key (the fine levels) it
// costs the match and one vote.
__device__ __forceinline__ bool combine_peers(uint32_t key, float& v0, float& v1) {
  const unsigned peers = __match_any_sync(PSDF_FULL_MASK, key);
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));  // place within the group
  const bool leader = rank == 0;
  unsigned above = peers & ~((2u << lane) - 1u);  // the group's lanes above
  while (__any_sync(PSDF_FULL_MASK, above != 0u)) {
    const int next = __ffs(above);  // 1 + the nearest live lane above, or 0
    const int src = next ? next - 1 : lane;
    const float a0 = __shfl_sync(PSDF_FULL_MASK, v0, src);
    const float a1 = __shfl_sync(PSDF_FULL_MASK, v1, src);
    if (next) {
      v0 = v0 + a0;
      v1 = v1 + a1;
    }
    // the odd places are summed into the even ones; halve the places
    above &= __ballot_sync(PSDF_FULL_MASK, (rank & 1u) == 0u);
    rank >>= 1;
  }
  return leader;
}

// One vertex's (v0, v1) into level `l` of the [L, 2, C] gradient, combined
// over the warp's lanes first: two float atomics (the return value unused,
// so they compile to reductions) per distinct slot.
__device__ __forceinline__ void scatter_vertex(float* __restrict__ d_table, int capacity, int l,
                                               uint32_t key, float v0, float v1) {
  if (!combine_peers(key, v0, v1) || key == kNoSlot) return;
  float* t0 = d_table + (long long)l * 2 * capacity;
  atomicAdd(t0 + key, v0);
  atomicAdd(t0 + capacity + key, v1);
}

// Stages rows [n0, n0 + rows) of a row-major [N, stride] array into shared
// memory with row stride `srow` (>= stride), reading one contiguous span.
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const float* __restrict__ src,
                                           int n0, int rows, int stride, int srow) {
  const float* s = src + (long long)n0 * stride;
  for (int i = threadIdx.x; i < rows * stride; i += blockDim.x) {
    const int r = i / stride;
    dst[r * srow + (i - r * stride)] = s[i];
  }
}

// Kernels F and G: one block per tile of P = 32 points x the K levels; warp
// w takes levels w, w + nwarps, ... with lane = point, so a warp's lanes
// share one level table and can combine their atomics.
constexpr int kTableGradBlock = 256;
constexpr int kTableGradTile = 32;

// Number of levels < K that get table gradients, and the j-th of them.
__device__ __forceinline__ int grad_level_count(int K, int phase, int period) {
  if (period <= 1) return K;
  return K > phase ? (K - phase + period - 1) / period : 0;
}
__device__ __forceinline__ int grad_level(int j, int phase, int period) {
  return period <= 1 ? j : phase + j * period;
}

// Kernel F. d_table [L, 2, C] (zeroed by the caller) += the transpose of
// kernel A's gather: d table[l, f, slot_r] += bary_r * (window_l *
// g[n, 2l + f]) for the K computed levels that get gradients. The tile's
// points and cotangent rows are staged in shared memory (row stride padded
// to odd); the warps walk the levels that get gradients only, so under
// parity no warp idles on a frozen level.
template <int D, int P>
__global__ void __launch_bounds__(kTableGradBlock) encode_table_grad_kernel(
    const float* __restrict__ points, int n_points, int capacity,
    const float* __restrict__ shift, const float* __restrict__ scales,
    const float* __restrict__ window, const float* __restrict__ E, int K,
    const float* __restrict__ g, int g_stride, int phase, int period,
    float* __restrict__ d_table) {
  const int srow = g_stride | 1;
  float* pts = psdf_dynamic_smem<float>();  // [P][D]
  float* g_tile = pts + P * D;              // [P][srow]
  const int n0 = blockIdx.x * P;
  const int rows = min(P, n_points - n0);
  stage_rows(pts, points, n0, rows, D, D);
  stage_rows(g_tile, g, n0, rows, g_stride, srow);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int pi = min(lane, rows - 1);  // lanes past the tile's end compute the last point
  float p[D];
#pragma unroll
  for (int j = 0; j < D; ++j) p[j] = pts[pi * D + j];
  const int n_levels = grad_level_count(K, phase, period);
  for (int j = threadIdx.x >> 5; j < n_levels; j += nwarps) {
    const int l = grad_level(j, phase, period);
    const float w = (window != nullptr) ? window[l] : 1.0f;
    const float g0 = g_tile[pi * srow + 2 * l] * w;
    const float g1 = g_tile[pi * srow + 2 * l + 1] * w;
    const bool adds = lane < rows && !(g0 == 0.f && g1 == 0.f);
    if (!__any_sync(PSDF_FULL_MASK, adds)) continue;  // the warp adds nothing here
    float lat[D];
    lattice_point<D>(p, shift, scales, l, lat);
    Simplex<D> s;
    find_simplex<D>(lat, E, (uint32_t)(capacity - 1), s);
#pragma unroll
    for (int r = 0; r <= D; ++r)
      scatter_vertex(d_table, capacity, l, adds ? s.slot[r] : kNoSlot, s.bary[r] * g0,
                     s.bary[r] * g1);
  }
}

// Kernel G: the backward of kernel B. Kernel B computes, per level,
// gb_r = w (g0 feat_{r,0} + g1 feat_{r,1}), gel_i = (gb[lo_i] - gb[hi_i]) /
// (d+1) and grad_j += sum_i E[i][j] gel_i / sigma_l. Given the cotangent u
// [N, D] of the point gradient, set c_i = (E u)_i / sigma_l / (d+1) and
// h_r = sum_i c_i ([lo_i = r] - [hi_i = r]); then
//   d table[l, f, slot_r] += (h_r w) g_f   (scatter at the levels that get
//                                          gradients, combined as in F),
//   d g[n, 2l + f] = w sum_r h_r feat_{r,f} (gather, no atomics),
//   d g[n, 2K + j] = u_j concat_scaling,
// and d points = 0 (the barycentric weights are piecewise linear in the
// points, so kernel B's output does not move with them for a fixed g).
// Tiles as in F; the gathers read one float2 per vertex of the interleaved
// [L, C, 2] table, as A and B do. The tile's points, u and g rows are
// staged in shared memory, and its d g rows are built there (row stride
// padded to odd) and stored as one contiguous span.
template <int D, int P>
__global__ void __launch_bounds__(kTableGradBlock) encode_double_backward_kernel(
    const float* __restrict__ points, int n_points,
    const float2* __restrict__ table, int capacity,
    const float* __restrict__ shift, const float* __restrict__ scales,
    const float* __restrict__ window, const float* __restrict__ E, int K,
    float concat_scaling, int concat, const float* __restrict__ g,
    int g_stride, const float* __restrict__ u, int phase, int period,
    float* __restrict__ d_table, float* __restrict__ d_g) {
  const int srow = g_stride | 1;
  float* pts = psdf_dynamic_smem<float>();  // [P][D]
  float* u_tile = pts + P * D;              // [P][D]
  float* g_tile = u_tile + P * D;           // [P][srow]
  float* dg_tile = g_tile + P * srow;       // [P][srow]
  const int n0 = blockIdx.x * P;
  const int rows = min(P, n_points - n0);
  stage_rows(pts, points, n0, rows, D, D);
  stage_rows(u_tile, u, n0, rows, D, D);
  stage_rows(g_tile, g, n0, rows, g_stride, srow);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int pi = min(lane, rows - 1);  // lanes past the tile's end compute the last point
  const bool valid = lane < rows;
  const float dp1 = (float)(D + 1);
  float p[D], Eu[D + 1];
#pragma unroll
  for (int j = 0; j < D; ++j) p[j] = pts[pi * D + j];
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    float acc = E[i * D] * u_tile[pi * D];
#pragma unroll
    for (int j = 1; j < D; ++j) acc = acc + E[i * D + j] * u_tile[pi * D + j];
    Eu[i] = acc;
  }
  for (int l = threadIdx.x >> 5; l < K; l += nwarps) {
    const float w = (window != nullptr) ? window[l] : 1.0f;
    float* dgn = dg_tile + pi * srow + 2 * l;
    if (w == 0.f) {  // the level contributes nothing either way
      if (valid) {
        dgn[0] = 0.f;
        dgn[1] = 0.f;
      }
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
    const float2* t = table + (long long)l * capacity;
    float2 v = __ldg(t + s.slot[0]);
    float dg0 = h[0] * v.x;
    float dg1 = h[0] * v.y;
#pragma unroll
    for (int r = 1; r <= D; ++r) {
      v = __ldg(t + s.slot[r]);
      dg0 = dg0 + h[r] * v.x;
      dg1 = dg1 + h[r] * v.y;
    }
    if (valid) {
      dgn[0] = w * dg0;
      dgn[1] = w * dg1;
    }
    if (!level_gets_grad(l, phase, period)) continue;  // a frozen level
    const float g0 = g_tile[pi * srow + 2 * l];
    const float g1 = g_tile[pi * srow + 2 * l + 1];
    const bool adds = valid && !(g0 == 0.f && g1 == 0.f);
    if (!__any_sync(PSDF_FULL_MASK, adds)) continue;
#pragma unroll
    for (int r = 0; r <= D; ++r) {
      const float hw = h[r] * w;
      scatter_vertex(d_table, capacity, l, adds ? s.slot[r] : kNoSlot, hw * g0, hw * g1);
    }
  }
  if (concat) {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      dg_tile[r * srow + 2 * K + (i - r * D)] = u_tile[i] * concat_scaling;
    }
  }
  __syncthreads();
  float* dst = d_g + (long long)n0 * g_stride;
  for (int i = threadIdx.x; i < rows * g_stride; i += blockDim.x) {
    const int r = i / g_stride;
    dst[i] = dg_tile[r * srow + (i - r * g_stride)];
  }
}

}  // namespace

// Kernels A and B read ``table`` as the interleaved [L, C, 2] copy of the
// parameter table (ops/permuto_encoding.py::interleaved_table).
template <int D>
static int launch_fwd(void* stream, const float* points, int n_points,
                      const float2* table, int capacity, const float* shift,
                      const float* scales, const float* window, const float* E,
                      int K, float concat_scaling, int concat, float* out,
                      int out_stride) {
  const int grid = psdf_blocks(n_points, kFwdTile);
  if (grid == 0) return 0;
  const size_t smem = sizeof(float) * kFwdTile * (out_stride | 1);
  const auto kernel = encode_fwd_kernel<D, kFwdTile>;
  PSDF_LAUNCH(kernel, grid, kFwdBlock, smem, stream,
              points, n_points, table, capacity, shift, scales, window, E, K,
              concat_scaling, concat, out, out_stride);
  return (int)cudaGetLastError();
}

extern "C" int psdf_encode_fwd(int d, const void* points, int n_points,
                               const void* table, int capacity,
                               const void* shift, const void* scales,
                               const void* window, const void* E, int K,
                               float concat_scaling, int concat, void* out,
                               int out_stride, void* stream) {
#define PSDF_ENC_ARGS                                                        \
  stream, (const float*)points, n_points, (const float2*)table, capacity,     \
      (const float*)shift, (const float*)scales, (const float*)window,        \
      (const float*)E, K, concat_scaling, concat, (float*)out, out_stride
  if (d == 3) return launch_fwd<3>(PSDF_ENC_ARGS);
  if (d == 4) return launch_fwd<4>(PSDF_ENC_ARGS);
#undef PSDF_ENC_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int D>
static int launch_point_grad(void* stream, const float* points, int n_points,
                             const float2* table, int capacity,
                             const float* shift, const float* scales,
                             const float* window, const float* E, int K,
                             float concat_scaling, int concat, const float* g,
                             int g_stride, float* grad_points) {
  const int grid = psdf_blocks(n_points, kGradTile);
  if (grid == 0) return 0;
  const size_t smem = sizeof(float) * kGradTile * (D + g_stride + (size_t)K * D);
  const auto kernel = encode_point_grad_kernel<D, kGradTile>;
  PSDF_LAUNCH(kernel, grid, kGradBlock, smem, stream, points, n_points, table,
              capacity, shift, scales, window, E, K, concat_scaling, concat, g,
              g_stride, grad_points);
  return (int)cudaGetLastError();
}

extern "C" int psdf_encode_point_grad(int d, const void* points, int n_points,
                                      const void* table, int capacity,
                                      const void* shift, const void* scales,
                                      const void* window, const void* E, int K,
                                      float concat_scaling, int concat,
                                      const void* g, int g_stride,
                                      void* grad_points, void* stream) {
#define PSDF_GRAD_ARGS                                                       \
  stream, (const float*)points, n_points, (const float2*)table, capacity,     \
      (const float*)shift, (const float*)scales, (const float*)window,        \
      (const float*)E, K, concat_scaling, concat, (const float*)g, g_stride,  \
      (float*)grad_points
  if (d == 3) return launch_point_grad<3>(PSDF_GRAD_ARGS);
  if (d == 4) return launch_point_grad<4>(PSDF_GRAD_ARGS);
#undef PSDF_GRAD_ARGS
  return (int)cudaErrorInvalidValue;
}

// Kernels F and G add into ``d_table`` [L, 2, C], zeroed by the caller.
template <int D>
static int launch_table_grad(void* stream, const float* points, int n_points, int capacity,
                             const float* shift, const float* scales, const float* window,
                             const float* E, int K, const float* g, int g_stride, int phase,
                             int period, float* d_table) {
  const int grid = psdf_blocks(n_points, kTableGradTile);
  if (grid == 0) return 0;
  const size_t smem = sizeof(float) * kTableGradTile * (D + (g_stride | 1));
  const auto kernel = encode_table_grad_kernel<D, kTableGradTile>;
  PSDF_LAUNCH(kernel, grid, kTableGradBlock, smem, stream, points, n_points, capacity, shift,
              scales, window, E, K, g, g_stride, phase, period, d_table);
  return (int)cudaGetLastError();
}

extern "C" int psdf_encode_table_grad(int d, const void* points, int n_points,
                                      int capacity, const void* shift,
                                      const void* scales, const void* window,
                                      const void* E, int K, const void* g,
                                      int g_stride, int phase, int period,
                                      void* d_table, void* stream) {
#define PSDF_TGRAD_ARGS                                                      \
  stream, (const float*)points, n_points, capacity, (const float*)shift,      \
      (const float*)scales, (const float*)window, (const float*)E, K,         \
      (const float*)g, g_stride, phase, period, (float*)d_table
  if (d == 3) return launch_table_grad<3>(PSDF_TGRAD_ARGS);
  if (d == 4) return launch_table_grad<4>(PSDF_TGRAD_ARGS);
#undef PSDF_TGRAD_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int D>
static int launch_double_backward(void* stream, const float* points, int n_points,
                                  const float2* table, int capacity, const float* shift,
                                  const float* scales, const float* window, const float* E,
                                  int K, float concat_scaling, int concat, const float* g,
                                  int g_stride, const float* u, int phase, int period,
                                  float* d_table, float* d_g) {
  const int grid = psdf_blocks(n_points, kTableGradTile);
  if (grid == 0) return 0;
  const size_t smem = sizeof(float) * kTableGradTile * (2 * D + 2 * (g_stride | 1));
  const auto kernel = encode_double_backward_kernel<D, kTableGradTile>;
  PSDF_LAUNCH(kernel, grid, kTableGradBlock, smem, stream, points, n_points, table, capacity,
              shift, scales, window, E, K, concat_scaling, concat, g, g_stride, u, phase,
              period, d_table, d_g);
  return (int)cudaGetLastError();
}

// Kernel G reads ``table`` as the interleaved [L, C, 2] copy, as A and B do.
extern "C" int psdf_encode_double_backward(
    int d, const void* points, int n_points, const void* table, int capacity,
    const void* shift, const void* scales, const void* window, const void* E,
    int K, float concat_scaling, int concat, const void* g, int g_stride,
    const void* u, int phase, int period, void* d_table, void* d_g, void* stream) {
#define PSDF_DBWD_ARGS                                                       \
  stream, (const float*)points, n_points, (const float2*)table, capacity,     \
      (const float*)shift, (const float*)scales, (const float*)window,        \
      (const float*)E, K, concat_scaling, concat, (const float*)g, g_stride,  \
      (const float*)u, phase, period, (float*)d_table, (float*)d_g
  if (d == 3) return launch_double_backward<3>(PSDF_DBWD_ARGS);
  if (d == 4) return launch_double_backward<4>(PSDF_DBWD_ARGS);
#undef PSDF_DBWD_ARGS
  return (int)cudaErrorInvalidValue;
}
