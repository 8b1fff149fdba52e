// The permutohedral lattice of the hash encoding, shared by kernel A
// (permuto_encoding.cu, with B, F and G) and the sphere tracers' SDF
// evaluation inside kernels J2f and J3f (sphere_trace.cu): the lattice
// point of a level, the simplex lookup with its barycentric weights, the
// hash of its vertices, and one level's two windowed features.
//
// The float operations are written in the order of the plain PyTorch
// versions (ops/permuto_encoding.py::_simplex_plain, encode_fwd_plain); the
// kernels are built with --fmad=false, so slot ids and features match them
// bit for bit, and every kernel that includes this header computes the same
// features for the same point.
#pragma once

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


// Kernel A's value of level l at point p: the d+1 vertices of its simplex
// gathered from the interleaved [L, C, 2] table (one 8-byte load each),
// blended with the barycentric weights, times the c2f window (none: 1).
template <int D>
__device__ __forceinline__ void encode_level(const float (&p)[D],
                                             const float2* __restrict__ table,
                                             int capacity,
                                             const float* __restrict__ shift,
                                             const float* __restrict__ scales,
                                             const float* __restrict__ window,
                                             const float* __restrict__ E, int l,
                                             float& f0, float& f1) {
  float lat[D];
  lattice_point<D>(p, shift, scales, l, lat);
  Simplex<D> s;
  find_simplex<D>(lat, E, (uint32_t)(capacity - 1), s);
  const float2* t = table + (long long)l * capacity;
  float2 v = __ldg(t + s.slot[0]);
  f0 = s.bary[0] * v.x;
  f1 = s.bary[0] * v.y;
#pragma unroll
  for (int r = 1; r <= D; ++r) {
    v = __ldg(t + s.slot[r]);
    f0 = f0 + s.bary[r] * v.x;
    f1 = f1 + s.bary[r] * v.y;
  }
  if (window != nullptr) {
    f0 = f0 * window[l];
    f1 = f1 * window[l];
  }
}

}  // namespace
