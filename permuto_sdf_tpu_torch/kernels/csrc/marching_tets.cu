// Kernel M: marching tetrahedra over a dense scalar grid, on the card.
//
// Replaces: the host walk `marching_tets` of
// permuto_sdf_tpu/native/marching_tets.cpp:88, which
// permuto_sdf_tpu/ops/marching_cubes.py:253-262 runs on the grid that
// `extract_mesh_from_sdf_fn` brings to the host (its NumPy fallback is
// `marching_tetrahedra`, marching_cubes.py:114). Each cube of the grid is
// split into 6 tetrahedra around its 0-7 diagonal, and each tetrahedron
// emits 0-2 triangles from the 16-case table that the Python side builds
// (`_build_case_table`) and passes in. The emission order, the edge
// canonicalisation, the clamped interpolation and the weld keys are those
// of the C++ walk, so the welded mesh (done by the wrapper, in first-
// emission order) equals it.
//
// M1 (`mt_count_kernel`): one thread per cube, x-major (cube id
// (x (ny-1) + y)(nz-1) + z, the C++ loop order). It reads the 8 corners,
// classifies the cube as active when min < level <= max (any corner below
// the level and any not below it), and counts its triangles from the case
// table: a uint8 per cube, and the sum of each block's 256 cubes.
//
// M2 (`mt_emit_kernel`): the same cubes and blocks. A block's triangle
// offset is the exclusive sum of the earlier blocks' totals (the wrapper's
// cumulative sum over the block totals); inside the block an exclusive scan
// of the uint8 counts (a warp scan, then the warp totals) gives each cube
// its offset. The active cubes read their corners again and write, per
// emitted vertex in the C++ order (tetrahedron, triangle, edge), its world
// position fmaf(g, spacing, origin) (the host build contracts that
// transform into a fused multiply-add) and its weld key llround(g * 1e6)
// per axis in grid units; per triangle whether two of its keys are equal
// (the C++ drops such a face after welding its vertices).
//
// What bounds it on an H100: bytes. M1 reads the grid once (4 bytes per
// point; neighbouring cubes share corners through L1/L2) and writes a byte
// per cube; M2 reads that byte per cube and, for the active cubes only, the
// corners again, and writes 12 + 24 bytes per emitted vertex. The
// arithmetic is a few dozen operations per active cube. Nothing of size
// [cubes, 8] is materialised: the active cubes are rare (~1% of a 256^3
// grid), and only they do more than one byte of work in M2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Six-tetrahedra decomposition of the unit cube around the 0-7 diagonal;
// cube corner k is (k & 1, (k >> 1) & 1, (k >> 2) & 1). Must match _TETS in
// ops/marching_cubes.py.
__constant__ int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};
__constant__ int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

struct Grid {
  const float* __restrict__ v;
  int nx, ny, nz;
  float level;
};

__device__ __forceinline__ void cube_coords(long long c, const Grid& g, int* x, int* y, int* z) {
  const long long nz1 = g.nz - 1, ny1 = g.ny - 1;
  *z = (int)(c % nz1);
  const long long r = c / nz1;
  *y = (int)(r % ny1);
  *x = (int)(r / ny1);
}

// The 8 corner values of cube (x, y, z) and the bit mask of those below the
// level (corner k at bit k).
__device__ __forceinline__ unsigned corners(const Grid& g, int x, int y, int z, float cv[8]) {
  const long long syz = (long long)g.ny * g.nz;
  unsigned lo = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cv[k] = g.v[(long long)(x + (k & 1)) * syz + (long long)(y + ((k >> 1) & 1)) * g.nz +
                (z + ((k >> 2) & 1))];
    if (cv[k] < g.level) lo |= 1u << k;
  }
  return lo;
}

__device__ __forceinline__ int tet_case(unsigned lo, int t) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) c |= (int)((lo >> kTets[t][i]) & 1u) << i;
  return c;
}

// Sum of v over the block; `red` holds kWarps ints of shared memory.
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(PSDF_FULL_MASK, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads) mt_count_kernel(
    Grid g, long long nr_cubes, const int* __restrict__ n_tris, uint8_t* __restrict__ counts,
    int* __restrict__ block_tris) {
  int* red = psdf_dynamic_smem<int>();
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  int n = 0;
  if (c < nr_cubes) {
    int x, y, z;
    cube_coords(c, g, &x, &y, &z);
    float cv[8];
    const unsigned lo = corners(g, x, y, z, cv);
    if (lo != 0u && lo != 0xffu) {
#pragma unroll
      for (int t = 0; t < 6; ++t) n += __ldg(&n_tris[tet_case(lo, t)]);
    }
    counts[c] = (uint8_t)n;
  }
  const int total = block_sum(n, red);
  if (threadIdx.x == 0) block_tris[blockIdx.x] = total;
}

struct Placement {
  float origin[3];
  float spacing[3];
};

__global__ void __launch_bounds__(kThreads) mt_emit_kernel(
    Grid g, long long nr_cubes, const int* __restrict__ tri_edges,
    const int* __restrict__ n_tris, const uint8_t* __restrict__ counts,
    const long long* __restrict__ block_offsets, Placement place, float* __restrict__ verts,
    long long* __restrict__ keys, uint8_t* __restrict__ degenerate) {
  int* warp_tot = psdf_dynamic_smem<int>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int n = c < nr_cubes ? (int)counts[c] : 0;
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (n == 0) return;
  long long tri = block_offsets[blockIdx.x] + (incl - n);
  for (int w = 0; w < warp; ++w) tri += warp_tot[w];

  int x, y, z;
  cube_coords(c, g, &x, &y, &z);
  float cv[8];
  const unsigned lo = corners(g, x, y, z, cv);
  for (int t = 0; t < 6; ++t) {
    const int cs = tet_case(lo, t);
    const int ntri = __ldg(&n_tris[cs]);
    for (int k = 0; k < ntri; ++k, ++tri) {
      long long key[3][3];
      for (int e = 0; e < 3; ++e) {
        const int edge = __ldg(&tri_edges[(cs * 2 + k) * 3 + e]);
        int ca = kTets[t][kTetEdges[edge][0]];
        int cb = kTets[t][kTetEdges[edge][1]];
        // the edge's two corners ordered by global corner id, so every
        // tetrahedron sharing this grid edge computes the same crossing
        const long long ga = ((long long)(x + (ca & 1)) * g.ny + (y + ((ca >> 1) & 1))) * g.nz +
                             (z + ((ca >> 2) & 1));
        const long long gb = ((long long)(x + (cb & 1)) * g.ny + (y + ((cb >> 1) & 1))) * g.nz +
                             (z + ((cb >> 2) & 1));
        if (ga > gb) {
          const int tmp = ca;
          ca = cb;
          cb = tmp;
        }
        const float da = cv[ca], db = cv[cb];
        float denom = db - da;
        if (fabsf(denom) < 1e-12f) denom = 1e-12f;
        float w = (g.level - da) / denom;
        if (w < 0.f) w = 0.f;
        if (w > 1.f) w = 1.f;
        const long long vtx = tri * 3 + e;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float pa = (float)((a == 0 ? x : a == 1 ? y : z) + ((ca >> a) & 1));
          const float pb = (float)((a == 0 ? x : a == 1 ? y : z) + ((cb >> a) & 1));
          const float gc = pa + w * (pb - pa);  // w * (pb - pa) is exact: pb - pa is -1, 0 or 1
          verts[vtx * 3 + a] = fmaf(gc, place.spacing[a], place.origin[a]);
          key[e][a] = llround((double)gc * 1e6);
          keys[vtx * 3 + a] = key[e][a];
        }
      }
      const bool same01 = key[0][0] == key[1][0] && key[0][1] == key[1][1] && key[0][2] == key[1][2];
      const bool same12 = key[1][0] == key[2][0] && key[1][1] == key[2][1] && key[1][2] == key[2][2];
      const bool same02 = key[0][0] == key[2][0] && key[0][1] == key[2][1] && key[0][2] == key[2][2];
      degenerate[tri] = (uint8_t)(same01 || same12 || same02);
    }
  }
}

bool bad_dims(int nx, int ny, int nz, long long* nr_cubes, int* nr_blocks) {
  if (nx < 0 || ny < 0 || nz < 0) return true;
  *nr_cubes = (nx < 2 || ny < 2 || nz < 2)
                  ? 0
                  : (long long)(nx - 1) * (long long)(ny - 1) * (long long)(nz - 1);
  const long long blocks = (*nr_cubes + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return true;
  *nr_blocks = (int)blocks;
  return false;
}

}  // namespace

// M1: values [nx, ny, nz] float32 (x outer) -> counts [cubes] uint8 (the
// triangles of each cube) and block_tris [ceil(cubes / 256)] int32 (their
// sum per block of 256 cubes). n_tris: [16] int32 of the case table.
extern "C" int psdf_mt_count(const void* values, int nx, int ny, int nz, float level,
                             const void* n_tris, void* counts, void* block_tris, void* stream) {
  long long nr_cubes;
  int nr_blocks;
  if (bad_dims(nx, ny, nz, &nr_cubes, &nr_blocks)) return (int)cudaErrorInvalidValue;
  if (nr_blocks == 0) return (int)cudaSuccess;
  const Grid g{(const float*)values, nx, ny, nz, level};
  PSDF_LAUNCH(mt_count_kernel, nr_blocks, kThreads, kWarps * sizeof(int), stream, g, nr_cubes,
              (const int*)n_tris, (uint8_t*)counts, (int*)block_tris);
  return (int)cudaGetLastError();
}

// M2: with M1's counts and block_offsets [blocks] int64 (the exclusive sum
// of block_tris) -> verts [T * 3, 3] float32 world positions, keys
// [T * 3, 3] int64 weld keys, degenerate [T] uint8, T the total triangles.
// tri_edges: [16 * 2 * 3] int32 of the case table (-1 padded).
extern "C" int psdf_mt_emit(const void* values, int nx, int ny, int nz, float level,
                            const void* tri_edges, const void* n_tris, const void* counts,
                            const void* block_offsets, float origin_x, float origin_y,
                            float origin_z, float spacing_x, float spacing_y, float spacing_z,
                            void* verts, void* keys, void* degenerate, void* stream) {
  long long nr_cubes;
  int nr_blocks;
  if (bad_dims(nx, ny, nz, &nr_cubes, &nr_blocks)) return (int)cudaErrorInvalidValue;
  if (nr_blocks == 0) return (int)cudaSuccess;
  const Grid g{(const float*)values, nx, ny, nz, level};
  const Placement place{{origin_x, origin_y, origin_z}, {spacing_x, spacing_y, spacing_z}};
  PSDF_LAUNCH(mt_emit_kernel, nr_blocks, kThreads, kWarps * sizeof(int), stream, g, nr_cubes,
              (const int*)tri_edges, (const int*)n_tris, (const uint8_t*)counts,
              (const long long*)block_offsets, place, (float*)verts, (long long*)keys,
              (uint8_t*)degenerate);
  return (int)cudaGetLastError();
}
