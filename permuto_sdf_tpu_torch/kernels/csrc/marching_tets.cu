// Kernel M: marching tetrahedra over a dense scalar grid, on the card, and
// the weld of its emitted vertices.
//
// Replaces: the host walk `marching_tets` of
// permuto_sdf_tpu/native/marching_tets.cpp:88 (with its `Welder`, :42-73),
// which permuto_sdf_tpu/ops/marching_cubes.py:253-262 runs on the grid that
// `extract_mesh_from_sdf_fn` brings to the host (its NumPy fallback is
// `marching_tetrahedra`, marching_cubes.py:114). Each cube of the grid is
// split into 6 tetrahedra around its 0-7 diagonal, and each tetrahedron
// emits 0-2 triangles from the 16-case table that the Python side builds
// (`_build_case_table`) and passes in. The emission order, the edge
// canonicalisation, the clamped interpolation and the weld keys are those
// of the C++ walk, so the welded mesh equals it.
//
// The tiling both kernels share: a tile is one x, kRows consecutive cube
// rows y and every z, so its cubes are a run of consecutive cube ids
// (x (ny-1) + y)(nz-1) + z, the C++ loop order, and the tiles in id order
// are in emission order. A row's cubes fall into 32-cube words along z.
//
// M1 (`mt_count_kernel`): a block per tile, a warp per word. Each lane
// reads its cube column's corner values straight from the grid, both planes
// and all rows + 1 rows at once (the loads overlap; a lane's z + 1 values
// are its neighbour's z values, from L1), forms each row's "below the
// level" bits and then each cube's triangle count from a 256-entry table of
// its 8 bits (`cube_tris`, the six tetrahedra's counts summed on the Python
// side; 0 exactly for the inactive cubes). Coordinates come from the block
// and thread index: no division per cube. It writes the triangles of each
// word (int16, a warp reduction per row) and of each tile (int32).
//
// M2 (`mt_emit_kernel`): a block per tile; a tile without triangles
// returns after reading one int. Otherwise the block scans its words'
// counts from the tile's offset (the wrapper's exclusive sum over the
// tiles) and compacts the words that have triangles, which its warps take
// in turn. A warp reads its word's corners once and scans its lanes'
// counts; then each lane writes one triangle at a time (it finds the cube
// by a binary search over the scan and takes its corners by shuffles, and
// the triangle's edges from `cube_tri_corners`, the C++ order of
// tetrahedra and triangles built on the Python side): per vertex its world
// position fmaf(g, spacing, origin) (the host build contracts that
// transform into a fused multiply-add) and its weld key llround(g * 1e6)
// per axis in grid units, and per triangle whether two of its keys are
// equal (the C++ drops such a face after welding its vertices). Then the
// lanes insert the word's emissions into an open-addressing hash table
// keyed by the exact key triple, lanes with equal keys through the first
// of them: a slot holds an emission id, a probe compares the key against
// the stored emission's key (read from L2), a free slot is claimed with
// atomicCAS, and atomicMin keeps the first emission of the key. Each
// emission records its slot, so once M2 is done the slot's value is the
// key's first emission, which the Python glue ranks into vertex numbers (a
// cumulative sum, no sort). A key that finds no slot after a full turn of
// the table raises the overflow flag, which the glue reads with the mesh's
// counts and raises on; the wrapper's table of two slots per emission
// always has one free.
//
// What bounds it on an H100: bytes. M1 reads the grid once from device
// memory (plane x + 1 again from L2 for the tiles of x + 1) and writes 2
// bytes per 32 cubes. M2 touches only the tiles and words with triangles:
// their active cubes' corners, 40 bytes per emitted vertex and the table
// (int32 slots, at most half full, L2-resident at 256^3). Designs measured
// slower on the card: staging M1's planes in shared memory with cp.async
// (one x per block, or several with a ring of three planes), a warp per
// word over every word of the grid in M2, and a cube per lane (the active
// cubes are few per word, so most lanes idle).
#include "common.cuh"

namespace {

constexpr int kRows = 8;          // cube rows per tile (_TILE_ROWS in ops/marching_cubes.py)
constexpr int kMaxWarps = 8;
constexpr int kEmpty = 0x7fffffff;  // a free table slot (emission ids are below it)

struct Grid {
  const float* __restrict__ v;
  int nx, ny, nz;
  float level;
};

struct Tiles {
  int groups;  // tiles per x: ceil((ny - 1) / kRows)
  int words;   // words per row: ceil((nz - 1) / 32)
};

struct Placement {
  float origin[3];
  float spacing[3];
};

struct Table {
  int* slots;       // [mask + 1] emission ids, kEmpty where free
  unsigned mask;    // slots - 1, slots a power of two
  int* slot_of;     // [3T] the slot of each emission's key
  int* overflow;    // set when a key found no slot
};

__device__ __forceinline__ int tile_rows(const Grid& g, int y0) {
  return min(kRows, g.ny - 1 - y0);
}

// The "below the level" bits of grid row pair a (plane x) and b (plane
// x + 1) at z and z + 1, placed as cube corners with dy = 0: bit dx + 4 dz.
__device__ __forceinline__ unsigned row_bits(const float* a, const float* b, float level) {
  return (unsigned)(a[0] < level) | (unsigned)(b[0] < level) << 1 |
         (unsigned)(a[1] < level) << 4 | (unsigned)(b[1] < level) << 5;
}

// Sum of v over the block's warps; `red` holds kMaxWarps ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = (int)__reduce_add_sync(PSDF_FULL_MASK, (unsigned)v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kMaxWarps * 32) mt_count_kernel(
    Grid g, Tiles tl, const int* __restrict__ cube_tris, short* __restrict__ word_tris,
    int* __restrict__ tile_tris) {
  int* red = psdf_dynamic_smem<int>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int x = blockIdx.x / tl.groups;
  const int y0 = (blockIdx.x - x * tl.groups) * kRows;
  const int rows = tile_rows(g, y0);
  const long long plane = (long long)g.ny * g.nz;
  const float* v = g.v + ((long long)x * g.ny + y0) * g.nz;
  short* out = word_tris + ((long long)x * (g.ny - 1) + y0) * tl.words;
  int n_sum = 0;
  for (int j = warp; j < tl.words; j += nwarps) {
    const int z = j * 32 + lane;
    const bool valid = z < g.nz - 1;
    unsigned bits[kRows + 1];  // every row's bits at once: the loads overlap
#pragma unroll
    for (int r = 0; r <= kRows; ++r) {
      const float* a = v + (long long)r * g.nz + z;
      bits[r] = r <= rows && valid ? row_bits(a, a + plane, g.level) : 0u;
    }
    int mine = 0;  // lane r keeps row r's word total
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int n = r < rows && valid ? __ldg(&cube_tris[bits[r] | bits[r + 1] << 2]) : 0;
      const int sum = (int)__reduce_add_sync(PSDF_FULL_MASK, (unsigned)n);
      if (lane == r) mine = sum;
      n_sum += n;
    }
    if (lane < rows) out[(long long)lane * tl.words + j] = (short)mine;
  }
  const int total = block_sum(n_sum, red);
  if (threadIdx.x == 0) tile_tris[blockIdx.x] = total;
}

// The 8 corner values of cube (x, y, z) and the bit mask of those below the
// level (corner k at bit k).
__device__ __forceinline__ unsigned corners(const Grid& g, int x, int y, int z, float cv[8]) {
  unsigned lo = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cv[k] = g.v[((long long)(x + (k & 1)) * g.ny + (y + ((k >> 1) & 1))) * g.nz +
                (z + ((k >> 2) & 1))];
    if (cv[k] < g.level) lo |= 1u << k;
  }
  return lo;
}

// Triangle q of cube (x, y, z), whose corner values are cv and
// below-the-level bits lo: its three vertices' world positions (w[9]) and
// weld keys (k[9]), and whether two of the keys are equal. Triangle q's
// edges come from cube_tri_corners (the C++ order: tetrahedron, then
// triangle; each edge's corners ordered by global corner id, so every
// tetrahedron sharing a grid edge computes the same crossing).
__device__ __forceinline__ bool emit_triangle(const Grid& g,
                                              const uint8_t* __restrict__ cube_tri_corners,
                                              const Placement& place, int x, int y, int z,
                                              const float cv[8], unsigned lo, int q, float* w,
                                              long long* k) {
  for (int e = 0; e < 3; ++e) {
    const unsigned pair = __ldg(&cube_tri_corners[(lo * 12 + q) * 3 + e]);
    const int ca = pair & 7, cb = pair >> 3;
    const float da = cv[ca], db = cv[cb];
    float denom = db - da;
    if (fabsf(denom) < 1e-12f) denom = 1e-12f;
    float t = (g.level - da) / denom;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pa = (float)((a == 0 ? x : a == 1 ? y : z) + ((ca >> a) & 1));
      const float pb = (float)((a == 0 ? x : a == 1 ? y : z) + ((cb >> a) & 1));
      const float gc = pa + t * (pb - pa);  // t * (pb - pa) is exact: pb - pa is -1, 0 or 1
      w[e * 3 + a] = fmaf(gc, place.spacing[a], place.origin[a]);
      k[e * 3 + a] = llround((double)gc * 1e6);
    }
  }
  const bool same01 = k[0] == k[3] && k[1] == k[4] && k[2] == k[5];
  const bool same12 = k[3] == k[6] && k[4] == k[7] && k[5] == k[8];
  const bool same02 = k[0] == k[6] && k[1] == k[7] && k[2] == k[8];
  return same01 || same12 || same02;
}

__device__ __forceinline__ unsigned hash_key(long long a, long long b, long long c) {
  unsigned long long h = (unsigned long long)a * 0x9E3779B97F4A7C15ull;
  h ^= (unsigned long long)b * 0xC2B2AE3D27D4EB4Full;
  h ^= (unsigned long long)c * 0x165667B19E3779F9ull;
  h ^= h >> 32;
  h *= 0xD6E8FEB86659FD93ull;
  h ^= h >> 32;
  return (unsigned)h;
}

// Inserts emission e with key (k0, k1, k2), written and fenced, into the
// table; returns its key's slot (0 with the overflow flag raised if the
// table has none free).
__device__ __forceinline__ int insert(const Table& tab, const long long* keys, long long e,
                                      long long k0, long long k1, long long k2, unsigned h) {
  h &= tab.mask;
  for (unsigned p = 0; p <= tab.mask; ++p, h = (h + 1) & tab.mask) {
    const int s = atomicCAS(&tab.slots[h], kEmpty, (int)e);
    if (s == kEmpty) return (int)h;
    // s only ever holds emissions of the key that claimed the slot
    if (__ldcg(&keys[3LL * s]) == k0 && __ldcg(&keys[3LL * s + 1]) == k1 &&
        __ldcg(&keys[3LL * s + 2]) == k2) {
      if (s > e) atomicMin(&tab.slots[h], (int)e);
      return (int)h;
    }
  }
  *tab.overflow = 1;
  return 0;
}

// Exclusive sum of v over the block's threads, and the block's total;
// `red` holds kMaxWarps ints. Ends with a barrier.
__device__ __forceinline__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) before += red[w];
    sum += red[w];
  }
  *total = sum;
  __syncthreads();
  return before + incl - v;
}

// A warp's stage of 32 triangles: their 96 vertices' keys and world
// positions, written out to the emission arrays in whole rows.
struct Stage {
  long long keys[32 * 9];
  float verts[32 * 9];
};

// Emits and welds one word of the tile (x, cube row y, cubes z0 .. z0 + 31)
// with wt triangles from triangle word_tri on; the calling warp's lanes
// together, 32 triangles at a time.
__device__ __forceinline__ void emit_word(
    const Grid& g, const int* __restrict__ cube_tris,
    const uint8_t* __restrict__ cube_tri_corners, const Placement& place, int x, int y, int z0,
    int wt, long long word_tri, float* __restrict__ verts, long long* keys,
    uint8_t* __restrict__ degenerate, const Table& tab, Stage* st) {
  const int lane = threadIdx.x & 31;
  float cv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  unsigned lo = 0;
  int n = 0;
  if (z0 + lane < g.nz - 1) {
    lo = corners(g, x, y, z0 + lane, cv);
    n = __ldg(&cube_tris[lo]);
  }
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(PSDF_FULL_MASK, incl, off);
    if (lane >= off) incl += v;
  }
  for (int base = 0; base < wt; base += 32) {
    // a triangle per lane: triangle i of the word belongs to the first lane
    // whose inclusive count exceeds i, and takes that lane's corners
    const int i = base + lane, cnt = min(32, wt - base);
    int o = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(PSDF_FULL_MASK, incl, o + step - 1) <= i) o += step;
    const int q = i - __shfl_sync(PSDF_FULL_MASK, incl, o) + __shfl_sync(PSDF_FULL_MASK, n, o);
    const unsigned olo = __shfl_sync(PSDF_FULL_MASK, lo, o);
    float ocv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) ocv[k] = __shfl_sync(PSDF_FULL_MASK, cv[k], o);
    const long long tri0 = word_tri + base;
    if (i < wt)
      degenerate[tri0 + lane] = emit_triangle(g, cube_tri_corners, place, x, y, z0 + o, ocv,
                                              olo, q, st->verts + 9 * lane, st->keys + 9 * lane);
    __syncwarp();
    psdf_warp_copy(verts + 9 * tri0, st->verts, 36 * cnt);
    psdf_warp_copy(keys + 9 * tri0, st->keys, 72 * cnt);
    // the keys are visible on the card before any lane publishes an
    // emission id in the table
    __syncwarp();
    __threadfence();
    // the round's emissions, 32 at a time: lanes whose keys are equal
    // (equal hashes, then the keys compared) leave the table to the first
    for (int j = lane; j - lane < 3 * cnt; j += 32) {
      const bool on = j < 3 * cnt;
      const long long k0 = on ? st->keys[3 * j] : 0, k1 = on ? st->keys[3 * j + 1] : 0,
                      k2 = on ? st->keys[3 * j + 2] : 0;
      const unsigned h = hash_key(k0, k1, k2);
      const unsigned peers =
          __match_any_sync(PSDF_FULL_MASK, h) & __ballot_sync(PSDF_FULL_MASK, on);
      const int lead = peers ? __ffs(peers) - 1 : lane;
      const long long l0 = __shfl_sync(PSDF_FULL_MASK, k0, lead);
      const long long l1 = __shfl_sync(PSDF_FULL_MASK, k1, lead);
      const long long l2 = __shfl_sync(PSDF_FULL_MASK, k2, lead);
      const bool follow = lead != lane && l0 == k0 && l1 == k1 && l2 == k2;
      const long long e = 3 * tri0 + j;
      const int slot = on && !follow ? insert(tab, keys, e, k0, k1, k2, h) : 0;
      const int lead_slot = __shfl_sync(PSDF_FULL_MASK, slot, lead);
      if (on) tab.slot_of[e] = follow ? lead_slot : slot;
    }
    __syncwarp();  // the stage is rewritten by the next round
  }
}

// (5 blocks of 256 threads an SM: 48 registers a thread; more registers
// and fewer warps in flight measured slower)
__global__ void __launch_bounds__(kMaxWarps * 32, 5) mt_emit_kernel(
    Grid g, Tiles tl, const int* __restrict__ cube_tris,
    const uint8_t* __restrict__ cube_tri_corners, const short* __restrict__ word_tris,
    const int* __restrict__ tile_tris, const long long* __restrict__ tile_offsets,
    Placement place, float* __restrict__ verts, long long* keys,
    uint8_t* __restrict__ degenerate, Table tab) {
  if (tile_tris[blockIdx.x] == 0) return;
  // the active words of blockDim words at a time: their index and offset;
  // a stage per warp
  int* red = psdf_dynamic_smem<int>();
  int* word = red + kMaxWarps;
  int* offset = word + blockDim.x;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  Stage* st = reinterpret_cast<Stage*>(offset + blockDim.x) + warp;
  const int x = blockIdx.x / tl.groups;
  const int y0 = (blockIdx.x - x * tl.groups) * kRows;
  const int nwords = tile_rows(g, y0) * tl.words;
  const short* counts = word_tris + ((long long)x * (g.ny - 1) + y0) * tl.words;
  long long tri0 = tile_offsets[blockIdx.x];
  for (int w0 = 0; w0 < nwords; w0 += blockDim.x) {
    const int w = w0 + (int)threadIdx.x;
    const int c = w < nwords ? (int)counts[w] : 0;
    int total, active;
    const int off = block_scan(c, red, &total);
    const int rank = block_scan(c > 0, red, &active);
    if (c > 0) {
      word[rank] = w;
      offset[rank] = off;
    }
    __syncthreads();
    // dealt round-robin: a sphere's active words sit at the same z in
    // every row, so a warp per word index would leave most warps idle
    for (int k = warp; k < active; k += nwarps) {
      const int r = word[k] / tl.words;
      emit_word(g, cube_tris, cube_tri_corners, place, x, y0 + r, (word[k] - r * tl.words) * 32,
                counts[word[k]], tri0 + offset[k], verts, keys, degenerate, tab, st);
    }
    tri0 += total;
    __syncthreads();  // word and offset are rewritten for the next words
  }
}

// The shared tiling of a [nx, ny, nz] grid: false for what the kernels
// cannot take. No cube leaves *nr_tiles 0.
bool tiling(int nx, int ny, int nz, Tiles* tl, int* nr_tiles) {
  if (nx < 0 || ny < 0 || nz < 0) return false;
  *nr_tiles = 0;
  if (nx < 2 || ny < 2 || nz < 2) return true;
  tl->groups = (ny - 1 + kRows - 1) / kRows;
  tl->words = (nz - 1 + 31) / 32;
  const long long tiles = (long long)(nx - 1) * tl->groups;
  if (tiles >= (1LL << 31)) return false;
  *nr_tiles = (int)tiles;
  return true;
}

}  // namespace

// M1: values [nx, ny, nz] float32 (x outer) -> word_tris [(nx-1)(ny-1),
// ceil((nz-1)/32)] int16 (the triangles of each 32-cube word of each cube
// row) and tile_tris [(nx-1) ceil((ny-1)/8)] int32 (of each tile). cube_tris:
// [256] int32, a cube's triangles by its corners' below-the-level bits.
extern "C" int psdf_mt_count(const void* values, int nx, int ny, int nz, float level,
                             const void* cube_tris, void* word_tris, void* tile_tris,
                             void* stream) {
  Tiles tl;
  int nr_tiles;
  if (!tiling(nx, ny, nz, &tl, &nr_tiles)) return (int)cudaErrorInvalidValue;
  if (nr_tiles == 0) return (int)cudaSuccess;
  const Grid g{(const float*)values, nx, ny, nz, level};
  const int warps = tl.words < kMaxWarps ? tl.words : kMaxWarps;
  PSDF_LAUNCH(mt_count_kernel, nr_tiles, 32 * warps, kMaxWarps * sizeof(int), stream, g, tl,
              (const int*)cube_tris, (short*)word_tris, (int*)tile_tris);
  return (int)cudaGetLastError();
}

// M2: with M1's outputs and tile_offsets [tiles] int64 (the exclusive sum
// of tile_tris) -> verts [3T, 3] float32 world positions, keys [3T, 3]
// int64 weld keys, degenerate [T] uint8, T the total triangles; each
// emission inserted into table [slots] int32 (a power of two, filled with
// 0x7fffffff), its slot in slot_of [3T] int32; overflow [1] int32 (0 on
// entry) set if a key found no slot. cube_tris as M1's; cube_tri_corners
// [256 * 12 * 3] uint8, each triangle's edges' ordered corners ca | cb << 3.
extern "C" int psdf_mt_emit(const void* values, int nx, int ny, int nz, float level,
                            const void* cube_tris, const void* cube_tri_corners,
                            const void* word_tris, const void* tile_tris,
                            const void* tile_offsets, float origin_x, float origin_y,
                            float origin_z, float spacing_x, float spacing_y, float spacing_z,
                            void* verts, void* keys, void* degenerate, void* table,
                            long long slots, void* slot_of, void* overflow, void* stream) {
  Tiles tl;
  int nr_tiles;
  if (!tiling(nx, ny, nz, &tl, &nr_tiles)) return (int)cudaErrorInvalidValue;
  if (slots < 1 || slots > (1LL << 31) || (slots & (slots - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (nr_tiles == 0) return (int)cudaSuccess;
  const Grid g{(const float*)values, nx, ny, nz, level};
  const Placement place{{origin_x, origin_y, origin_z}, {spacing_x, spacing_y, spacing_z}};
  const Table tab{(int*)table, (unsigned)(slots - 1), (int*)slot_of, (int*)overflow};
  const long long words = (long long)(ny - 1 < kRows ? ny - 1 : kRows) * tl.words;
  const int warps = words < kMaxWarps ? (int)words : kMaxWarps;
  const size_t smem = (kMaxWarps + 2 * 32 * warps) * sizeof(int) + warps * sizeof(Stage);
  PSDF_LAUNCH(mt_emit_kernel, nr_tiles, 32 * warps, smem, stream, g, tl, (const int*)cube_tris,
              (const uint8_t*)cube_tri_corners, (const short*)word_tris, (const int*)tile_tris,
              (const long long*)tile_offsets, place, (float*)verts, (long long*)keys,
              (uint8_t*)degenerate, tab);
  return (int)cudaGetLastError();
}
