// Kernel J1 (sphere_trace.cu) beside the forms it was measured against, for
// measurement only. Design 0 is the port's launch (jump_prepass_kernel at
// 256 rows a block, then round 0's list); 1 and 2 launch the port's kernels
// at 128 and 512 rows a block; 3-5 replace the first launch by
// jump_prepass_form_kernel: the field's lookups under an L2 evict_last
// policy (3), the rows' origins and directions staged in shared memory in
// neighbouring words (4), or both (5). Designs 0-5 give the port's t,
// flags, count and round-0 list bit for bit. Design 6 is the kernel J1
// replaced in PR 16: a thread a row, the count by one atomic a warp (into a
// zeroed count), no list. Built and timed by profiling/j1_designs.py; no
// path of the port calls it.
#include "sphere_trace.cu"

namespace {

// An L2 policy under which the lines a load brings in are evicted after
// lines of normal priority, and a one-byte read-only load under it.
__device__ __forceinline__ unsigned long long l2_evict_last() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ int load_u8_hint(const uint8_t* p, unsigned long long policy) {
  unsigned short v;
  asm volatile("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;\n" : "=h"(v) : "l"(p), "l"(policy));
  return v;
}

// jump_along with the field's loads under `policy` (field_at's arithmetic)
__device__ __forceinline__ float jump_along_hint(const uint8_t* __restrict__ field,
                                                 const GridArgs& g, float ox, float oy,
                                                 float oz, float dx, float dy, float dz,
                                                 float t, int jumps) {
  const unsigned long long policy = l2_evict_last();
  for (int j = 0; j < jumps; ++j) {
    const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
    const int ix = (int)floorf(((px - g.tx) + g.half_extent) / g.voxel_size);
    const int iy = (int)floorf(((py - g.ty) + g.half_extent) / g.voxel_size);
    const int iz = (int)floorf(((pz - g.tz) + g.half_extent) / g.voxel_size);
    const int k = (ix < 0 || ix >= g.V || iy < 0 || iy >= g.V || iz < 0 || iz >= g.V)
                      ? g.cap
                      : load_u8_hint(field + ((long long)ix * g.V + iy) * g.V + iz, policy);
    if (k <= 1) break;
    t = t + (float)(k - 1) * g.voxel_size;
  }
  return t;
}

// jump_prepass_kernel with the evict_last loads and/or the staged state;
// its shared memory: the staged state (kStage), then the tile count's.
template <int kRows, bool kEvictLast, bool kStage>
__global__ void __launch_bounds__(kRows) jump_prepass_form_kernel(
    int n_rows, int R, const uint8_t* __restrict__ field, GridArgs g,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_exit, float* __restrict__ t,
    uint8_t* __restrict__ alive, int jumps, int* __restrict__ tile_counts) {
  float* s_od = psdf_dynamic_smem<float>() + 2 * (kRows / 32);
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;
  const long long r = r0 + tid;
  if (kStage) {
    const int nr = (int)min((long long)kRows, n_rows - r0);
    for (int i = tid; i < 3 * nr; i += kRows) {
      s_od[i] = origins[r0 * 3 + i];
      s_od[3 * kRows + i] = dirs[r0 * 3 + i];
    }
    __syncthreads();
  }
  bool a = false;
  if (r < n_rows) {
    a = alive[r] != 0;
    if (a) {
      const float* o = kStage ? s_od + 3 * tid : origins + r * 3;
      const float* d = kStage ? s_od + 3 * kRows + 3 * tid : dirs + r * 3;
      const float tt = kEvictLast
                           ? jump_along_hint(field, g, o[0], o[1], o[2], d[0], d[1], d[2], t[r],
                                             jumps)
                           : jump_along(field, g, o[0], o[1], o[2], d[0], d[1], d[2], t[r],
                                        jumps);
      t[r] = tt;
      a = tt <= t_exit[r];
      alive[r] = a ? 1 : 0;
    }
  }
  prepass_tile_count<kRows>(a && r < R, tile_counts);
}

__global__ void __launch_bounds__(256) jump_prepass_rowwise_kernel(
    int n_rows, int R, const uint8_t* __restrict__ field, GridArgs g,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_exit, float* __restrict__ t,
    uint8_t* __restrict__ alive, int jumps, int* __restrict__ count) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool a = false;
  if (r < n_rows) {
    a = alive[r] != 0;
    if (a) {
      const float tt = jump_along(field, g, origins[r * 3 + 0], origins[r * 3 + 1],
                                  origins[r * 3 + 2], dirs[r * 3 + 0], dirs[r * 3 + 1],
                                  dirs[r * 3 + 2], t[r], jumps);
      t[r] = tt;
      a = tt <= t_exit[r];
      alive[r] = a ? 1 : 0;
    }
  }
  const unsigned n = __ballot_sync(PSDF_FULL_MASK, a && r < R);
  if ((threadIdx.x & 31) == 0 && n != 0) atomicAdd(count, __popc(n));
}

template <int kRows, bool kEvictLast, bool kStage>
int launch_form(int n_rows, int R, int list_size, const void* field, const GridArgs& g,
                const void* origins, const void* dirs, const void* t_exit, void* t,
                void* alive, int jumps, void* count, void* list, void* tile_counts,
                void* stream) {
  const auto form = jump_prepass_form_kernel<kRows, kEvictLast, kStage>;
  if (kStage) {  // the staged state takes the launch's shared memory past the tile count's
    const int n_tiles = psdf_blocks(n_rows, kRows);
    if (n_tiles == 0) return 0;
    PSDF_LAUNCH(form, n_tiles, kRows, sizeof(float) * (6 * kRows + 2 * (kRows / 32)), stream,
                n_rows, R, (const uint8_t*)field, g, (const float*)origins,
                (const float*)dirs, (const float*)t_exit, (float*)t, (uint8_t*)alive, jumps,
                (int*)tile_counts);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const auto write_list = jump_prepass_list_kernel<kRows>;
    PSDF_LAUNCH(write_list, psdf_blocks(max(n_rows, list_size), kRows), kRows,
                sizeof(int) * 2 * (kRows / 32), stream, R, list_size, (const uint8_t*)alive,
                (const int*)tile_counts, n_tiles, (int*)count, (long long*)list);
    return (int)cudaGetLastError();
  }
  return launch_jump_prepass<kRows>(form, n_rows, R, list_size, field, g, origins, dirs, t_exit,
                                    t, alive, jumps, count, list, tile_counts, stream);
}

}  // namespace

extern "C" int psdf_jump_prepass_design(int design, int n_rows, int R, int list_size,
                                        const void* field, int V, float half_extent, float tx,
                                        float ty, float tz, float voxel_size, int cap,
                                        const void* origins, const void* dirs,
                                        const void* t_exit, void* t, void* alive, int jumps,
                                        void* count, void* list, void* tile_counts,
                                        void* stream) {
  const GridArgs g = grid_args(V, half_extent, tx, ty, tz, voxel_size, cap);
  switch (design) {
    case 0:
      return launch_jump_prepass<256>(jump_prepass_kernel<256>, n_rows, R, list_size, field, g,
                                      origins, dirs, t_exit, t, alive, jumps, count, list,
                                      tile_counts, stream);
    case 1:
      return launch_jump_prepass<128>(jump_prepass_kernel<128>, n_rows, R, list_size, field, g,
                                      origins, dirs, t_exit, t, alive, jumps, count, list,
                                      tile_counts, stream);
    case 2:
      return launch_jump_prepass<512>(jump_prepass_kernel<512>, n_rows, R, list_size, field, g,
                                      origins, dirs, t_exit, t, alive, jumps, count, list,
                                      tile_counts, stream);
    case 3:
      return launch_form<256, true, false>(n_rows, R, list_size, field, g, origins, dirs, t_exit,
                                           t, alive, jumps, count, list, tile_counts, stream);
    case 4:
      return launch_form<256, false, true>(n_rows, R, list_size, field, g, origins, dirs,
                                           t_exit, t, alive, jumps, count, list, tile_counts,
                                           stream);
    case 5:
      return launch_form<256, true, true>(n_rows, R, list_size, field, g, origins, dirs, t_exit,
                                          t, alive, jumps, count, list, tile_counts, stream);
    case 6: {
      const int grid = psdf_blocks(n_rows, 256);
      if (grid == 0) return 0;
      PSDF_LAUNCH(jump_prepass_rowwise_kernel, grid, 256, 0, stream, n_rows, R,
                  (const uint8_t*)field, g, (const float*)origins, (const float*)dirs,
                  (const float*)t_exit, (float*)t, (uint8_t*)alive, jumps, (int*)count);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
