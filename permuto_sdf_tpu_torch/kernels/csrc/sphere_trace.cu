// Kernel J0: the Chebyshev empty-space distance field of the occupancy grid.
// Kernel J1: the jump-only prepass of the sphere tracer.
// Kernel J2: one trace iteration of a bucket of rays, after its SDF values.
// Kernel J3: one trace iteration of the plain tracers, on position state.
//
// Replaces: permuto_sdf_tpu/ops/occupancy_grid.py:315
// `chebyshev_empty_distance` (J0), permuto_sdf_tpu/ops/sphere_trace.py:394
// `_jump_prepass_impl` (J1), the body of one iteration of :308
// `_trace_rounds_impl` after the SDF evaluation, lines 337-375 (J2), and
// the body of `sphere_trace`'s loop after its SDF evaluation, :88-113, which
// is also the inner iteration of `sphere_trace_compacted`, :225-253 (J3).
// The JAX package leaves them to XLA.
//
// What bounds them on an H100: bytes and memory latency. J0 reads the
// 16.8 MB bool grid and writes the 16.8 MB uint8 field (three passes move
// about 100 MB, all of it in or near the 50 MB L2); its integer work is up
// to 2 x 63 min/max per voxel and pass where the grid is empty. J1 and J2
// read and write a few bytes of state per ray (origin, direction, t, t_exit,
// the flags) and gather one byte of the field per jump, at positions that
// follow the ray: scattered one-byte reads of a field that stays in L2.
//
// Design of J0: the JAX op takes `max_dist` sweeps of a 3x3x3 min-pool
// (d = min(d, minpool(d) + 1), voxels outside the grid ignored). The same
// integers come from three separable 1-D passes (z, y, x), each
// out[a] = min over a' of max(|a - a'|, in[a']), starting from 0 on an
// occupied voxel and `cap` on an empty one: the L-inf distance to the
// nearest occupied voxel, capped. A block loads 32 lines of the pass's axis
// into shared memory (a [V][32] byte tile), and each thread scans outward
// from its voxel until the offset reaches its best value (at most `cap`
// steps). The field is uint8 (values 0..cap, cap <= 255): a 256^3 field is
// 16.8 MB and stays in L2 while J1 and J2 gather from it.
//
// Design of J1 and J2: one thread per ray. A jump reads the field at
// o + t d (one byte) and advances t by max(k - 1, 0) voxels; a jump of 0
// leaves t as it is, so the remaining jumps of that ray are skipped (they
// would read the same voxel). J2 gathers its bucket's state through `idx`,
// updates it in place and writes the next SDF positions o + t d; fill slots
// (idx >= R) write nothing back (their state would not change: the pad row
// is never alive). With `counts`, the warp counts its still-active and its
// converged rays with a ballot and adds them with one atomic each: every
// active ray of the frame is in the bucket, so these are the round's
// counts (the hits before the round are added on the host).
//
// Design of J3: one thread per row of an index list (or every row when the
// list is null: the full-state loop of `sphere_trace`), in place on the
// full-size state padded by a fill row R, as J2. Where J2 keeps the
// distance t, J3 keeps the position, as the JAX tracers do, and follows
// their order: the activity (not converged, alive) is taken before the
// step, the step is pos + d (s mult), the convergence test |s| < thresh
// comes after it, one Chebyshev jump is gated on s > one voxel, and a ray
// dies when its new position leaves the bound sphere (unless converged).
// With `sdf_f` the active rows store s (the compacted round). With
// `pos_out` the slot's new position is written there too, so the next SDF
// evaluation of a bucket needs no gather; fill slots write the fill row's
// position and change nothing.
#include "common.cuh"

namespace {

struct GridArgs {
  int V;
  float half_extent, tx, ty, tz, voxel_size;
  int cap;  // the distance of a point outside the grid
};

__device__ __forceinline__ int field_at(const uint8_t* __restrict__ field,
                                        const GridArgs& g, float px, float py,
                                        float pz) {
  const int ix = (int)floorf(((px - g.tx) + g.half_extent) / g.voxel_size);
  const int iy = (int)floorf(((py - g.ty) + g.half_extent) / g.voxel_size);
  const int iz = (int)floorf(((pz - g.tz) + g.half_extent) / g.voxel_size);
  if (ix < 0 || ix >= g.V || iy < 0 || iy >= g.V || iz < 0 || iz >= g.V)
    return g.cap;
  return field[((long long)ix * g.V + iy) * g.V + iz];
}

// Jumps t along the ray while the field allows, at most `jumps` times.
__device__ __forceinline__ float jump_along(const uint8_t* __restrict__ field,
                                            const GridArgs& g, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float t,
                                            int jumps) {
  for (int j = 0; j < jumps; ++j) {
    const int k = field_at(field, g, ox + t * dx, oy + t * dy, oz + t * dz);
    if (k <= 1) break;  // a jump of 0: the rest read the same voxel
    t = t + (float)(k - 1) * g.voxel_size;
  }
  return t;
}

constexpr int kLines = 32;  // lines of one pass per block (one per lane)
constexpr int kRows = 8;    // warps per block, each walks every 8th voxel

// J0, one pass along one axis. Line l = (u, w) starts at u * su + w * sw and
// its voxels are `es` apart. With `from_occupancy`, `in` is the bool grid
// and the pass starts from 0 (occupied) / cap (empty).
__global__ void __launch_bounds__(kLines * kRows) chebyshev_pass_kernel(
    int V, long long su, long long sw, long long es, int from_occupancy,
    int cap, const uint8_t* __restrict__ in, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x >> 5;
  const long long l = (long long)blockIdx.x * kLines + lane;
  const bool ok = l < (long long)V * V;
  const long long base = ok ? (l / V) * su + (l % V) * sw : 0;
  uint8_t* tile = psdf_dynamic_smem<uint8_t>();
  for (int a = row; a < V; a += kRows) {
    uint8_t v = 0;
    if (ok) {
      v = in[base + a * es];
      if (from_occupancy) v = v ? 0 : (uint8_t)cap;
    }
    tile[a * kLines + lane] = v;
  }
  __syncthreads();
  if (!ok) return;
  for (int a = row; a < V; a += kRows) {
    int best = tile[a * kLines + lane];
    for (int d = 1; d < best; ++d) {
      if (a - d >= 0) best = min(best, max(d, (int)tile[(a - d) * kLines + lane]));
      if (a + d < V) best = min(best, max(d, (int)tile[(a + d) * kLines + lane]));
    }
    out[base + a * es] = (uint8_t)best;
  }
}

// J1: `jumps` chained jumps on every alive row, then alive &= t <= t_exit,
// and the number of alive rows below R.
__global__ void __launch_bounds__(256) jump_prepass_kernel(
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

// J2: for bucket slot j and ray r = idx[j] (< R): with `s` (the SDF at the
// ray's current position), the update of one trace iteration; then the
// position o + t d of the (updated) ray into pos_out[j]. Without `s`, only
// the positions (the first iteration of a round).
__global__ void __launch_bounds__(256) trace_step_kernel(
    int B, long long R, const long long* __restrict__ idx,
    const float* __restrict__ s_in, const float* __restrict__ origins,
    const float* __restrict__ dirs, const float* __restrict__ t_exit,
    float* __restrict__ t_f, uint8_t* __restrict__ alive_f,
    uint8_t* __restrict__ conv_f, float* __restrict__ sdf_f,
    const uint8_t* __restrict__ field, GridArgs g, float mult, float thr,
    float gate, int substeps, float* __restrict__ pos_out,
    int* __restrict__ counts) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool active = false, hit = false;
  if (j < B) {
    const long long r = idx[j];
    const bool real = r < R;
    const long long row = real ? r : R;  // fill slots read the pad row
    const float ox = origins[row * 3 + 0], oy = origins[row * 3 + 1],
                oz = origins[row * 3 + 2];
    const float dx = dirs[row * 3 + 0], dy = dirs[row * 3 + 1],
                dz = dirs[row * 3 + 2];
    float t = t_f[row];
    bool alive = real && alive_f[row] != 0;
    bool conv = conv_f[row] != 0;
    if (s_in != nullptr && real) {
      const float s = s_in[j];
      float sdf = sdf_f[r];
      bool act = !conv && alive;
      if (act) sdf = s;
      conv = conv || (fabsf(s) < thr && alive);
      act = !conv && alive;
      float t_new = t + s * mult;
      if (field != nullptr) {
        if (!act) t_new = t;
        if (act && s > gate)
          t_new = jump_along(field, g, ox, oy, oz, dx, dy, dz, t_new, substeps);
      }
      const bool dead = t_new > t_exit[r];
      alive = alive && (conv || !dead);
      if (act) t = t_new;
      t_f[r] = t;
      alive_f[r] = alive ? 1 : 0;
      conv_f[r] = conv ? 1 : 0;
      sdf_f[r] = sdf;
    }
    pos_out[j * 3 + 0] = ox + t * dx;
    pos_out[j * 3 + 1] = oy + t * dy;
    pos_out[j * 3 + 2] = oz + t * dz;
    active = alive && !conv;
    hit = alive && conv;
  }
  if (counts != nullptr) {
    const unsigned na = __ballot_sync(PSDF_FULL_MASK, active);
    const unsigned nh = __ballot_sync(PSDF_FULL_MASK, hit);
    if ((threadIdx.x & 31) == 0) {
      if (na != 0) atomicAdd(&counts[0], __popc(na));
      if (nh != 0) atomicAdd(&counts[1], __popc(nh));
    }
  }
}

// J3: for slot j and row r = idx[j] (or j without idx), with s[j] the SDF
// at the row's position: the plain tracers' step, in place.
__global__ void __launch_bounds__(256) trace_step_pos_kernel(
    int B, long long R, const long long* __restrict__ idx,
    const float* __restrict__ s_in, const float* __restrict__ dirs,
    float* __restrict__ pos_f, uint8_t* __restrict__ alive_f,
    uint8_t* __restrict__ conv_f, float* __restrict__ sdf_f,
    const uint8_t* __restrict__ field, GridArgs g, float mult, float thr,
    float gate, float cx, float cy, float cz, float r2,
    float* __restrict__ pos_out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const long long r = idx != nullptr ? idx[j] : j;
  if (r >= R) {  // a fill slot: the fill row stays as it is
    if (pos_out != nullptr)
      for (int c = 0; c < 3; ++c) pos_out[j * 3 + c] = pos_f[R * 3 + c];
    return;
  }
  const float dx = dirs[r * 3 + 0], dy = dirs[r * 3 + 1], dz = dirs[r * 3 + 2];
  float px = pos_f[r * 3 + 0], py = pos_f[r * 3 + 1], pz = pos_f[r * 3 + 2];
  bool alive = alive_f[r] != 0;
  bool conv = conv_f[r] != 0;
  const float s = s_in[j];
  if (!conv && alive) {
    if (sdf_f != nullptr) sdf_f[r] = s;
    const float m = s * mult;
    px = px + dx * m;
    py = py + dy * m;
    pz = pz + dz * m;
  }
  conv = conv || (fabsf(s) < thr && alive);
  if (field != nullptr && !conv && alive && s > gate) {
    const int k = field_at(field, g, px, py, pz);
    const float jump = (float)max(k - 1, 0) * g.voxel_size;
    px = px + jump * dx;
    py = py + jump * dy;
    pz = pz + jump * dz;
  }
  const float ex = px - cx, ey = py - cy, ez = pz - cz;
  const bool inside = (ex * ex + ey * ey) + ez * ez < r2;
  alive = alive && (conv || inside);
  pos_f[r * 3 + 0] = px;
  pos_f[r * 3 + 1] = py;
  pos_f[r * 3 + 2] = pz;
  alive_f[r] = alive ? 1 : 0;
  conv_f[r] = conv ? 1 : 0;
  if (pos_out != nullptr) {
    pos_out[j * 3 + 0] = px;
    pos_out[j * 3 + 1] = py;
    pos_out[j * 3 + 2] = pz;
  }
}

GridArgs grid_args(int V, float half_extent, float tx, float ty, float tz,
                   float voxel_size, int cap) {
  GridArgs g;
  g.V = V;
  g.half_extent = half_extent;
  g.tx = tx;
  g.ty = ty;
  g.tz = tz;
  g.voxel_size = voxel_size;
  g.cap = cap;
  return g;
}

}  // namespace

// J0: field [V^3] uint8 from occupancy [V^3] bool; scratch [V^3] uint8.
extern "C" int psdf_chebyshev_field(int V, int cap, const void* occupancy,
                                    void* scratch, void* field, void* stream) {
  if (V <= 0 || cap < 0 || cap > 255) return (int)cudaErrorInvalidValue;
  const long long vv = (long long)V * V;
  const int grid = psdf_blocks(vv, kLines);
  const size_t smem = (size_t)V * kLines;
  const int block = kLines * kRows;
  // z (stride 1), then y (stride V), then x (stride V^2)
  PSDF_LAUNCH(chebyshev_pass_kernel, grid, block, smem, stream, V, vv,
              (long long)V, 1ll, 1, cap, (const uint8_t*)occupancy,
              (uint8_t*)field);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  PSDF_LAUNCH(chebyshev_pass_kernel, grid, block, smem, stream, V, vv, 1ll,
              (long long)V, 0, cap, (const uint8_t*)field, (uint8_t*)scratch);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  PSDF_LAUNCH(chebyshev_pass_kernel, grid, block, smem, stream, V,
              (long long)V, 1ll, vv, 0, cap, (const uint8_t*)scratch,
              (uint8_t*)field);
  return (int)cudaGetLastError();
}

extern "C" int psdf_jump_prepass(int n_rows, int R, const void* field, int V,
                                 float half_extent, float tx, float ty,
                                 float tz, float voxel_size, int cap,
                                 const void* origins, const void* dirs,
                                 const void* t_exit, void* t, void* alive,
                                 int jumps, void* count, void* stream) {
  const int block = 256;
  const int grid = psdf_blocks(n_rows, block);
  if (grid == 0) return 0;
  PSDF_LAUNCH(jump_prepass_kernel, grid, block, 0, stream, n_rows, R,
              (const uint8_t*)field,
              grid_args(V, half_extent, tx, ty, tz, voxel_size, cap),
              (const float*)origins, (const float*)dirs, (const float*)t_exit,
              (float*)t, (uint8_t*)alive, jumps, (int*)count);
  return (int)cudaGetLastError();
}

extern "C" int psdf_trace_step(int B, int R, const void* idx, const void* s,
                               const void* origins, const void* dirs,
                               const void* t_exit, void* t, void* alive,
                               void* conv, void* sdf, const void* field, int V,
                               float half_extent, float tx, float ty, float tz,
                               float voxel_size, int cap, float mult,
                               float thr, float gate, int substeps,
                               void* pos_out, void* counts, void* stream) {
  const int block = 256;
  const int grid = psdf_blocks(B, block);
  if (grid == 0) return 0;
  PSDF_LAUNCH(trace_step_kernel, grid, block, 0, stream, B, (long long)R,
              (const long long*)idx, (const float*)s, (const float*)origins,
              (const float*)dirs, (const float*)t_exit, (float*)t,
              (uint8_t*)alive, (uint8_t*)conv, (float*)sdf,
              (const uint8_t*)field,
              grid_args(V, half_extent, tx, ty, tz, voxel_size, cap), mult,
              thr, gate, substeps, (float*)pos_out, (int*)counts);
  return (int)cudaGetLastError();
}

extern "C" int psdf_trace_step_pos(int B, int R, const void* idx, const void* s,
                                   const void* dirs, void* pos, void* alive,
                                   void* conv, void* sdf, const void* field,
                                   int V, float half_extent, float tx, float ty,
                                   float tz, float voxel_size, int cap,
                                   float mult, float thr, float gate, float cx,
                                   float cy, float cz, float r2, void* pos_out,
                                   void* stream) {
  const int block = 256;
  const int grid = psdf_blocks(B, block);
  if (grid == 0) return 0;
  PSDF_LAUNCH(trace_step_pos_kernel, grid, block, 0, stream, B, (long long)R,
              (const long long*)idx, (const float*)s, (const float*)dirs,
              (float*)pos, (uint8_t*)alive, (uint8_t*)conv, (float*)sdf,
              (const uint8_t*)field,
              grid_args(V, half_extent, tx, ty, tz, voxel_size, cap), mult,
              thr, gate, cx, cy, cz, r2, (float*)pos_out);
  return (int)cudaGetLastError();
}
