// Kernel J0: the Chebyshev empty-space distance field of the occupancy grid.
// Kernel J1: the jump-only prepass of the sphere tracer.
// Kernel J2: one trace iteration of a bucket of rays, after its SDF values.
// Kernel J3: one trace iteration of the plain tracers, on position state.
// Kernels J3f and J2f: J3's loop (all its iterations) and one round of J2's
// (its iterations and counts) with the flagship SDF evaluated inside the
// launch.
//
// Replaces: permuto_sdf_tpu/ops/occupancy_grid.py:315
// `chebyshev_empty_distance` (J0), permuto_sdf_tpu/ops/sphere_trace.py:394
// `_jump_prepass_impl` (J1), the body of one iteration of :308
// `_trace_rounds_impl` after the SDF evaluation, lines 337-375 (J2), and
// the body of `sphere_trace`'s loop after its SDF evaluation, :88-113, which
// is also the inner iteration of `sphere_trace_compacted`, :225-253 (J3).
// J3f replaces the whole loop of :88-113 (and one round of :225-253) with
// its SDF evaluations (models/fields.py:113 `sdf_apply`), J2f one round of
// `_trace_rounds_impl` (:308) with its SDF evaluations. The JAX package
// leaves them to XLA.
//
// What bounds them on an H100: bytes and memory latency. J0 reads the
// 16.8 MB bool grid and writes the 16.8 MB uint8 field (three passes move
// about 100 MB, all of it in or near the 50 MB L2); a linear-time method
// does ~10 integer operations per voxel and pass whatever the field's
// values. J1 and J2 read and write a few bytes of state per ray (origin,
// direction, t, t_exit, the flags) and gather one byte of the field per
// jump, at positions that follow the ray: scattered one-byte reads of a
// field that stays in L2.
//
// Design of J0: the JAX op takes `max_dist` sweeps of a 3x3x3 min-pool
// (d = min(d, minpool(d) + 1), voxels outside the grid ignored). The same
// integers come from three separable 1-D passes (z, y, x), each
// out[a] = min over a' of max(|a - a'|, in[a']), starting from 0 on an
// occupied voxel and `cap` on an empty one: the L-inf distance to the
// nearest occupied voxel, capped. One thread per line, 32 lines a block,
// staged in shared memory in 16-byte vectors with neighbouring threads on
// neighbouring bytes of the grid (the z pass copies its lines' contiguous
// bytes; the y and x passes copy rows of 32 neighbouring lines). Each line
// is one forward and one backward scan in constant work per voxel
// (`chebyshev_step`: the best value moves by at most one per voxel unless
// the voxel's own value is smaller, and a table of each value's latest
// position says when it steps up), the two scans interleaved in one loop.
// The field is uint8 (values 0..cap, cap <= 255): a 256^3 field is 16.8 MB
// and stays in L2 while J1 and J2 gather from it. It replaced a design with
// each voxel scanning outward until the offset reached its best value (up
// to 2 cap shared reads a voxel and pass on empty space), the z pass's
// loads 32 sectors a warp: 1.48 device ms on a 256^3 shell and 1.74 on an
// empty grid at cap 63, against ~0.22 for the scans on every grid (NVIDIA
// H100 80GB HBM3, 700 W; profiling/torch_encode_paths.py --paths grid).
// Staging alone (the scans removed) took 0.077 of that; a Meijster-style
// deque of candidates per line (a ring of cap + 1 entries), with the same
// staging, 0.46-0.81 (neither variant is kept).
//
// Design of J1 and J2: one thread per ray. A jump reads the field at
// o + t d (one byte) and advances t by max(k - 1, 0) voxels; a jump of 0
// leaves t as it is, so the remaining jumps of that ray are skipped (they
// would read the same voxel). J1's time is its longest chain of dependent
// lookups (up to `jumps` round trips to L2 or HBM, one after another), not
// its bytes. J1 also lists round 0's bucket (the alive rows below R in
// ascending order, the fill R behind them: nonzero_static's output for any
// bucket at or above the count): its first launch writes each tile's alive
// count, and a second launch (H0's second pass on those counts) writes the
// list and the count, in place of round 0's mask ops and H0's two
// launches. Measured against it on the H100 (profiling/j1_designs.py,
// PERF.md PR 16), and not kept: the field's loads under an L2 evict_last
// policy (J1 0.6 us faster in the frame, A 2 us slower), the rows' state
// staged in shared memory, 128 or 512 rows a block, and one launch whose
// list takes a decoupled look-back over the tiles' counts (3-6 us slower
// than the two launches). J2 gathers its bucket's state through `idx`,
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
//
// What bounds J3 and J2 on their paths is not their bodies: each launch is
// at the card's launch floor (~1 us), wedged between SDF evaluations of a
// dozen launches each (A, a cat of W0's rows, four matmuls, biases, GELUs),
// all of them on the host's clock. J3f and J2f run the loop in one launch.
// Their own work is the SDF (sdf_net.cuh, shared with the grid refresh's
// kernel If): per evaluation K levels of A's lattice math and 4 gathers of
// 8 bytes, and the MLP's ~7.4 kFLOP. Design of J3f and J2f: a block of 8
// warps takes a tile of 32 rays (lane = ray) and keeps their state in
// registers for all the iterations; it stages the MLP's weights in shared
// memory once (W0's 2K + 3 rows, W1, W2, the biases and W3's column 0:
// ~15 KB), and the warps split each evaluation (sdf_at, 4 hidden units a
// warp); every warp repeats the update on the same values, so the warps
// take the same branches and stop together. A tile whose rays are all
// inactive (dead or converged) stops: an inactive row is a fixed point of
// both updates. Of the designs with 1 warp a tile (a lane's levels and 32
// hidden units in registers) and with 4, only 4 was faster, on J2f's round
// 0 alone (PERF.md); profiling/trace_fused_variant.cu keeps both
// measurable.
#include "sdf_net.cuh"

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

constexpr int kJumpRows = 256;  // J1's rows a block: a tile of round 0's list

constexpr int kLines = 32;  // lines of one J0 pass per block, one per thread

// J0's line stride in shared memory when the lines are staged line by line:
// at least V bytes and 4 mod 8, so the 32 lines' bytes at one offset fall
// in 32 distinct banks.
__host__ __device__ __forceinline__ int chebyshev_row_bytes(int V) {
  return ((V + 7) & ~7) + 4;
}

// One step of a J0 scan at scan index k with value v: the best m over the
// positions so far is v where v does not exceed the previous m; otherwise
// it stays m while the latest position p with a value <= m lies within m
// of k, and then becomes m + 1, p the later of p and the latest position
// whose value is m + 1. `last`, indexed by value (every value is <= cap),
// holds each value's latest scan index; p never decreases, so an entry
// never written (0, as zeroed) never wins. Without branches, so the two
// scans of a line interleave (with branches, or with the store and the load
// made conditional, the sphere scene's shell took 0.238-0.254 device ms at
// 256^3 against 0.217).
__device__ __forceinline__ void chebyshev_step(int k, int v, int cap, int& m, int& p,
                                               uint16_t* __restrict__ last) {
  last[v * kLines] = (uint16_t)k;
  const int next = last[min(m + 1, cap) * kLines];  // after the store
  const bool reset = v <= m;
  const bool up = !reset && k - p > m;
  p = reset ? k : (up ? max(p, next) : p);
  m = reset ? v : m + (int)up;
}

// J0, the 1-D pass of one line in shared memory (element a at a * es):
// out[a] = min over a' of max(|a - a'|, in[a']), the smaller of a forward
// scan (a' <= a) and a backward scan (a' >= a), in constant work per voxel.
// The two scans run in one loop, two independent chains: in its first half
// each writes its own positions, in the second half each takes the minimum
// with what the other scan wrote there.
__device__ __forceinline__ void chebyshev_line(const uint8_t* __restrict__ in,
                                               uint8_t* __restrict__ out, int V,
                                               int es, int cap,
                                               uint16_t* __restrict__ last_f,
                                               uint16_t* __restrict__ last_b) {
  int mf = 255, pf = 0, mb = 255, pb = 0;  // >= any value: the first step resets
#pragma unroll 2
  for (int k = 0; k < V; ++k) {
    const int af = k * es, ab = (V - 1 - k) * es;
    chebyshev_step(k, in[af], cap, mf, pf, last_f);
    chebyshev_step(k, in[ab], cap, mb, pb, last_b);
    if (2 * k < V - 1) {
      out[af] = (uint8_t)mf;
      out[ab] = (uint8_t)mb;
    } else if (2 * k == V - 1) {
      out[af] = (uint8_t)min(mf, mb);
    } else {
      out[af] = (uint8_t)min((int)out[af], mf);
      out[ab] = (uint8_t)min((int)out[ab], mb);
    }
  }
}

// Four bytes of the bool grid as the first pass's input: 0 where occupied,
// cap where empty.
__device__ __forceinline__ uint32_t chebyshev_start4(uint32_t w, uint32_t cap) {
  uint32_t m = 0;
  for (int b = 0; b < 4; ++b) m |= ((w >> (8 * b) & 255u) ? 0u : cap) << (8 * b);
  return m;
}

// J0, one pass along one axis. Line l = (u, w) starts at u * su + w * sw and
// its voxels are `es` apart; with es == 1 (the z pass) line l starts at l V.
// With `from_occupancy`, `in` is the bool grid and the pass starts from 0
// (occupied) / cap (empty). The block stages its 32 lines in shared memory
// with neighbouring threads on neighbouring bytes of the grid, in 16-byte
// vectors where V allows: the z pass copies its lines' contiguous bytes
// line by line (tile [32][row bytes]); the y and x passes copy rows of the
// tile [V][32], each row the 32 lines' neighbouring voxels at one offset.
__global__ void __launch_bounds__(kLines) chebyshev_pass_kernel(
    int V, long long su, long long sw, long long es, int from_occupancy,
    int cap, const uint8_t* __restrict__ in, uint8_t* __restrict__ out) {
  const int t = threadIdx.x;
  const bool z_pass = es == 1;
  const int rb = chebyshev_row_bytes(V);
  const int tile = z_pass ? kLines * rb : V * kLines;
  const long long nl = (long long)V * V;
  const long long l0 = (long long)blockIdx.x * kLines;
  const int nlines = (int)min((long long)kLines, nl - l0);
  uint8_t* fin = psdf_dynamic_smem<uint8_t>();
  uint8_t* fout = fin + tile;
  // the scans' latest index per value, forward then backward: [2][cap + 1][kLines]
  uint16_t* last = reinterpret_cast<uint16_t*>(fout + tile);
  for (int i = t; i < 2 * (cap + 1) * kLines; i += kLines) last[i] = 0;
  // 16-byte vectors: the z pass's lines back to back (su = V^2, sw = V), or
  // the other passes' 32 lines neighbours in one plane (sw = 1, V % 32 == 0)
  const bool vec = z_pass ? V % 16 == 0 && su == nl && sw == V
                          : V % kLines == 0 && sw == 1;
  if (z_pass && vec) {
    const int per_line = V / 16;
    const uint4* src = reinterpret_cast<const uint4*>(in + l0 * V);
    for (int c = t; c < nlines * per_line; c += kLines) {
      const uint4 q = src[c];
      uint32_t w[4] = {q.x, q.y, q.z, q.w};
      uint32_t* dst = reinterpret_cast<uint32_t*>(fin + (c / per_line) * rb + (c % per_line) * 16);
      for (int j = 0; j < 4; ++j) dst[j] = from_occupancy ? chebyshev_start4(w[j], cap) : w[j];
    }
  } else if (vec) {
    const long long row0 = (l0 / V) * su + (l0 % V) * sw;
    for (int c = t; c < V * 2; c += kLines) {  // two 16-byte halves per row
      uint4 q = *reinterpret_cast<const uint4*>(in + row0 + (c >> 1) * es + (c & 1) * 16);
      if (from_occupancy) {
        q.x = chebyshev_start4(q.x, cap), q.y = chebyshev_start4(q.y, cap);
        q.z = chebyshev_start4(q.z, cap), q.w = chebyshev_start4(q.w, cap);
      }
      *reinterpret_cast<uint4*>(fin + c * 16) = q;
    }
  } else {
    for (int i = t; i < nlines * V; i += kLines) {
      const int line = z_pass ? i / V : i % nlines;
      const int a = z_pass ? i % V : i / nlines;
      const long long l = l0 + line;
      const uint8_t v = in[(l / V) * su + (l % V) * sw + a * es];
      fin[z_pass ? line * rb + a : a * kLines + line] = from_occupancy ? (v ? 0 : cap) : v;
    }
  }
  __syncthreads();
  if (t < nlines) {
    const int off = z_pass ? t * rb : t;
    chebyshev_line(fin + off, fout + off, V, z_pass ? 1 : kLines, cap, last + t,
                   last + (cap + 1) * kLines + t);
  }
  __syncthreads();
  if (z_pass && vec) {
    const int per_line = V / 16;
    uint4* dst = reinterpret_cast<uint4*>(out + l0 * V);
    for (int c = t; c < nlines * per_line; c += kLines) {
      const uint32_t* w =
          reinterpret_cast<const uint32_t*>(fout + (c / per_line) * rb + (c % per_line) * 16);
      uint4 q;
      q.x = w[0], q.y = w[1], q.z = w[2], q.w = w[3];
      dst[c] = q;
    }
  } else if (vec) {
    const long long row0 = (l0 / V) * su + (l0 % V) * sw;
    for (int c = t; c < V * 2; c += kLines)
      *reinterpret_cast<uint4*>(out + row0 + (c >> 1) * es + (c & 1) * 16) =
          *reinterpret_cast<const uint4*>(fout + c * 16);
  } else {
    for (int i = t; i < nlines * V; i += kLines) {
      const int line = z_pass ? i / V : i % nlines;
      const int a = z_pass ? i % V : i / nlines;
      const long long l = l0 + line;
      out[(l / V) * su + (l % V) * sw + a * es] = fout[z_pass ? line * rb + a : a * kLines + line];
    }
  }
}

// The sums of a and b over a block of kRows threads, in place in every
// thread; `red` holds 2 kRows / 32 ints of shared memory.
template <int kRows>
__device__ __forceinline__ void block_sum2(int& a, int& b, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(PSDF_FULL_MASK, a, off);
    b += __shfl_xor_sync(PSDF_FULL_MASK, b, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[kRows / 32 + warp] = b;
  }
  __syncthreads();
  a = b = 0;
  for (int w = 0; w < kRows / 32; ++w) {
    a += red[w];
    b += red[kRows / 32 + w];
  }
}

// J1's tile count: the number of the block's rows with `in_list` into
// tile_counts[tile]; the block's shared memory starts with 2 kRows / 32
// ints for it.
template <int kRows>
__device__ __forceinline__ void prepass_tile_count(bool in_list, int* __restrict__ tile_counts) {
  const unsigned ball = __ballot_sync(PSDF_FULL_MASK, in_list);
  int n = (threadIdx.x & 31) == 0 ? __popc(ball) : 0, unused = 0;
  block_sum2<kRows>(n, unused, psdf_dynamic_smem<int>());
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = n;
}

// J1, first launch: `jumps` chained jumps on every alive row (a thread a
// row), then alive &= t <= t_exit; each block (a tile of kRows rows) writes
// the number of its alive rows below R to tile_counts[tile].
template <int kRows>
__global__ void __launch_bounds__(kRows) jump_prepass_kernel(
    int n_rows, int R, const uint8_t* __restrict__ field, GridArgs g,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_exit, float* __restrict__ t,
    uint8_t* __restrict__ alive, int jumps, int* __restrict__ tile_counts) {
  const long long r = (long long)blockIdx.x * kRows + threadIdx.x;
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
  prepass_tile_count<kRows>(a && r < R, tile_counts);
}

// J1, second launch: round 0's list from the flags and the tile counts of
// the first (the scan of H0's second pass): the alive rows below R in
// ascending order, then the fill R up to list_size, and their number. A
// block sums the counts of the tiles before its own and of all tiles, then
// writes each alive row at its rank and each dead row's fill at its rank
// among the dead rows counted from the back, so every slot below R is
// written once.
template <int kRows>
__global__ void __launch_bounds__(kRows) jump_prepass_list_kernel(
    int R, int list_size, const uint8_t* __restrict__ alive,
    const int* __restrict__ tile_counts, int n_tiles, int* __restrict__ count,
    long long* __restrict__ list) {
  int* red = psdf_dynamic_smem<int>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int before = 0, total = 0;
  for (int j = tid; j < n_tiles; j += kRows) {
    const int c = tile_counts[j];
    total += c;
    before += j < (int)blockIdx.x ? c : 0;
  }
  block_sum2<kRows>(before, total, red);
  const long long r = (long long)blockIdx.x * kRows + tid;
  const bool in_list = r < R && alive[r] != 0;
  const unsigned ball = __ballot_sync(PSDF_FULL_MASK, in_list);
  __syncthreads();  // `red` is reused below
  if (lane == 0) red[warp] = __popc(ball);
  __syncthreads();
  int rank = __popc(ball & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += red[w];
  if (r < R) {
    const long long alive_before = before + rank;  // alive rows below r
    list[in_list ? alive_before : R - 1 - (r - alive_before)] = in_list ? r : R;
  } else if (r < list_size) {
    list[r] = R;
  }
  if (blockIdx.x == 0 && tid == 0) *count = total;
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

// ---------------------------------------------------------------------------
// Kernels J3f and J2f: the trace loops with the SDF evaluated in the launch
// ---------------------------------------------------------------------------

constexpr int kTraceWarps = 8;  // a block's warps, which share one tile of 32 rays

// Kernel J3f: `iters` iterations of J3 on slot j's row r = idx[j] (or j
// without idx; fill slots, r >= R, do nothing), the SDF evaluated in the
// launch: a block of kTraceWarps warps takes 32 slots (lane = slot), the
// row's state stays in registers, and the block stops once none of its
// rows is active (an inactive row is a fixed point of J3's update; every
// warp votes on the same flags, so the warps stop together). Warp 0 writes
// the state back, and with sdf_f the last sdf of an active row.
__global__ void __launch_bounds__(kTraceWarps * 32) trace_loop_pos_kernel(
    int B, long long R, const long long* __restrict__ idx, SdfNet net, int n_in,
    const float* __restrict__ dirs, float* __restrict__ pos_f, uint8_t* __restrict__ alive_f,
    uint8_t* __restrict__ conv_f, float* __restrict__ sdf_f, const uint8_t* __restrict__ field,
    GridArgs g, int iters, float mult, float thr, float gate, float cx, float cy, float cz,
    float r2) {
  float* sw = psdf_dynamic_smem<float>();
  stage_net(net, n_in, sw);
  float* xt = sw + net_floats(n_in);
  const long long j = (long long)blockIdx.x * 32 + (threadIdx.x & 31);
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
    if (!__any_sync(PSDF_FULL_MASK, active)) break;  // the same vote in every warp
    const float s = sdf_at<kTraceWarps>(net, n_in, sw, xt, p, active);
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
  if (real && threadIdx.x < 32) {
    for (int c = 0; c < 3; ++c) pos_f[r * 3 + c] = p[c];
    alive_f[r] = alive ? 1 : 0;
    conv_f[r] = conv ? 1 : 0;
    if (sdf_f != nullptr) sdf_f[r] = sdf;
  }
}

// Kernel J2f: one round of the adaptive tracer on bucket slot j's ray r =
// idx[j] (fill slots, r >= R, do nothing): `iters` times the position o +
// t d, the SDF there and J2's update (the step, the convergence test,
// `substeps` chained jumps gated on s > gate, death past t_exit), the state
// in registers; a block of 32 slots as in J3f, stopping once none of its
// rays is active. Then the round's counts: still active, and converged and
// alive.
__global__ void __launch_bounds__(kTraceWarps * 32) trace_round_kernel(
    int B, long long R, const long long* __restrict__ idx, SdfNet net, int n_in,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_exit, float* __restrict__ t_f, uint8_t* __restrict__ alive_f,
    uint8_t* __restrict__ conv_f, float* __restrict__ sdf_f, const uint8_t* __restrict__ field,
    GridArgs g, int iters, float mult, float thr, float gate, int substeps,
    int* __restrict__ counts) {
  float* sw = psdf_dynamic_smem<float>();
  stage_net(net, n_in, sw);
  float* xt = sw + net_floats(n_in);
  const long long j = (long long)blockIdx.x * 32 + (threadIdx.x & 31);
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
    const float s = sdf_at<kTraceWarps>(net, n_in, sw, xt, p, active);
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
  if (threadIdx.x >= 32) return;
  if (real) {
    t_f[r] = t;
    alive_f[r] = alive ? 1 : 0;
    conv_f[r] = conv ? 1 : 0;
    sdf_f[r] = sdf;
  }
  if (counts != nullptr) {
    const unsigned na = __ballot_sync(PSDF_FULL_MASK, active);
    const unsigned nh = __ballot_sync(PSDF_FULL_MASK, alive && conv);
    if (threadIdx.x == 0) {
      if (na != 0) atomicAdd(&counts[0], __popc(na));
      if (nh != 0) atomicAdd(&counts[1], __popc(nh));
    }
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
  if (V <= 0 || V >= (1 << 16) || cap < 0 || cap > 255) return (int)cudaErrorInvalidValue;
  const long long vv = (long long)V * V;
  const int grid = psdf_blocks(vv, kLines);
  // the z pass's tile [32][row bytes] is the larger of the two layouts
  const size_t smem = (size_t)2 * kLines * chebyshev_row_bytes(V) +
                      (size_t)2 * (cap + 1) * kLines * sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        chebyshev_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
  }
  // z (stride 1), then y (stride V), then x (stride V^2)
  PSDF_LAUNCH(chebyshev_pass_kernel, grid, kLines, smem, stream, V, vv,
              (long long)V, 1ll, 1, cap, (const uint8_t*)occupancy,
              (uint8_t*)field);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  PSDF_LAUNCH(chebyshev_pass_kernel, grid, kLines, smem, stream, V, vv, 1ll,
              (long long)V, 0, cap, (const uint8_t*)field, (uint8_t*)scratch);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  PSDF_LAUNCH(chebyshev_pass_kernel, grid, kLines, smem, stream, V,
              (long long)V, 1ll, vv, 0, cap, (const uint8_t*)scratch,
              (uint8_t*)field);
  return (int)cudaGetLastError();
}

// J1's two launches: the jumps (kernel `jump` at kRows rows a block; the
// port's is jump_prepass_kernel<kJumpRows>, profiling/j1_variants.cu
// launches other forms), then round 0's list.
template <int kRows, typename Jump>
static int launch_jump_prepass(Jump jump, int n_rows, int R, int list_size, const void* field,
                               const GridArgs& g, const void* origins, const void* dirs,
                               const void* t_exit, void* t, void* alive, int jumps,
                               void* count, void* list, void* tile_counts, void* stream) {
  const int n_tiles = psdf_blocks(n_rows, kRows);
  if (n_tiles == 0) return 0;
  const size_t red = sizeof(int) * 2 * (kRows / 32);
  PSDF_LAUNCH(jump, n_tiles, kRows, red, stream, n_rows, R, (const uint8_t*)field, g,
              (const float*)origins, (const float*)dirs, (const float*)t_exit, (float*)t,
              (uint8_t*)alive, jumps, (int*)tile_counts);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const auto write_list = jump_prepass_list_kernel<kRows>;
  PSDF_LAUNCH(write_list, psdf_blocks(max(n_rows, list_size), kRows), kRows, red, stream, R,
              list_size, (const uint8_t*)alive, (const int*)tile_counts, n_tiles, (int*)count,
              (long long*)list);
  return (int)cudaGetLastError();
}

extern "C" int psdf_jump_prepass(int n_rows, int R, int list_size, const void* field, int V,
                                 float half_extent, float tx, float ty, float tz,
                                 float voxel_size, int cap, const void* origins,
                                 const void* dirs, const void* t_exit, void* t, void* alive,
                                 int jumps, void* count, void* list, void* tile_counts,
                                 void* stream) {
  return launch_jump_prepass<kJumpRows>(
      jump_prepass_kernel<kJumpRows>, n_rows, R, list_size, field,
      grid_args(V, half_extent, tx, ty, tz, voxel_size, cap), origins, dirs, t_exit, t, alive,
      jumps, count, list, tile_counts, stream);
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

// Kernels J3f and J2f: the shared memory of a block (the staged weights and
// its ray tile), and the launch: a block of kTraceWarps warps per 32 slots.
// Their entry points take the SDF's tensors as a pointer to an SdfNet.
template <typename Kernel, typename... Args>
static int launch_trace(Kernel kernel, int B, int n_in, void* stream, Args... args) {
  const int grid = psdf_blocks(B, 32);
  if (grid == 0) return 0;
  const size_t smem = net_smem_bytes(n_in);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
    if (err != 0) return err;
  }
  PSDF_LAUNCH(kernel, grid, kTraceWarps * 32, smem, stream, args...);
  return (int)cudaGetLastError();
}

extern "C" int psdf_trace_loop_pos(int B, int R, const void* idx, const SdfNet* net_ptr,
                                   const void* dirs, void* pos, void* alive, void* conv, void* sdf,
                                   const void* field, int V, float half_extent, float tx,
                                   float ty, float tz, float voxel_size, int cap, int iters,
                                   float mult, float thr, float gate, float cx, float cy,
                                   float cz, float r2, void* stream) {
  if (net_ptr == nullptr || !net_ok(*net_ptr)) return (int)cudaErrorInvalidValue;
  const SdfNet net = *net_ptr;
  const int n_in = 2 * net.K + 3;
  const GridArgs g = grid_args(V, half_extent, tx, ty, tz, voxel_size, cap);
  return launch_trace(trace_loop_pos_kernel, B, n_in, stream, B, (long long)R,
                      (const long long*)idx, net, n_in, (const float*)dirs, (float*)pos,
                      (uint8_t*)alive, (uint8_t*)conv, (float*)sdf, (const uint8_t*)field, g,
                      iters, mult, thr, gate, cx, cy, cz, r2);
}

extern "C" int psdf_trace_round(int B, int R, const void* idx, const SdfNet* net_ptr,
                                const void* origins, const void* dirs, const void* t_exit,
                                void* t, void* alive, void* conv, void* sdf,
                                const void* field, int V, float half_extent, float tx,
                                float ty, float tz,
                                float voxel_size, int cap, int iters, float mult, float thr,
                                float gate, int substeps, void* counts, void* stream) {
  if (net_ptr == nullptr || !net_ok(*net_ptr)) return (int)cudaErrorInvalidValue;
  const SdfNet net = *net_ptr;
  const int n_in = 2 * net.K + 3;
  const GridArgs g = grid_args(V, half_extent, tx, ty, tz, voxel_size, cap);
  return launch_trace(trace_round_kernel, B, n_in, stream, B, (long long)R,
                      (const long long*)idx, net, n_in, (const float*)origins,
                      (const float*)dirs, (const float*)t_exit, (float*)t, (uint8_t*)alive,
                      (uint8_t*)conv, (float*)sdf, (const uint8_t*)field, g, iters, mult, thr,
                      gate, substeps, (int*)counts);
}
