#pragma once
// CPU stand-in for the CUDA runtime subset that the port's kernels use
// (permuto_sdf_tpu_torch/kernels/csrc), so `g++ -std=c++20` can compile
// the .cu sources and run them on the CPU in tests: each block runs its
// threads as std::threads, atomicAdd, atomicCAS and atomicMin (32 or 64
// bits) go through std::atomic_ref, __ldcg is an atomic load and
// __threadfence a sequentially consistent fence, the warp
// shuffles, ballots, __any_sync, __match_any_sync and __reduce_add_sync
// exchange values through a per-warp slot array between two barriers
// (__ffs is the compiler's builtin, __float_as_uint and __uint_as_float a memcpy; __fns, positive offsets only, a loop
// over the bits), __syncthreads is a
// barrier of the block's threads, and PSDF_LAUNCH /
// psdf_dynamic_smem are redefined for that (a launch of thread-block
// clusters runs a cluster's blocks together: PSDF_LAUNCH_CLUSTER, the
// cluster barrier, whole or in halves, and another block's shared memory by
// rank, under the names psdf_cluster_* that the card's build of
// profiling/h0_variants.cu gives them) (float2 is a plain pair, float4
// uint2 and uint4 two and four plain words, so a vector load is a struct copy; cp.async
// is a synchronous memcpy; cudaFuncSetAttribute accepts any shared-memory
// size; the device reports 2 streaming multiprocessors that hold one block
// each; the tensor cores' TF32 product psdf_mma_tf32 gathers the warp's
// fragments and adds each output's eight exact products to it in double,
// rounded once to float: the card's accumulation order and rounding are
// its own, so a kernel that uses it agrees with the card within float
// rounding, not bit for bit). It checks the
// kernels' logic, not their speed or the GPU's own float rounding.
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <optional>
#include <thread>
#include <vector>
using std::min; using std::max;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
// A small card: 2 streaming multiprocessors, one block each, so a
// persistent kernel's blocks stride over several tiles.
inline int cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return cudaSuccess; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline const char* cudaGetErrorString(int) { return "emulated"; }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__
struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local emu_dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local unsigned char* emu_smem;
struct EmuWarp { std::unique_ptr<std::barrier<>> bar; uint64_t slot[32]; float mma[32][10]; };
inline thread_local EmuWarp* emu_warp;
inline thread_local std::barrier<>* emu_block_bar;
inline int emu_lane() { return threadIdx.x & 31; }
template <class T> T emu_exchange(T v, int src) {
  uint64_t bits = 0; std::memcpy(&bits, &v, sizeof(T));
  emu_warp->slot[emu_lane()] = bits; emu_warp->bar->arrive_and_wait();
  uint64_t r = emu_warp->slot[src]; emu_warp->bar->arrive_and_wait();
  T out; std::memcpy(&out, &r, sizeof(T)); return out;
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) { int l = emu_lane(); return emu_exchange(v, l >= d ? l - d : l); }
template <class T> T __shfl_down_sync(unsigned, T v, int d) { int l = emu_lane(); return emu_exchange(v, l + d < 32 ? l + d : l); }
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src); }
template <class T> T __shfl_xor_sync(unsigned, T v, int m) { return emu_exchange(v, emu_lane() ^ m); }
inline unsigned __ballot_sync(unsigned, bool p) {
  emu_warp->slot[emu_lane()] = p; emu_warp->bar->arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) if (emu_warp->slot[i]) r |= 1u << i;
  emu_warp->bar->arrive_and_wait(); return r;
}
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0u; }
inline unsigned __match_any_sync(unsigned, unsigned v) {
  emu_warp->slot[emu_lane()] = v; emu_warp->bar->arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) if ((unsigned)emu_warp->slot[i] == v) r |= 1u << i;
  emu_warp->bar->arrive_and_wait(); return r;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// __fns for a positive offset: the offset-th set bit at or above base
// (0xffffffff if there is none), as kernel C uses it
inline unsigned __fns(unsigned mask, unsigned base, int offset) {
  for (unsigned i = base; i < 32; ++i)
    if ((mask >> i & 1u) && --offset == 0) return i;
  return 0xffffffffu;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  emu_warp->slot[emu_lane()] = v; emu_warp->bar->arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) r += (unsigned)emu_warp->slot[i];
  emu_warp->bar->arrive_and_wait(); return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
inline void __syncwarp() { emu_warp->bar->arrive_and_wait(); }
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
template <class T> T atomicCAS(T* p, T cmp, T v) {
  std::atomic_ref<T>(*p).compare_exchange_strong(cmp, v); return cmp;
}
template <class T> T atomicMin(T* p, T v) {
  std::atomic_ref<T> a(*p); T old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T> T __ldcg(const T* p) { return std::atomic_ref<T>(*const_cast<T*>(p)).load(); }
// A launch runs the blocks of one cluster at a time, all their threads at
// once (a plain launch: clusters of one block). Each block has its own
// shared memory, warps and block barrier; the cluster has one barrier of
// all its threads (psdf_cluster_sync) and the list of its blocks' shared
// memory (psdf_cluster_map).
struct EmuCluster { std::unique_ptr<std::barrier<>> bar; std::vector<unsigned char*> smem; };
inline thread_local EmuCluster* emu_cluster;
inline thread_local unsigned emu_cluster_rank;
template <class F> void emu_launch_cluster(int grid, int block, int cluster, size_t smem, F&& body) {
  for (int c0 = 0; c0 < grid; c0 += cluster) {
    const int nb = std::min(cluster, grid - c0);
    std::vector<std::vector<unsigned char>> sm(nb, std::vector<unsigned char>(smem + 16));
    int nw = (block + 31) / 32;
    std::vector<std::vector<EmuWarp>> warps(nb);
    std::vector<std::unique_ptr<std::barrier<>>> block_bars;
    EmuCluster cl;
    cl.bar = std::make_unique<std::barrier<>>(nb * block);
    for (int r = 0; r < nb; ++r) {
      warps[r] = std::vector<EmuWarp>(nw);
      for (auto& w : warps[r]) w.bar = std::make_unique<std::barrier<>>(32);
      block_bars.push_back(std::make_unique<std::barrier<>>(block));
      cl.smem.push_back(sm[r].data());
    }
    std::vector<std::thread> ts;
    for (int r = 0; r < nb; ++r)
      for (int t = 0; t < block; ++t)
        ts.emplace_back([&, r, t] {
          threadIdx.x = t; blockIdx.x = c0 + r; blockDim.x = block; gridDim.x = grid;
          emu_smem = sm[r].data(); emu_warp = &warps[r][t / 32];
          emu_block_bar = block_bars[r].get(); emu_cluster = &cl; emu_cluster_rank = r;
          body();
          // a thread that returns early leaves the block's and the
          // cluster's later barriers
          emu_block_bar->arrive_and_drop();
          cl.bar->arrive_and_drop();
        });
    for (auto& th : ts) th.join();
  }
}
template <class F> void emu_launch(int grid, int block, size_t smem, F&& body) {
  emu_launch_cluster(grid, block, 1, smem, body);
}
#define PSDF_CLUSTER
inline unsigned psdf_cluster_rank() { return emu_cluster_rank; }
inline unsigned psdf_cluster_blocks() { return (unsigned)emu_cluster->smem.size(); }
inline thread_local std::optional<std::barrier<>::arrival_token> emu_cluster_token;
inline void psdf_cluster_arrive() { emu_cluster_token.emplace(emu_cluster->bar->arrive()); }
inline void psdf_cluster_wait() {
  emu_cluster->bar->wait(std::move(*emu_cluster_token));
  emu_cluster_token.reset();
}
inline void psdf_cluster_sync() { emu_cluster->bar->arrive_and_wait(); }
template <class T> T* psdf_cluster_map(T* p, unsigned rank) {
  return reinterpret_cast<T*>(emu_cluster->smem[rank] +
                              (reinterpret_cast<unsigned char*>(p) - emu_smem));
}
#define PSDF_LAUNCH_CLUSTER(kernel, grid, block, cluster, smem, stream, ...) \
  (emu_launch_cluster((grid), (block), (cluster), (smem), [&] { kernel(__VA_ARGS__); }), 0)
#define PSDF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  emu_launch((grid), (block), (smem), [&] { kernel(__VA_ARGS__); })
#define PSDF_DYNAMIC_SMEM
template <typename T> T* psdf_dynamic_smem() { return reinterpret_cast<T*>(emu_smem); }
#define PSDF_CP_ASYNC
inline void psdf_cp_async16(void* s, const void* g) { std::memcpy(s, g, 16); }
inline void psdf_cp_async4(void* s, const void* g) { std::memcpy(s, g, 4); }
inline void psdf_cp_async_wait() {}
#define PSDF_MMA
// cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10 mantissa
// bits (a NaN stays a NaN)
inline uint32_t psdf_tf32(float x) {
  uint32_t u; std::memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) == 0x7f800000u) return (u & 0x007fffffu) ? 0x7fffffffu : u;
  return (u + 0x1000u) & 0xffffe000u;
}
inline void psdf_mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int l = emu_lane();
  float* mine = emu_warp->mma[l];
  for (int i = 0; i < 4; ++i) std::memcpy(&mine[i], &a[i], 4);
  for (int i = 0; i < 2; ++i) std::memcpy(&mine[4 + i], &b[i], 4);
  emu_warp->bar->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), c = 2 * t + (i & 1);
    double acc = d[i];
    for (int k = 0; k < 8; ++k) {
      const float av = emu_warp->mma[(r % 8) * 4 + k % 4][(r >= 8) + 2 * (k >= 4)];
      const float bv = emu_warp->mma[c * 4 + k % 4][4 + (k >= 4)];
      acc += (double)av * (double)bv;
    }
    out[i] = (float)acc;
  }
  emu_warp->bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

