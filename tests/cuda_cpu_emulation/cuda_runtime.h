#pragma once
// CPU stand-in for the CUDA runtime subset that the port's kernels use
// (permuto_sdf_tpu_torch/kernels/csrc), so `g++ -std=c++20` can compile
// the .cu sources and run them on the CPU in tests: each block runs its
// threads as std::threads, the warp shuffles and ballots exchange values
// through a per-warp slot array between two barriers, and PSDF_LAUNCH /
// psdf_dynamic_smem are redefined for that. It checks the kernels' logic,
// not their speed or the GPU's own float rounding.
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::min; using std::max;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(x)
#define __align__(x)
#define __shared__
struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local emu_dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local unsigned char* emu_smem;
struct EmuWarp { std::unique_ptr<std::barrier<>> bar; uint64_t slot[32]; };
inline thread_local EmuWarp* emu_warp;
inline int emu_lane() { return threadIdx.x & 31; }
template <class T> T emu_exchange(T v, int src) {
  uint64_t bits = 0; std::memcpy(&bits, &v, sizeof(T));
  emu_warp->slot[emu_lane()] = bits; emu_warp->bar->arrive_and_wait();
  uint64_t r = emu_warp->slot[src]; emu_warp->bar->arrive_and_wait();
  T out; std::memcpy(&out, &r, sizeof(T)); return out;
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) { int l = emu_lane(); return emu_exchange(v, l >= d ? l - d : l); }
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src); }
template <class T> T __shfl_xor_sync(unsigned, T v, int m) { return emu_exchange(v, emu_lane() ^ m); }
inline unsigned __ballot_sync(unsigned, bool p) {
  emu_warp->slot[emu_lane()] = p; emu_warp->bar->arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) if (emu_warp->slot[i]) r |= 1u << i;
  emu_warp->bar->arrive_and_wait(); return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncwarp() { emu_warp->bar->arrive_and_wait(); }
template <class T> T __ldg(const T* p) { return *p; }
template <class F> void emu_launch(int grid, int block, size_t smem, F&& body) {
  for (int b = 0; b < grid; ++b) {
    std::vector<unsigned char> sm(smem + 16);
    int nw = (block + 31) / 32;
    std::vector<EmuWarp> warps(nw);
    for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = block; gridDim.x = grid;
        emu_smem = sm.data(); emu_warp = &warps[t / 32]; body();
      });
    for (auto& th : ts) th.join();
  }
}
#define PSDF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  emu_launch((grid), (block), (smem), [&] { kernel(__VA_ARGS__); })
#define PSDF_DYNAMIC_SMEM
template <typename T> T* psdf_dynamic_smem() { return reinterpret_cast<T*>(emu_smem); }
