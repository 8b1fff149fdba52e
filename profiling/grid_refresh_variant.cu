// Kernel If (occupancy_grid.cu) in the shapes the port measured against its
// own (8 warps a tile of 32 probes, one block a tile), for measurement
// only: 4 or 8 warps a tile, and blocks_per_sm persistent blocks a
// streaming multiprocessor (0: as many as fit), each staging the weights
// once and striding over the tiles, or one block a tile (< 0). The
// evaluation and the stores are the port's, so every shape writes the
// port's grid bit for bit. Built and timed by
// profiling/grid_refresh_designs.py and run by the CPU tests; no path of
// the port calls it.
#include "occupancy_grid.cu"

template <int kWarps>
static int launch_design(int n, unsigned int update_idx, int V, float voxel_size,
                         float half_extent, float tx, float ty, float tz, const void* jitter,
                         const SdfNet* net, float inv_s, float half_diag, float thresh,
                         void* values, void* occupancy, int blocks_per_sm, void* stream) {
  int grid = 0;  // one block a tile
  if (blocks_per_sm >= 0 && net != nullptr) {
    int dev = 0, sms = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == 0 && blocks_per_sm == 0) {
      const size_t smem = net_smem_bytes(2 * net->K + 3);
      if (smem > 48 * 1024)
        err = (int)cudaFuncSetAttribute(grid_refresh_kernel<kWarps>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == 0)
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks_per_sm, grid_refresh_kernel<kWarps>, kWarps * 32, smem);
    }
    if (err != 0) return err;
    grid = max(sms * blocks_per_sm, 1);
  }
  return launch_grid_refresh<kWarps>(n, update_idx, V, voxel_size, half_extent, tx, ty, tz,
                                     jitter, net, inv_s, half_diag, thresh, values, occupancy,
                                     grid, stream);
}

extern "C" int psdf_grid_refresh_design(int n, unsigned int update_idx, int V, float voxel_size,
                                        float half_extent, float tx, float ty, float tz,
                                        const void* jitter, const SdfNet* net, float inv_s,
                                        float half_diag, float thresh, void* values,
                                        void* occupancy, int warps, int blocks_per_sm,
                                        void* stream) {
  if (warps == 4)
    return launch_design<4>(n, update_idx, V, voxel_size, half_extent, tx, ty, tz, jitter, net,
                            inv_s, half_diag, thresh, values, occupancy, blocks_per_sm, stream);
  if (warps == 8)
    return launch_design<8>(n, update_idx, V, voxel_size, half_extent, tx, ty, tz, jitter, net,
                            inv_s, half_diag, thresh, values, occupancy, blocks_per_sm, stream);
  return (int)cudaErrorInvalidValue;
}
