// Kernels L, D2, D2' and D' (volume_rendering.cu) launched at a given number
// of rays a block, for measurement only: the port launches LOD_RAYS (L, D2,
// D2') and WEIGHTS_BWD_RAYS (D'); these entry points launch the same kernels
// at 1, 2 or 4 rays a block (a warp each), so every shape gives the port's
// outputs bit for bit. Built and
// timed by profiling/lod_kernels.py; no path of the port calls them.
#include "volume_rendering.cu"

extern "C" int psdf_train_lod_select_rays(int rays, int R, int S, int K, int E,
                                          const void* sdf, const void* dt,
                                          const void* mask, const void* scores,
                                          float inv_s, float cos_anneal_ratio,
                                          void* cos_fd, void* sel,
                                          void* stream) {
  return launch_train_lod_select(rays, R, S, K, E, sdf, dt, mask, scores,
                                 inv_s, cos_anneal_ratio, cos_fd, sel, stream);
}

extern "C" int psdf_render_mixed_rays(
    int rays, int R, int S, int KE, const void* sdf_carried,
    const void* cos_fd, const void* sel, const void* sdf_c,
    const void* grads_c, const void* rgb_c, const void* dirs, const void* dt,
    const void* mask, float inv_s, float cos_anneal_ratio, void* weights,
    void* weights_sum, void* bg_T, void* rgb_int, void* grad_int,
    void* stream) {
  return launch_render_mixed(rays, R, S, KE, sdf_carried, cos_fd, sel, sdf_c,
                             grads_c, rgb_c, dirs, dt, mask, inv_s,
                             cos_anneal_ratio, weights, weights_sum, bg_T,
                             rgb_int, grad_int, stream);
}

extern "C" int psdf_render_mixed_bwd_rays(
    int rays, int R, int S, int KE, const void* sdf_carried,
    const void* cos_fd, const void* sel, const void* sdf_c,
    const void* grads_c, const void* rgb_c, const void* dirs, const void* dt,
    const void* mask, float inv_s, float cos_anneal_ratio,
    const void* g_weights, const void* g_wsum, const void* g_bgT,
    const void* g_rgb, const void* g_grad, void* d_sdf_c, void* d_grads_c,
    void* d_rgb_c, void* stream) {
  return launch_render_mixed_bwd(rays, R, S, KE, sdf_carried, cos_fd, sel,
                                 sdf_c, grads_c, rgb_c, dirs, dt, mask, inv_s,
                                 cos_anneal_ratio, g_weights, g_wsum, g_bgT,
                                 g_rgb, g_grad, d_sdf_c, d_grads_c, d_rgb_c,
                                 stream);
}

extern "C" int psdf_render_weights_bwd_rays(
    int rays, int mode, int R, int S, const void* val, const void* grads,
    const void* dirs, const void* dt, const void* mask, const void* rgb,
    float inv_s, float cos_anneal_ratio, const void* g_weights,
    const void* g_wsum, const void* g_bgT, const void* g_rgb,
    const void* g_grad, void* d_val, void* d_grads, void* d_rgb,
    void* stream) {
  return launch_render_weights_bwd(rays, mode, R, S, val, grads, dirs, dt,
                                   mask, rgb, inv_s, cos_anneal_ratio,
                                   g_weights, g_wsum, g_bgT, g_rgb, g_grad,
                                   d_val, d_grads, d_rgb, stream);
}
