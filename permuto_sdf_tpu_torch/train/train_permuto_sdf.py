"""PermutoSDF: configuration, parameters and the exact volumetric eval render
(counterpart of ``permuto_sdf_tpu/train/train_permuto_sdf.py``).

Slice 1 of the port serves frames: :func:`render_image` renders a view
with the flagship model through ``run_net`` on the eval branch (no
sample budget, no train-time LOD, no hit-ray compaction, no jitter). The
training step, the other renderers and multi-device rendering come in
later slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from permuto_sdf_tpu_torch.convert import params_from_jax
from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
from permuto_sdf_tpu_torch.device import resolve_device
from permuto_sdf_tpu_torch.models.fields import (
    NerfHashConfig, RGBConfig, SDFConfig, init_nerf_hash, init_rgb, init_sdf,
    nerf_hash_apply, rgb_apply, sdf_apply, sdf_with_gradient,
)
from permuto_sdf_tpu_torch.ops import occupancy_grid as og
from permuto_sdf_tpu_torch.ops import volume_rendering as vr
from permuto_sdf_tpu_torch.ops.importance_sampling import importance_sampling_sdf_model
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
from permuto_sdf_tpu_torch.ops.ray_sampler import compute_samples_bg
from permuto_sdf_tpu_torch.train import checkpoint as ckpt

_TRAINING_SLICE = "training slice"


@dataclasses.dataclass(frozen=True)
class PermutoSDFTrainConfig:
    """The fields and defaults of the JAX ``PermutoSDFTrainConfig``. Knobs
    that only steer the TPU lowering or the training step are accepted and
    ignored by the eval render."""

    s_mult: float = 1.0
    lr: float = 1e-3
    nr_iter_sphere_fit: int = 4000
    forced_variance_finish_iter: int = 35000
    eikonal_weight: float = 0.04
    eikonal_weight_reduced: float = 0.01
    curvature_weight: float = 0.65
    lipshitz_weight: float = 3e-6
    mask_weight: float = 0.1
    offsurface_weight: float = 1e-4
    iter_start_reduce_curv: int = 50000
    lr_milestones: tuple = (100000, 150000, 180000, 190000)
    iter_finish_training: int = 200000
    forced_variance_finish: float = 0.8
    use_occupancy_grid: bool = True
    nr_samples_bg: int = 32
    min_dist_between_samples: float = 0.0001
    max_nr_samples_per_ray: int = 64
    nr_samples_imp_sampling: int = 16
    do_importance_sampling: bool = True
    imp_sampling_max_levels: Optional[int] = 12
    sdf_gradient_mode: str = "reverse"
    render_sample_budget: Optional[int] = 512 * (64 + 16 + 16) * 5 // 4
    use_color_calibration: bool = True
    nr_rays: int = 512
    sdf_geom_feat_size: int = 32
    sdf_nr_iters_for_c2f: int = 10000
    rgb_nr_iters_for_c2f: int = 1
    background_nr_iters_for_c2f: int = 1
    with_mask: bool = False
    warmup_iters: int = 3000
    lr_decay_gamma: float = 0.3
    sphere_init_points: int = 30000
    sphere_init_radius: float = 0.3
    grid_nr_voxels_per_dim: int = 256
    grid_update_every: int = 8
    grid_nr_random_samples: int = 256 * 256 * 4
    grid_occupancy_thresh: float = 1e-4
    curvature_sample_budget: Optional[int] = 8192
    train_lod_top_k: Optional[int] = None
    train_lod_rand_extra: int = 8
    hit_ray_frac: Optional[float] = None
    hit_ray_compact_early: bool = True
    lever_start_iter: Optional[int] = None
    grid_update_max_levels: Optional[int] = 14
    capacity: int = 2 ** 18
    nr_levels: int = 24
    bg_nr_levels: Optional[int] = None
    enable_curvature: bool = True
    enable_eikonal: bool = True
    enable_offsurface: bool = True
    enable_lipshitz: bool = True
    table_row_gather: bool = True
    sorted_scatter: bool = False
    table_grad_alternate: bool = False
    table_grad_parity: Optional[int] = None
    table_grad_period: int = 2
    c2f_level_skip: bool = True
    sdf_active_levels: Optional[int] = None

    @property
    def sdf_model(self) -> SDFConfig:
        return SDFConfig(in_channels=3, geom_feat_size_out=self.sdf_geom_feat_size,
                         nr_iters_for_c2f=self.sdf_nr_iters_for_c2f,
                         capacity=self.capacity, nr_levels=self.nr_levels,
                         active_levels=self.sdf_active_levels)

    @property
    def rgb_model(self) -> RGBConfig:
        return RGBConfig(in_channels=3, geom_feat_size_in=self.sdf_geom_feat_size,
                         nr_iters_for_c2f=self.rgb_nr_iters_for_c2f,
                         capacity=self.capacity, nr_levels=self.nr_levels)

    @property
    def bg_model(self) -> NerfHashConfig:
        return NerfHashConfig(
            in_channels=4, nr_iters_for_c2f=self.background_nr_iters_for_c2f,
            capacity=self.capacity,
            nr_levels=(self.bg_nr_levels if self.bg_nr_levels is not None
                       else self.nr_levels))

    @property
    def grid(self) -> og.OccupancyGridConfig:
        return og.OccupancyGridConfig(nr_voxels_per_dim=self.grid_nr_voxels_per_dim)


BOUND = Sphere(0.5, (0.0, 0.0, 0.0))


def init_params(seed, cfg: PermutoSDFTrainConfig, nr_cams: int = 1, device=None):
    """Random parameters of the three fields (+ variance, colorcal), drawn
    on the CPU from ``seed`` (an int or a ``torch.Generator``) and placed on
    ``device`` (None means the GPU)."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    params = {
        "sdf": init_sdf(gen, cfg.sdf_model, device),
        "rgb": init_rgb(gen, cfg.rgb_model, device),
        "bg": init_nerf_hash(gen, cfg.bg_model, device),
        "variance": vr.init_variance(0.3, device),
    }
    if cfg.use_color_calibration:
        params["colorcal"] = {"weight_delta": torch.zeros((nr_cams, 3), device=device),
                              "bias": torch.zeros((nr_cams, 3), device=device)}
    return params


def _check_eval_branch(cfg: PermutoSDFTrainConfig, jitter: bool):
    if (jitter or cfg.train_lod_top_k is not None or cfg.hit_ray_frac is not None
            or cfg.render_sample_budget is not None):
        raise NotImplementedError(_TRAINING_SLICE)
    if not cfg.use_occupancy_grid:
        raise NotImplementedError("sampling without the occupancy grid is not ported yet")


def _create_fg_samples(params, grid, origins, dirs, t_entry, t_exit,
                       iter_nr_anneal, cfg: PermutoSDFTrainConfig):
    """Uniform occupancy sampling + importance sampling (eval branch)."""
    samples = og.compute_samples_in_occupied_regions(
        cfg.grid, grid, origins, dirs, t_entry, t_exit,
        cfg.min_dist_between_samples, cfg.max_nr_samples_per_ray)
    if cfg.do_importance_sampling:
        def sdf_fn(pts, _flat_mask):
            return sdf_apply(params["sdf"], pts, iter_nr_anneal, cfg.sdf_model,
                             max_levels=cfg.imp_sampling_max_levels)[0]

        samples = importance_sampling_sdf_model(sdf_fn, samples, t_exit,
                                                cfg.nr_samples_imp_sampling)
    return samples


def run_net(params, grid, origins, dirs, iter_nr_anneal, cos_anneal_ratio,
            forced_variance, cfg: PermutoSDFTrainConfig, jitter: bool = False):
    """Eval-branch render of a ray batch. Returns (pred_rgb [R,3],
    pred_normals [R,3], weights_sum [R,1], extras) with ``extras`` holding
    the fg ``samples`` and their ``weights``."""
    _check_eval_branch(cfg, jitter)
    if grid is None:
        raise NotImplementedError("sampling without the occupancy grid is not ported yet")
    _, t_entry, _, t_exit, _ = BOUND.ray_intersection(origins, dirs)
    samples = _create_fg_samples(params, grid, origins, dirs, t_entry, t_exit,
                                 iter_nr_anneal, cfg)
    return render_samples(params, samples, t_exit, iter_nr_anneal, cos_anneal_ratio,
                          forced_variance, cfg)


def render_samples(params, samples, t_exit, iter_nr_anneal, cos_anneal_ratio,
                   forced_variance, cfg: PermutoSDFTrainConfig):
    """The part of :func:`run_net` after the fg samples are placed: the
    fields, the NeuS weights and the background. Same returns."""
    origins, dirs = samples.origins, samples.dirs
    inv_s = vr.variance_inv_s(params["variance"], forced_variance)
    pos = samples.flat_positions()
    sdf, grads, geom = sdf_with_gradient(params["sdf"], pos, iter_nr_anneal,
                                         cfg.sdf_model)
    rgb = rgb_apply(params["rgb"], pos, samples.flat_dirs(), grads, geom,
                    iter_nr_anneal, cfg.rgb_model)
    weights, weights_sum, bg_T, pred_rgb, grad_int = vr.neus_render(
        samples, sdf, grads, rgb, inv_s, cos_anneal_ratio)
    pred_normals = grad_int / (torch.linalg.norm(grad_int, dim=-1, keepdim=True) + 1e-12)
    if not cfg.with_mask:
        bg = compute_samples_bg(origins, dirs, t_exit, cfg.nr_samples_bg,
                                BOUND.radius, BOUND.center)
        rgb_bg, dens_bg = nerf_hash_apply(params["bg"], bg.pos_4d.reshape(-1, 4),
                                          bg.flat_dirs(), iter_nr_anneal, cfg.bg_model)
        pred_rgb_bg = vr.nerf_render(bg, dens_bg, rgb_bg)[3]
        pred_rgb = pred_rgb + bg_T[:, None] * pred_rgb_bg
    return pred_rgb, pred_normals, weights_sum, {"samples": samples, "weights": weights}


def _eval_cfg(cfg: PermutoSDFTrainConfig) -> PermutoSDFTrainConfig:
    """The eval render strips the training-batch contracts (sample budget,
    train-time LOD, hit-ray compaction), as the JAX render does."""
    return dataclasses.replace(cfg, render_sample_budget=None, train_lod_top_k=None,
                               hit_ray_frac=None)


@torch.no_grad()
def render_rays_eval(params, grid, origins, dirs, iter_nr_anneal, cos_anneal_ratio,
                     forced_variance, cfg: PermutoSDFTrainConfig):
    """Exact eval render of one ray batch -> (rgb, normals, weights_sum)."""
    rgb, nrm, wsum, _ = run_net(params, grid, origins, dirs, iter_nr_anneal,
                                cos_anneal_ratio, forced_variance, _eval_cfg(cfg))
    return rgb, nrm, wsum


@torch.no_grad()
def render_image(params, grid, K, tf_world_cam, width, height, iter_nr_anneal,
                 cfg: PermutoSDFTrainConfig, forced_variance=0.8, chunk: int = 2048,
                 mesh=None, lod=False, device=None):
    """Exact volumetric render of one view, ``chunk`` rays at a time ->
    (rgb [H,W,3], normals [H,W,3], alpha [H,W,1]) tensors on ``device``
    (None means the GPU; params and grid must already live there)."""
    if mesh is not None:
        raise NotImplementedError("multi-device rendering is not ported yet")
    if lod:
        raise NotImplementedError("the LOD eval render is not ported yet")
    device = resolve_device(device)
    table = params["sdf"]["encoding"]["lattice_values"]
    if table.device.type != device.type or grid.occupancy.device.type != device.type:
        raise ValueError(f"render_image: params and grid must be on {device}")
    cfg = _eval_cfg(cfg)
    origins, dirs = rays_from_frame(K, tf_world_cam, width, height, device=device)
    n = origins.shape[0]
    pad = (-n) % chunk
    origins = torch.cat([origins, torch.zeros((pad, 3), device=device)], 0)
    pad_dirs = torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(pad, 3)
    dirs = torch.cat([dirs, pad_dirs], 0)
    outs = [render_rays_eval(params, grid, origins[s:s + chunk], dirs[s:s + chunk],
                             iter_nr_anneal, 1.0, forced_variance, cfg)
            for s in range(0, n + pad, chunk)]
    rgb, nrm, alpha = (torch.cat(parts, 0)[:n] for parts in zip(*outs))
    return (rgb.reshape(height, width, 3), nrm.reshape(height, width, 3),
            alpha.reshape(height, width, 1))


def load_from_checkpoint(ckpt_path_full: str, cfg: PermutoSDFTrainConfig, device=None):
    """Read a checkpoint written by the JAX trainer -> (params, grid or None)."""
    device = resolve_device(device)
    tree = {
        "sdf": ckpt.load_model(ckpt_path_full, "sdf_model"),
        "rgb": ckpt.load_model(ckpt_path_full, "rgb_model"),
        "bg": ckpt.load_model(ckpt_path_full, "nerf_hash_model_bg"),
        "variance": ckpt.load_model(ckpt_path_full, "variance"),
    }
    if os.path.isfile(os.path.join(ckpt_path_full, "colorcal_model.npz")):
        tree["colorcal"] = ckpt.load_model(ckpt_path_full, "colorcal_model")
    params = params_from_jax(tree, device)
    grid = None
    if os.path.isfile(os.path.join(ckpt_path_full, "occupancy_grid.npz")):
        g = params_from_jax(ckpt.load_model(ckpt_path_full, "occupancy_grid"), device)
        grid = og.OccupancyGridState(values=g["values"], occupancy=g["occupancy"].bool())
    return params, grid
