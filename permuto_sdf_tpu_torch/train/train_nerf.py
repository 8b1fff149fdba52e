"""Permuto-NeRF training: a density field with the permutohedral encoding
(counterpart of ``permuto_sdf_tpu/train/train_nerf.py``).

A NerfHash foreground (the encoding at d = 3, kernel A) and a NerfHash
background on the NeRF++ 4D parameterisation (d = 4), a 64^3 occupancy grid
refreshed from the density every 8 iterations (kernel I2f: the
stratified probes, the density and the update in one launch; decay 0.7,
threshold 1e-3), the fg samples placed
through the grid (kernel C) or, with ``use_occupancy_grid=False``,
uniformly (kernel C2, the bound's intersection in its launch), NeRF
weights and integration (kernel D in NeRF mode, its backward D'), an MSE
rgb loss masked by the bound intersection, the optional mask BCE,
per-image colour calibration and Adam (betas 0.9/0.99, eps 1e-15) at a
constant lr.

JAX draws its randomness from keys split inside the step; the port takes
the same draws as tensors (:class:`NerfDraws`), made from the
``torch.Generator`` s that :func:`train` derives from ``(seed, iteration)``.
The samples carry no gradient (JAX stops it there); the gradient runs
through D' and the encoding's table backward (kernel F).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from permuto_sdf_tpu_torch.datasets.tensor_reel import (
    TensorReel, draw_ray_indices, random_rays_from_reel, rays_from_frame,
)
from permuto_sdf_tpu_torch.device import resolve_device
from permuto_sdf_tpu_torch.models.fields import (
    NerfHashConfig, init_colorcal, init_nerf_hash, nerf_hash_apply,
)
from permuto_sdf_tpu_torch.ops import occupancy_grid as og
from permuto_sdf_tpu_torch.ops import volume_rendering as vr
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
from permuto_sdf_tpu_torch.ops.ray_sampler import compute_samples_bg, compute_samples_fg_in_sphere
from permuto_sdf_tpu_torch.train import checkpoint as ckpt
from permuto_sdf_tpu_torch.train.optimizers import ManualAdam
from permuto_sdf_tpu_torch.train.train_permuto_sdf import _grads_of, _with_grad, step_generators


@dataclasses.dataclass(frozen=True)
class NerfTrainConfig:
    """The fields and defaults of the JAX ``NerfTrainConfig``."""

    lr: float = 1e-3
    nr_rays: int = 512
    iter_finish_training: int = 200000
    use_occupancy_grid: bool = True
    nr_samples_bg: int = 32
    min_dist_between_samples: float = 0.0001
    max_nr_samples_per_ray: int = 64
    use_color_calibration: bool = True
    with_mask: bool = False
    mask_weight: float = 0.1
    foreground_nr_iters_for_c2f: int = 1
    background_nr_iters_for_c2f: int = 10000
    grid_nr_voxels_per_dim: int = 64
    grid_update_every: int = 8
    grid_decay: float = 0.7
    grid_occupancy_thresh: float = 1e-3
    grid_nr_random_samples: int = 256 * 256
    capacity: int = 2 ** 18
    nr_levels: int = 24

    @property
    def fg_model(self) -> NerfHashConfig:
        return NerfHashConfig(in_channels=3, nr_iters_for_c2f=self.foreground_nr_iters_for_c2f,
                              capacity=self.capacity, nr_levels=self.nr_levels)

    @property
    def bg_model(self) -> NerfHashConfig:
        return NerfHashConfig(in_channels=4, nr_iters_for_c2f=self.background_nr_iters_for_c2f,
                              capacity=self.capacity, nr_levels=self.nr_levels)

    @property
    def grid(self) -> og.OccupancyGridConfig:
        return og.OccupancyGridConfig(nr_voxels_per_dim=self.grid_nr_voxels_per_dim)


BOUND = Sphere(0.5, (0.0, 0.0, 0.0))


def init_params(seed, cfg: NerfTrainConfig, nr_cams: int, device=None):
    """Random parameters of the two fields (+ colorcal), drawn on the CPU
    from ``seed`` (an int or a ``torch.Generator``) and placed on
    ``device`` (None means the GPU)."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    params = {"model": init_nerf_hash(gen, cfg.fg_model, device),
              "model_bg": init_nerf_hash(gen, cfg.bg_model, device)}
    if cfg.use_color_calibration:
        params["colorcal"] = init_colorcal(nr_cams, device)
    return params


def make_optimizer(cfg: NerfTrainConfig) -> ManualAdam:
    """Adam with betas (0.9, 0.99) and eps 1e-15; :func:`train_step` gives it
    ``cfg.lr``."""
    return ManualAdam(b1=0.9, b2=0.99, eps=1e-15)


@dataclasses.dataclass
class NerfDraws:
    """Every random number one step uses: ray_indices (image ids [R], pixel
    ids [R]); fg_start [R, 1] in [0, 1), the fg sampler's first-sample
    jitter; bg_rand [R, S_bg] in [0, 1), the background sampler's."""

    ray_indices: tuple
    fg_start: torch.Tensor
    bg_rand: torch.Tensor

    def to(self, device) -> "NerfDraws":
        return NerfDraws(tuple(t.to(device) for t in self.ray_indices),
                         self.fg_start.to(device), self.bg_rand.to(device))


def draw_train_step(generator: torch.Generator, cfg: NerfTrainConfig,
                    reel: TensorReel) -> NerfDraws:
    """One step's draws from ``generator`` (on the CPU)."""
    R = cfg.nr_rays
    return NerfDraws(ray_indices=draw_ray_indices(reel, R, generator),
                     fg_start=torch.rand((R, 1), generator=generator),
                     bg_rand=torch.rand((R, cfg.nr_samples_bg), generator=generator))


@torch.no_grad()
def occupancy_update(params, grid, draws, iter_nr, cfg: NerfTrainConfig):
    """The density refresh of ``grid_nr_random_samples`` voxels, in place:
    the stratified probes of update ``iter_nr // grid_update_every``, the
    foreground density there and I2's update, in one launch of kernel I2f
    on the card (``og.refresh_with_density``). ``draws`` is a generator or
    the in-voxel jitter [n, 3] in [-0.5, 0.5)."""
    n = cfg.grid_nr_random_samples
    jitter = (torch.rand((n, 3), generator=draws) - 0.5
              if isinstance(draws, torch.Generator) else draws)
    return og.refresh_with_density(cfg.grid, grid, cfg.fg_model, params["model"], iter_nr, n,
                                   int(iter_nr) // cfg.grid_update_every,
                                   jitter.to(grid.values.device), cfg.grid_decay,
                                   cfg.grid_occupancy_thresh)


def _render_rays(params, grid, origins, dirs, img_indices, iter_nr, cfg: NerfTrainConfig,
                 draws: Optional[NerfDraws] = None):
    """The fg and bg render of a ray batch, for training and for the eval
    render. ``draws`` carries the jitter (None: none); ``img_indices [R]``
    switch on the colour calibration. -> (pred_rgb [R,3], pred_rgb_bg [R,3]
    or None, weights_sum [R,1], does_intersect [R,1])."""
    start = draws.fg_start if draws is not None else None
    with torch.no_grad():
        if cfg.use_occupancy_grid and grid is not None:
            _, t_entry, _, t_exit, does_intersect = BOUND.ray_intersection(origins, dirs)
            samples = og.compute_samples_in_occupied_regions(
                cfg.grid, grid, origins, dirs, t_entry, t_exit, cfg.min_dist_between_samples,
                cfg.max_nr_samples_per_ray, start=start)
        else:  # the bound's intersection inside kernel C2's launch
            samples, _, t_exit, does_intersect = compute_samples_fg_in_sphere(
                origins, dirs, BOUND, cfg.min_dist_between_samples,
                cfg.max_nr_samples_per_ray, start=start)
    R, S = samples.mask.shape
    colorcal = params.get("colorcal")
    cc = colorcal if (colorcal is not None and img_indices is not None) else None
    per_sample_img = img_indices[:, None].expand(R, S).reshape(-1) if cc is not None else None
    rgb_flat, density_flat = nerf_hash_apply(
        params["model"], samples.flat_positions(), samples.flat_dirs(), iter_nr, cfg.fg_model,
        colorcal_params=cc, per_sample_img_indices=per_sample_img)
    _, weights_sum, bg_T, pred_rgb = vr.nerf_render(samples, density_flat, rgb_flat)
    pred_rgb_bg = None
    if not cfg.with_mask:
        with torch.no_grad():
            bg = compute_samples_bg(origins, dirs, t_exit, cfg.nr_samples_bg, BOUND.radius,
                                    BOUND.center,
                                    rand=draws.bg_rand if draws is not None else None)
        Sb = cfg.nr_samples_bg
        img_bg = img_indices[:, None].expand(R, Sb).reshape(-1) if cc is not None else None
        rgb_bg, density_bg = nerf_hash_apply(
            params["model_bg"], bg.pos_4d.reshape(-1, 4), bg.flat_dirs(), iter_nr,
            cfg.bg_model, colorcal_params=cc, per_sample_img_indices=img_bg)
        pred_rgb_bg = vr.nerf_render(bg, density_bg, rgb_bg)[3]
        pred_rgb = pred_rgb + bg_T[:, None] * pred_rgb_bg
    return pred_rgb, pred_rgb_bg, weights_sum, does_intersect


def compute_loss_and_grads(params, grid, reel: TensorReel, draws, iter_nr,
                           cfg: NerfTrainConfig):
    """Loss and the gradient of every leaf for one ray batch. ``draws`` is a
    :class:`NerfDraws` or a generator to make one from. Returns (loss,
    loss_rgb, grads) with ``grads`` a tree like ``params``."""
    device = params["model"]["encoding"]["lattice_values"].device
    if isinstance(draws, torch.Generator):
        draws = draw_train_step(draws, cfg, reel)
    draws = draws.to(device)
    # mask-multiplied targets only with mask supervision (else the
    # background field would learn the zeroed pixels)
    origins, dirs, gt_rgb, gt_mask, img_indices = random_rays_from_reel(
        reel, cfg.nr_rays, indices=draws.ray_indices, apply_mask=cfg.with_mask)
    p = _with_grad(params)
    pred_rgb, _, weights_sum, does_intersect = _render_rays(
        p, grid, origins, dirs, img_indices, iter_nr, cfg, draws)
    loss_rgb = torch.mean((gt_rgb - pred_rgb) ** 2 * does_intersect)
    loss = loss_rgb
    if cfg.with_mask:
        ws = torch.clamp(weights_sum, 1e-3, 1.0 - 1e-3)
        bce = -(gt_mask * torch.log(ws) + (1 - gt_mask) * torch.log(1 - ws))
        loss = loss + torch.mean(bce) * cfg.mask_weight
    grads = _grads_of(loss, p)
    return loss.detach(), loss_rgb.detach(), grads


def train_step(params, opt_state, grid, reel: TensorReel, draws, iter_nr,
               cfg: NerfTrainConfig, optimizer):
    """One iteration -> (params, opt_state, loss, loss_rgb); Adam at
    ``cfg.lr``, in place."""
    loss, loss_rgb, grads = compute_loss_and_grads(params, grid, reel, draws, iter_nr, cfg)
    params, opt_state = optimizer.update(grads, opt_state, params, cfg.lr)
    return params, opt_state, loss, loss_rgb


@torch.no_grad()
def render_rays_eval(params, grid, origins, dirs, iter_nr, cfg: NerfTrainConfig):
    """Eval render of one ray batch (no jitter, no colorcal) -> (rgb [R,3],
    weights_sum [R,1])."""
    pred_rgb, _, weights_sum, _ = _render_rays(params, grid, origins, dirs, None, iter_nr, cfg)
    return pred_rgb, weights_sum


@torch.no_grad()
def render_image(params, grid, reel: TensorReel, img_idx: int, iter_nr, cfg: NerfTrainConfig,
                 chunk: int = 4096, device=None):
    """View ``img_idx`` of the reel, ``chunk`` rays at a time -> (rgb
    [H,W,3], alpha [H,W,1]) on ``device`` (None means the GPU; params and
    grid must live there)."""
    device = resolve_device(device)
    table = params["model"]["encoding"]["lattice_values"]
    if table.device.type != device.type or (grid is not None
                                           and grid.values.device.type != device.type):
        raise ValueError(f"render_image: params and grid must be on {device}")
    h, w = reel.height, reel.width
    origins, dirs = rays_from_frame(reel.K[img_idx].cpu(), reel.tf_world_cam[img_idx].cpu(),
                                    w, h, device=device)
    n = origins.shape[0]
    pad = (-n) % chunk
    origins = torch.cat([origins, torch.zeros((pad, 3), device=device)], 0)
    dirs = torch.cat([dirs, torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(pad, 3)], 0)
    outs = [render_rays_eval(params, grid, origins[i:i + chunk], dirs[i:i + chunk], iter_nr, cfg)
            for i in range(0, n + pad, chunk)]
    rgb, alpha = (torch.cat(parts, 0)[:n] for parts in zip(*outs))
    return rgb.reshape(h, w, 3), alpha.reshape(h, w, 1)


def train(reel: TensorReel, cfg: NerfTrainConfig, nr_iters: Optional[int] = None,
          seed: int = 0, log_every: int = 1000, checkpoint_path: Optional[str] = None,
          experiment_name: str = "nerf", save_every: int = 10000, device=None):
    """Train from scratch on one device (None means the GPU; the reel is
    moved there), the grid refreshed every ``grid_update_every``
    iterations, the draws of iteration ``it`` from the generators of
    ``(seed, it)``. Returns (params, grid, history of (it, loss))."""
    device = resolve_device(device)
    reel = reel.to(device)
    nr_iters = nr_iters or cfg.iter_finish_training
    params = init_params(seed, cfg, reel.nr_images, device)
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    grid = og.make_occupancy_grid(cfg.grid, device=device) if cfg.use_occupancy_grid else None
    history = []
    t0 = time.perf_counter()
    for it in range(nr_iters):
        g_step, g_grid = step_generators(seed, it)
        if cfg.use_occupancy_grid and it % cfg.grid_update_every == 0:
            grid = occupancy_update(params, grid, g_grid, it, cfg)
        params, opt_state, loss, _ = train_step(params, opt_state, grid, reel, g_step, it, cfg,
                                                optimizer)
        if it % log_every == 0 or it == nr_iters - 1:
            lv = float(loss)
            history.append((it, lv))
            print(f"iter {it:6d}  loss {lv:.6f}  ({time.perf_counter() - t0:.1f}s)")
        if checkpoint_path and save_every and it > 0 and it % save_every == 0:
            _save(checkpoint_path, experiment_name, it, params, grid, cfg)
    if checkpoint_path:
        _save(checkpoint_path, experiment_name, nr_iters, params, grid, cfg)
    return params, grid, history


def _save(checkpoint_path, experiment_name, it, params, grid, cfg):
    """The JAX trainer's checkpoint: one ``.npz`` per model and the grid."""
    for name, key in (("nerf_hash_model", "model"), ("nerf_hash_model_bg", "model_bg"),
                      ("colorcal_model", "colorcal")):
        if key in params:
            ckpt.save_model(checkpoint_path, experiment_name, it, name, params[key])
    if grid is not None:
        ckpt.save_model(checkpoint_path, experiment_name, it, "occupancy_grid", grid)


def main(argv=None, device=None):
    """The trainer's command line (``argv``, else ``sys.argv``) on
    ``device`` (None means the GPU). Returns what :func:`train` returns."""
    parser = argparse.ArgumentParser(description="Train permuto-NeRF")
    parser.add_argument("--dataset", default="synthetic", help="synthetic | dtu")
    parser.add_argument("--scene_dir", default=None, help="DTU scene directory")
    parser.add_argument("--nr_iters", type=int, default=200000)
    parser.add_argument("--low_res", action="store_true")
    parser.add_argument("--with_mask", action="store_true")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--exp_info", default="")
    parser.add_argument("--config", default=None,
                        help="hjson-style config file (see config/train_nerf.cfg)")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        dest="overrides", help="config override, repeatable")
    args = parser.parse_args(argv)
    from permuto_sdf_tpu_torch.config import apply_file_and_cli

    device = resolve_device(device)
    if args.dataset == "synthetic":
        from permuto_sdf_tpu_torch.datasets.synthetic import make_synthetic_reel

        side = 64 if args.smoke else 200
        reel = make_synthetic_reel(nr_views=8 if args.smoke else 24, width=side, height=side,
                                   device=device)
    else:
        from permuto_sdf_tpu_torch.datasets.dtu import load_dtu_scene

        reel = load_dtu_scene(args.scene_dir, low_res=args.low_res, with_mask=args.with_mask,
                              device=device)
    if args.smoke:
        cfg = NerfTrainConfig(with_mask=args.with_mask, capacity=2 ** 14, nr_levels=8,
                              nr_rays=256, grid_nr_random_samples=4096)
        cfg = apply_file_and_cli(cfg, args.config, args.overrides)
        out = train(reel, cfg, nr_iters=300, log_every=50, device=device)
        history = out[2]
        if not history[-1][1] < history[0][1]:
            raise RuntimeError(f"smoke: loss did not decrease: {history[0][1]} -> "
                               f"{history[-1][1]}")
        print("SMOKE OK: loss", history[0][1], "->", history[-1][1])
        return out
    cfg = apply_file_and_cli(NerfTrainConfig(with_mask=args.with_mask), args.config,
                             args.overrides)
    exp = "nerf" + (f"_{args.exp_info}" if args.exp_info else "")
    return train(reel, cfg, nr_iters=args.nr_iters, checkpoint_path=args.checkpoint_path,
                 experiment_name=exp, device=device)


if __name__ == "__main__":
    main()
