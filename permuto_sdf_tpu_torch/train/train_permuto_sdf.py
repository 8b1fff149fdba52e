"""PermutoSDF: configuration, parameters, the training step and loop, and
the exact volumetric eval render (counterpart of
``permuto_sdf_tpu/train/train_permuto_sdf.py``).

Slice 1 of the port serves frames (:func:`render_image`); slice 2 trains
(:func:`sphere_init_step`, :func:`compute_loss_and_grads`,
:func:`apply_updates`, :func:`train_step`, :func:`occupancy_update` and
:func:`train`, with ``resume_from``); slice 3 serves the interactive
sphere-traced frame (:func:`render_image_sphere_traced_fast`); slice 4 adds
the hit-ray compaction of the step (``hit_ray_frac``) and the viewer's LOD
volumetric frame (``render_image(lod=)``); slice 5 the rest of the
recommended training profile: the train-time LOD (``train_lod_top_k``,
``train_lod_rand_extra``), alternating-level table gradients
(``table_grad_alternate``) and the gate that holds both back
(``lever_start_iter``); slice 7 the plain sphere-traced frame
(:func:`render_image_sphere_traced` and the compacted ray renderer) and
training and rendering without the occupancy grid
(``use_occupancy_grid=False``: the uniform fg sampler, no grid refresh and
no offsurface loss). JAX draws its randomness from keys
split inside the step; the port takes the same draws as tensors
(:class:`TrainDraws`), made from a ``torch.Generator`` that :func:`train`
derives from ``(seed, iteration)``, so a resumed run sees the draws of an
uninterrupted one. Knobs and branches not ported yet raise
``NotImplementedError`` naming what they wait for.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from permuto_sdf_tpu_torch.convert import opt_state_from_jax, params_from_jax
from permuto_sdf_tpu_torch.datasets.tensor_reel import (
    TensorReel, draw_ray_indices, random_rays_from_reel, rays_from_frame,
)
from permuto_sdf_tpu_torch.device import resolve_device
from permuto_sdf_tpu_torch.models.fields import (
    NerfHashConfig, RGBConfig, SDFConfig, SDFEval, init_colorcal, init_nerf_hash, init_rgb,
    init_sdf, nerf_hash_apply, rgb_apply, sdf_apply, sdf_curvature_from_gradient,
    sdf_with_gradient,
)
from permuto_sdf_tpu_torch.models.mlp import lipshitz_bound_full
from permuto_sdf_tpu_torch.ops import occupancy_grid as og
from permuto_sdf_tpu_torch.ops import volume_rendering as vr
from permuto_sdf_tpu_torch.ops.compaction import nonzero_static, scatter_rows, take_rows
from permuto_sdf_tpu_torch.ops.importance_sampling import importance_sampling_sdf_model
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
from permuto_sdf_tpu_torch.ops.ray_sampler import compute_samples_bg, compute_samples_fg
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
from permuto_sdf_tpu_torch.ops.sphere_trace import (
    _grid_distance_field, pow2_bucket, sphere_trace, sphere_trace_adaptive,
    sphere_trace_compacted,
)
from permuto_sdf_tpu_torch.train import checkpoint as ckpt
from permuto_sdf_tpu_torch.train.optimizers import ManualAdam, tree_leaves, tree_map
from permuto_sdf_tpu_torch.utils.losses import sdf_loss_sphere


@dataclasses.dataclass(frozen=True)
class PermutoSDFTrainConfig:
    """The fields and defaults of the JAX ``PermutoSDFTrainConfig``. Knobs
    that only steer the TPU lowering and give the same values there
    (``sorted_scatter``, ``sdf_gradient_mode``) are accepted and ignored.
    ``table_row_gather=False`` is not: in JAX it sends every encode through
    the packed-bf16 gather, whose forward values round to bf16, so the
    model configs below raise ``NotImplementedError`` for it."""

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
    def iter_finish_reduce_curv(self) -> int:
        return self.iter_start_reduce_curv + 1001

    @property
    def samples_per_ray(self) -> int:
        return self.max_nr_samples_per_ray + (
            2 * self.nr_samples_imp_sampling if self.do_importance_sampling else 0)

    def _check_table_gather(self):
        if not self.table_row_gather:
            raise NotImplementedError(
                "table_row_gather=False: the packed-bf16 table gather (bf16-rounded "
                "forward values) is not ported; the port encodes in float32")

    @property
    def sdf_model(self) -> SDFConfig:
        self._check_table_gather()
        return SDFConfig(in_channels=3, geom_feat_size_out=self.sdf_geom_feat_size,
                         nr_iters_for_c2f=self.sdf_nr_iters_for_c2f,
                         capacity=self.capacity, nr_levels=self.nr_levels,
                         grad_level_parity=self.table_grad_parity,
                         grad_level_period=self.table_grad_period,
                         active_levels=self.sdf_active_levels)

    @property
    def rgb_model(self) -> RGBConfig:
        self._check_table_gather()
        return RGBConfig(in_channels=3, geom_feat_size_in=self.sdf_geom_feat_size,
                         nr_iters_for_c2f=self.rgb_nr_iters_for_c2f,
                         capacity=self.capacity, nr_levels=self.nr_levels,
                         grad_level_parity=self.table_grad_parity,
                         grad_level_period=self.table_grad_period)

    @property
    def bg_model(self) -> NerfHashConfig:
        self._check_table_gather()
        return NerfHashConfig(
            in_channels=4, nr_iters_for_c2f=self.background_nr_iters_for_c2f,
            capacity=self.capacity,
            nr_levels=(self.bg_nr_levels if self.bg_nr_levels is not None
                       else self.nr_levels),
            grad_level_parity=self.table_grad_parity,
            grad_level_period=self.table_grad_period)

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
        params["colorcal"] = init_colorcal(nr_cams, device)
    return params


# ---------------------------------------------------------------------------
# Schedules, optimizer, weight decay
# ---------------------------------------------------------------------------

def _map_range_f32(x, in_start, in_end, out_start, out_end) -> float:
    """map_range_val on a scalar in float32, as JAX evaluates it on a traced
    iteration count."""
    x = np.float32(np.clip(np.float32(x), in_start, in_end))
    k = np.float32((out_end - out_start) / (in_end - in_start))
    return float(np.float32(np.float32(out_start) + k * (x - np.float32(in_start))))


def lr_schedule(cfg: PermutoSDFTrainConfig, iter_nr) -> np.float32:
    """Flat during sphere init; then a linear warm-up over ``warmup_iters``
    and x ``lr_decay_gamma`` at each milestone (counted after sphere init)."""
    it = np.float32(iter_nr)
    s = it - np.float32(cfg.nr_iter_sphere_fit)
    warm = np.float32(np.clip(s / np.float32(cfg.warmup_iters), 0.0, 1.0))
    n = np.float32(sum(s >= np.float32(m) for m in cfg.lr_milestones))
    decay = np.float32(np.float32(cfg.lr_decay_gamma) ** n)
    if it < cfg.nr_iter_sphere_fit:
        return np.float32(cfg.lr)
    return np.float32(np.float32(np.float32(cfg.lr) * warm) * decay)


def make_optimizer(cfg: PermutoSDFTrainConfig) -> ManualAdam:
    return ManualAdam(b1=0.9, b2=0.99, eps=1e-15)


@torch.no_grad()
def _apply_weight_decay(params, lr_now, iter_nr, cfg: PermutoSDFTrainConfig):
    """Decoupled decay of the colorcal group (1e-1 always) and of the rgb
    encoding's table (1.0 once curvature starts to reduce), in place."""
    lr_now = np.float32(lr_now)
    if "colorcal" in params:
        factor = float(np.float32(1.0) - lr_now * np.float32(1e-1))
        for t in params["colorcal"].values():
            t.mul_(factor)
    if (iter_nr - cfg.nr_iter_sphere_fit) >= cfg.iter_start_reduce_curv:
        params["rgb"]["encoding"]["lattice_values"].mul_(float(np.float32(1.0) - lr_now))
    return params


# ---------------------------------------------------------------------------
# Random draws of one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainDraws:
    """Every random number one training step uses (JAX draws each from its
    own part of the step's key):

    ray_indices (image ids [R], pixel ids [R]) -- ``random_rays_from_reel``;
    fg_start [R, 1] in [0, 1) -- the fg sampler's first-sample jitter (the
occupancy sampler's, or without the grid the uniform sampler's);
    imp_jitter (u1, u2), each [R, n] in +-1/(2(n+1)) -- importance sampling
    (R is the hit-ray bucket's size with early hit-ray compaction, which
    runs the importance stage on the bucket);
    bg_rand [R, S_bg] in [0, 1) -- the background sampler's jitter;
    curv_dirs [Nc, 3] standard normal -- the curvature loss's directions;
    off_points (phi, cos theta, u), each [1024] -- the offsurface points;
    lod_scores [R, S] in [0, 1) or None -- the train-time LOD's random
    extras (drawn only when the LOD takes extras; R before hit-ray
    compaction, so a compacted step selects the dense step's slots)."""

    ray_indices: tuple
    fg_start: torch.Tensor
    imp_jitter: tuple
    bg_rand: torch.Tensor
    curv_dirs: torch.Tensor
    off_points: tuple
    lod_scores: Optional[torch.Tensor] = None

    def to(self, device) -> "TrainDraws":
        def move(t):
            if t is None:
                return None
            return tuple(x.to(device) for x in t) if isinstance(t, tuple) else t.to(device)

        return TrainDraws(**{f.name: move(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


NR_OFFSURFACE_POINTS = 1024


def _hit_compaction(cfg: PermutoSDFTrainConfig) -> bool:
    return cfg.hit_ray_frac is not None and cfg.hit_ray_frac < 1.0


def _hit_ray_budget(nr_rays: int, frac: float) -> int:
    """Static hit-ray bucket size: ceil(R * frac) rounded up to 64."""
    h = -(-int(nr_rays * frac) // 64) * 64
    return max(64, min(nr_rays, h))


def _fg_rays(cfg: PermutoSDFTrainConfig) -> int:
    """Rays the fg fields see per step: the hit-ray bucket or all of them."""
    return _hit_ray_budget(cfg.nr_rays, cfg.hit_ray_frac) if _hit_compaction(cfg) else cfg.nr_rays


def _train_lod(cfg: PermutoSDFTrainConfig, S: Optional[int] = None):
    """(K, E) of the train-time LOD for S samples per ray (default: the
    step's), or None when it is off."""
    if cfg.train_lod_top_k is None or not cfg.do_importance_sampling:
        return None
    S = cfg.samples_per_ray if S is None else S
    K = min(cfg.train_lod_top_k, S)
    return K, min(cfg.train_lod_rand_extra, S - K)


def _compact_size(cfg: PermutoSDFTrainConfig) -> int:
    """Samples the fields evaluate per step: the LOD's fine set, R * (K +
    E); else R * S, capped at the budget."""
    lod = _train_lod(cfg)
    if lod is not None:
        return _fg_rays(cfg) * sum(lod)
    M = _fg_rays(cfg) * cfg.samples_per_ray
    return min(M, cfg.render_sample_budget) if cfg.render_sample_budget else M


def draw_train_step(generator: torch.Generator, cfg: PermutoSDFTrainConfig,
                    reel: TensorReel) -> TrainDraws:
    """One step's draws from ``generator`` (on the CPU)."""
    R, n = cfg.nr_rays, cfg.nr_samples_imp_sampling
    R_imp = _fg_rays(cfg) if cfg.hit_ray_compact_early else R
    mov = 1.0 / (n + 1) / 2.0
    nc = _compact_size(cfg)
    cb = min(cfg.curvature_sample_budget, nc) if cfg.curvature_sample_budget else nc
    rand = lambda *shape: torch.rand(shape, generator=generator)  # noqa: E731
    draws = TrainDraws(
        ray_indices=draw_ray_indices(reel, R, generator),
        fg_start=rand(R, 1),
        imp_jitter=((rand(R_imp, n) * 2.0 - 1.0) * mov, (rand(R_imp, n) * 2.0 - 1.0) * mov),
        bg_rand=rand(R, cfg.nr_samples_bg),
        curv_dirs=torch.randn((cb, 3), generator=generator),
        off_points=(rand(NR_OFFSURFACE_POINTS) * (2 * np.pi),
                    rand(NR_OFFSURFACE_POINTS) * 2.0 - 1.0, rand(NR_OFFSURFACE_POINTS)),
    )
    lod = _train_lod(cfg)
    if lod is not None and lod[1] > 0:
        draws.lod_scores = rand(R, cfg.samples_per_ray)
    return draws


def step_generators(seed: int, it: int):
    """(step, grid) generators of iteration ``it``: a function of (seed,
    it) only, so a resumed run draws what an uninterrupted one does."""
    return tuple(torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, it, k]).generate_state(1, np.uint64)[0] >> 1))
        for k in (0, 1))


# ---------------------------------------------------------------------------
# Rendering a ray batch (run_net)
# ---------------------------------------------------------------------------

def _pad_one(a, fill=0.0):
    return torch.cat([a, torch.full((1,) + a.shape[1:], fill, dtype=a.dtype,
                                    device=a.device)], 0)


def _compact_idx(flat_mask, budget: int):
    """First ``budget`` valid flat indices (row-major: whole rays first, then
    a valid prefix of the next ray) and their validity; unused slots hold M
    (kernel H0 on the card)."""
    M = flat_mask.shape[0]
    idx, _ = nonzero_static(flat_mask, budget, fill_value=M)
    return idx, idx < M


def _take_rays(samples: RaySamples, ray_idx, *extra):
    """Gather the bucket's rays ``ray_idx`` [B] out of a sample batch, with
    per-ray ``extra`` arrays (t_exit, image ids; None passes through), in
    one launch of kernel H1. Fill ids (== R) land on an all-invalid pad ray
    (mask false, zeros), so overflow and fill slots look like miss rays
    downstream. -> (bucket samples, *bucket extras)."""
    fields = ("origins", "dirs", "z", "dt", "mask", "ray_fixed_dt", "sdf", "pos_4d")
    names = [f for f in fields if getattr(samples, f) is not None]
    arrays = [getattr(samples, f) for f in names] + [e for e in extra if e is not None]
    outs = iter(take_rows(arrays, ray_idx))
    bucket = dataclasses.replace(samples, **{f: next(outs) for f in names})
    return (bucket, *(next(outs) if e is not None else None for e in extra))


def _hit_bucket(samples: RaySamples, t_exit, img_indices, cfg: PermutoSDFTrainConfig,
                lod_scores=None):
    """Hit-ray compaction: the rays with a valid sample listed into a
    bucket of ``_hit_ray_budget`` rays (kernel H0) and gathered with their
    t_exit, image ids and LOD scores (kernel H1). The last hit rays drop for
    this step when they overflow the bucket. -> (bucket samples, hit) with
    hit = dict(ray_idx, nr_hit_rays, t_exit, img_indices, lod_scores)."""
    R0 = samples.nr_rays
    valid_rays = samples.valid_rays()
    ray_idx, _ = _compact_idx(valid_rays, _hit_ray_budget(R0, cfg.hit_ray_frac))
    bucket, t_exit_b, img_b, scores_b = _take_rays(samples, ray_idx, t_exit, img_indices,
                                                   lod_scores)
    return bucket, {"ray_idx": ray_idx, "nr_hit_rays": valid_rays.sum(), "t_exit": t_exit_b,
                    "img_indices": img_b, "lod_scores": scores_b}


def _masked_sdf_value(params_sdf, pts_flat, flat_mask, iter_nr, sdf_cfg, budget,
                      max_levels=None):
    """sdf at the valid flat positions, at most ``budget`` of them; the
    others report far from the surface (+1e3)."""
    M = pts_flat.shape[0]
    if budget is None or budget >= M:
        return sdf_apply(params_sdf, pts_flat, iter_nr, sdf_cfg, max_levels=max_levels)[0]
    idx, _ = _compact_idx(flat_mask, budget)
    sdf_c = sdf_apply(params_sdf, _pad_one(pts_flat)[idx], iter_nr, sdf_cfg,
                      max_levels=max_levels)[0].reshape(-1)
    out = torch.full((M + 1,), 1e3, dtype=pts_flat.dtype, device=pts_flat.device)
    out[idx] = sdf_c
    return out[:M][:, None]


@torch.no_grad()
def _create_fg_samples(params, grid, origins, dirs, t_entry, t_exit,
                       iter_nr_anneal, cfg: PermutoSDFTrainConfig, draws=None,
                       img_indices=None):
    """Occupancy sampling (kernel C; without the grid, or with
    ``use_occupancy_grid=False``, uniform sampling, kernel C2) + importance
    sampling (constants for the losses, as JAX's stop_gradient makes them).
    ``draws`` None: no jitter. Returns
    (samples, hit): with early hit-ray compaction (``hit_ray_frac`` < 1 and
    ``hit_ray_compact_early``) the rays are compacted after the occupancy
    sampler, the importance stage runs on the bucket, and ``hit`` is the
    dict of :func:`_hit_bucket`; else ``hit`` is None."""
    start = draws.fg_start if draws is not None else None
    if cfg.use_occupancy_grid and grid is not None:
        samples = og.compute_samples_in_occupied_regions(
            cfg.grid, grid, origins, dirs, t_entry, t_exit,
            cfg.min_dist_between_samples, cfg.max_nr_samples_per_ray, start=start)
    else:
        samples = compute_samples_fg(origins, dirs, t_entry, t_exit,
                                     cfg.min_dist_between_samples, cfg.max_nr_samples_per_ray,
                                     start=start)
    hit = None
    if _hit_compaction(cfg) and cfg.hit_ray_compact_early:
        samples, hit = _hit_bucket(samples, t_exit, img_indices, cfg,
                                   draws.lod_scores if draws is not None else None)
        t_exit = hit["t_exit"]
    if cfg.do_importance_sampling:
        def sdf_fn(pts, flat_mask):
            return _masked_sdf_value(params["sdf"], pts, flat_mask, iter_nr_anneal,
                                     cfg.sdf_model, cfg.render_sample_budget,
                                     max_levels=cfg.imp_sampling_max_levels)

        samples = importance_sampling_sdf_model(
            sdf_fn, samples, t_exit, cfg.nr_samples_imp_sampling,
            jitter=draws.imp_jitter if draws is not None else None,
            carry_sdf=_train_lod(cfg) is not None)
    return samples, hit


def run_net(params, grid, origins, dirs, iter_nr_anneal, cos_anneal_ratio,
            forced_variance, cfg: PermutoSDFTrainConfig, draws: Optional[TrainDraws] = None,
            img_indices=None, fg_samples=None):
    """Render a ray batch. Returns (pred_rgb [R,3], pred_normals [R,3],
    weights_sum [R,1], extras) with ``extras`` holding the fg ``samples``,
    their ``weights``, ``compact`` (the per-sample pos, sdf, grads, valid
    the losses read), ``inv_s``, ``does_intersect`` and the sample counts.

    ``draws`` carries the training jitter (None: the eval render);
    ``img_indices [R]`` switch on the colour calibration; ``fg_samples``
    replaces the sampling stage with given samples (with ``hit_ray_frac``
    they are then compacted late, after sampling). With ``hit_ray_frac`` the
    fg samples and ``compact`` are the hit-ray bucket's. ``grid`` None (or
    ``use_occupancy_grid=False``) samples without the grid."""
    _, t_entry, _, t_exit, does_intersect = BOUND.ray_intersection(origins, dirs)
    samples, hit = fg_samples, None
    if samples is None:
        samples, hit = _create_fg_samples(params, grid, origins, dirs, t_entry, t_exit,
                                          iter_nr_anneal, cfg, draws, img_indices)
    out = render_samples(params, samples, t_exit, iter_nr_anneal, cos_anneal_ratio,
                         forced_variance, cfg, img_indices=img_indices,
                         bg_rand=draws.bg_rand if draws is not None else None, hit=hit,
                         rays=(origins, dirs),
                         lod_scores=draws.lod_scores if draws is not None else None)
    out[3]["does_intersect"] = does_intersect
    return out


def render_samples(params, samples, t_exit, iter_nr_anneal, cos_anneal_ratio,
                   forced_variance, cfg: PermutoSDFTrainConfig, img_indices=None,
                   bg_rand=None, hit=None, rays=None, lod_scores=None):
    """The part of :func:`run_net` after the fg samples are placed: the
    fields, the NeuS weights and the background. Same returns. ``hit`` (from
    :func:`_hit_bucket`) says the samples are an early-compacted bucket of
    the rays ``rays = (origins, dirs)`` (default: the samples' own); else
    with ``hit_ray_frac`` the rays are compacted here (late). Either way the
    bucket's per-ray results go back to every ray (kernel H2) and the
    background runs on every ray.

    The train-time LOD (``train_lod_top_k`` with samples that carry their
    proxy sdf) evaluates the fields on each ray's fine set only: kernel L
    selects it from the carried sdf (``lod_scores`` [R0, S] pick the random
    extras, taken into the bucket with the rays), kernel D2 renders the
    mixed chain, and ``compact`` holds the fine set."""
    origins, dirs = rays if rays is not None else (samples.origins, samples.dirs)
    R0 = origins.shape[0]
    img_fg = img_indices
    if hit is not None:
        # early compaction: the valid count the rebalancer reads, scaled up by
        # the (rare) overflow of the bucket
        kept = torch.clamp((hit["ray_idx"] < R0).sum(), min=1).to(torch.float32)
        scale = hit["nr_hit_rays"].to(torch.float32) / kept
        nr_samples_total = (samples.mask.sum().to(torch.float32) * scale).to(torch.int32)
        nr_hit_rays = hit["nr_hit_rays"]
    else:
        nr_samples_total = samples.mask.sum()
        nr_hit_rays = samples.valid_rays().sum()
        if _hit_compaction(cfg):  # late: after sampling, exact against the dense path
            samples, hit = _hit_bucket(samples, t_exit, img_indices, cfg, lod_scores)
    if hit is not None:
        img_fg = hit["img_indices"]
        lod_scores = hit["lod_scores"]
    R, S = samples.mask.shape
    M = R * S
    budget = min(M, cfg.render_sample_budget) if cfg.render_sample_budget else M
    inv_s = vr.variance_inv_s(params["variance"], forced_variance)
    idx = None
    lod = _train_lod(cfg, S) if samples.sdf is not None else None
    if lod is not None:
        # the fine set: the K slots of largest weight of the carried sdf and
        # E random others per ray (kernel L)
        cos_fd, sel = vr.train_lod_select(samples, samples.sdf, inv_s, cos_anneal_ratio,
                                          lod_scores if lod[1] > 0 else None, *lod)
        fine = (torch.arange(R, device=sel.device)[:, None] * S + sel).reshape(-1)
        valid_c = samples.flat_mask()[fine]
        pos_c = samples.flat_positions()[fine]
        dirs_c = samples.flat_dirs()[fine]
    elif budget < M:
        # the first `budget` valid samples; the overflow leaves the batch
        idx, valid_c = _compact_idx(samples.flat_mask(), budget)
        kept = torch.zeros((M + 1,), dtype=torch.bool, device=idx.device)
        kept[idx] = valid_c
        samples = dataclasses.replace(samples, mask=kept[:M].reshape(R, S) & samples.mask)
        pos_c = _pad_one(samples.flat_positions())[idx]
        dirs_c = _pad_one(samples.flat_dirs())[idx]
    else:
        valid_c = samples.flat_mask()
        pos_c = samples.flat_positions()
        dirs_c = samples.flat_dirs()
    sdf_c, grads_c, geom_c = sdf_with_gradient(params["sdf"], pos_c, iter_nr_anneal,
                                               cfg.sdf_model)
    cc = params.get("colorcal") if img_indices is not None else None
    per_sample_img = None
    if cc is not None:
        per_ray = sel.shape[1] if lod is not None else S
        per_sample_img = img_fg[:, None].expand(R, per_ray).reshape(-1)
        if idx is not None:
            per_sample_img = _pad_one(per_sample_img, 0)[idx]
    rgb_c = rgb_apply(params["rgb"], pos_c, dirs_c, grads_c, geom_c, iter_nr_anneal,
                      cfg.rgb_model, colorcal_params=cc, per_sample_img_indices=per_sample_img)
    compact = {"pos": pos_c, "sdf": sdf_c, "grads": grads_c, "valid": valid_c}
    if lod is not None:
        # the mixed chain (kernel D2): the fine set's sdf and analytic cos at
        # the selected valid slots, the carried sdf and cos_fd elsewhere
        weights, weights_sum, bg_T, pred_rgb, grad_int = vr.neus_render_mixed(
            samples, samples.sdf, cos_fd, sel, sdf_c, grads_c, rgb_c, inv_s, cos_anneal_ratio)
    else:
        sdf, sdf_gradients, rgb_flat = sdf_c, grads_c, rgb_c
        if idx is not None:
            vc = valid_c[:, None].to(sdf_c.dtype)

            def scatter(x):
                return torch.zeros((M + 1, x.shape[1]), dtype=x.dtype,
                                   device=x.device).index_put((idx,), x * vc)[:M]

            sdf, sdf_gradients, rgb_flat = scatter(sdf_c), scatter(grads_c), scatter(rgb_c)
        weights, weights_sum, bg_T, pred_rgb, grad_int = vr.neus_render(
            samples, sdf, sdf_gradients, rgb_flat, inv_s, cos_anneal_ratio)
    pred_normals = grad_int / (torch.linalg.norm(grad_int, dim=-1, keepdim=True) + 1e-12)
    if hit is not None:
        # the bucket's per-ray results back to every ray (kernel H2): miss
        # rays get exactly what the dense path computes for them
        pred_rgb, pred_normals, weights_sum, bg_T = scatter_rows(
            [pred_rgb, pred_normals, weights_sum, bg_T], hit["ray_idx"], R0,
            (0.0, 0.0, 0.0, 1.0))
    if not cfg.with_mask:
        with torch.no_grad():
            bg = compute_samples_bg(origins, dirs, t_exit, cfg.nr_samples_bg,
                                    BOUND.radius, BOUND.center, rand=bg_rand)
        img_bg = (img_indices[:, None].expand(R0, cfg.nr_samples_bg).reshape(-1)
                  if cc is not None else None)
        rgb_bg, dens_bg = nerf_hash_apply(params["bg"], bg.pos_4d.reshape(-1, 4),
                                          bg.flat_dirs(), iter_nr_anneal, cfg.bg_model,
                                          colorcal_params=cc, per_sample_img_indices=img_bg)
        pred_rgb_bg = vr.nerf_render(bg, dens_bg, rgb_bg)[3]
        pred_rgb = pred_rgb + bg_T[:, None] * pred_rgb_bg
    extras = {"samples": samples, "weights": weights, "compact": compact, "inv_s": inv_s,
              "nr_samples_total": nr_samples_total,
              "nr_samples_rendered": samples.mask.sum(), "nr_hit_rays": nr_hit_rays}
    return pred_rgb, pred_normals, weights_sum, extras


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

def _with_grad(params):
    """The same tensors (shared storage) as leaves that record gradients."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def _grads_of(loss, p):
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(grads)
    return tree_map(lambda _: next(it), p)


def sphere_init_step(params, opt_state, draws, iter_nr, cfg: PermutoSDFTrainConfig,
                     optimizer):
    """Fit the SDF to a sphere of radius ``sphere_init_radius``.
    ``draws`` is a generator or the (phi, cos theta, u) of the points (see
    ``Sphere.rand_points_inside``). Returns (params, opt_state, loss)."""
    device = params["sdf"]["encoding"]["lattice_values"].device
    gen = draws if isinstance(draws, torch.Generator) else None
    pts = BOUND.rand_points_inside(cfg.sphere_init_points, generator=gen,
                                   draws=None if gen is not None else draws, device=device)
    p = _with_grad(params)
    sdf, grads, _ = sdf_with_gradient(p["sdf"], pts, iter_nr, cfg.sdf_model)
    loss, _, _ = sdf_loss_sphere(pts, sdf, grads, cfg.sphere_init_radius, (0.0, 0.0, 0.0))
    g = _grads_of(loss, p)
    params, opt_state = optimizer.update(g, opt_state, params, lr_schedule(cfg, iter_nr))
    return params, opt_state, loss.detach()


def compute_loss_and_grads(params, grid, reel: TensorReel, draws, iter_nr,
                           cfg: PermutoSDFTrainConfig, fg_samples=None):
    """Loss and the gradient of every leaf for one ray batch. ``draws`` is a
    :class:`TrainDraws` or a generator to make one from; ``fg_samples``
    replaces the sampling stage. Returns (loss, aux, grads) with ``grads``
    a tree like ``params`` (None where a leaf gets no gradient)."""
    device = params["sdf"]["encoding"]["lattice_values"].device
    if isinstance(draws, torch.Generator):
        draws = draw_train_step(draws, cfg, reel)
    draws = draws.to(device)
    it_anneal = iter_nr - cfg.nr_iter_sphere_fit
    cos_anneal_ratio = _map_range_f32(it_anneal, 0.0, cfg.forced_variance_finish_iter, 0.0, 1.0)
    forced_variance = _map_range_f32(it_anneal, 0.0, cfg.forced_variance_finish_iter, 0.3,
                                     cfg.forced_variance_finish)
    origins, dirs, gt_rgb, gt_mask, img_indices = random_rays_from_reel(
        reel, cfg.nr_rays, indices=draws.ray_indices, apply_mask=cfg.with_mask)
    global_weight_curvature = _map_range_f32(it_anneal, cfg.iter_start_reduce_curv,
                                             cfg.iter_finish_reduce_curv, 1.0, 0.0)
    eik_w = (cfg.eikonal_weight_reduced if it_anneal >= cfg.iter_start_reduce_curv
             else cfg.eikonal_weight)

    p = _with_grad(params)
    pred_rgb, _, weights_sum, ex = run_net(
        p, grid, origins, dirs, it_anneal, cos_anneal_ratio, forced_variance, cfg,
        draws=draws, img_indices=img_indices, fg_samples=fg_samples)
    loss_rgb = torch.mean(torch.abs(gt_rgb - pred_rgb) * ex["does_intersect"])
    loss = loss_rgb
    valid_c, grads_c = ex["compact"]["valid"], ex["compact"]["grads"]
    nvalid = torch.clamp(valid_c.sum().to(torch.float32), min=1.0)
    zero = torch.zeros((), device=device)
    loss_eik = zero
    if cfg.enable_eikonal:
        gnorm = torch.linalg.norm(grads_c, dim=-1)
        loss_eik = torch.sum(torch.where(valid_c, (gnorm - 1.0) ** 2, zero)) / nvalid
        loss = loss + loss_eik * eik_w
    loss_curv = zero
    if cfg.enable_curvature:
        # the prefix of the compacted batch (a random subset of the rays)
        cb = min(draws.curv_dirs.shape[0], valid_c.shape[0])
        pos_cv = ex["compact"]["pos"][:cb]
        valid_cv = valid_c[:cb]
        _, curvature = sdf_curvature_from_gradient(p["sdf"], draws.curv_dirs[:cb], pos_cv,
                                                   grads_c[:cb], it_anneal, cfg.sdf_model)
        nvalid_cv = torch.clamp(valid_cv.sum().to(torch.float32), min=1.0)
        loss_curv = torch.sum(torch.where(valid_cv[:, None], curvature, zero)) / nvalid_cv
        loss = loss + loss_curv * cfg.curvature_weight * global_weight_curvature
    if cfg.use_occupancy_grid and cfg.enable_offsurface:
        off_pts = BOUND.rand_points_inside(NR_OFFSURFACE_POINTS, draws=draws.off_points,
                                           device=device)
        sdf_rand, _ = sdf_apply(p["sdf"], off_pts, it_anneal, cfg.sdf_model)
        loss = loss + torch.mean(torch.exp(-1e2 * torch.abs(sdf_rand))) * cfg.offsurface_weight
    if cfg.enable_lipshitz and it_anneal >= cfg.iter_start_reduce_curv:
        loss = loss + lipshitz_bound_full(p["rgb"]["mlp"]) * cfg.lipshitz_weight
    if cfg.with_mask:
        ws = torch.clamp(weights_sum, 1e-3, 1.0 - 1e-3)
        bce = -(gt_mask * torch.log(ws) + (1 - gt_mask) * torch.log(1 - ws))
        loss = loss + torch.mean(bce) * cfg.mask_weight
    grads = _grads_of(loss, p)
    aux = {"loss_rgb": loss_rgb.detach(), "loss_eikonal": loss_eik.detach(),
           "loss_curvature": loss_curv.detach(), "inv_s": ex["inv_s"],
           "nr_samples": ex["nr_samples_total"],
           "nr_samples_rendered": ex["nr_samples_rendered"],
           "nr_hit_rays": ex["nr_hit_rays"], "samples": ex["samples"],
           "nr_rays": cfg.nr_rays, "hit_ray_frac": cfg.hit_ray_frac,
           "train_lod_top_k": cfg.train_lod_top_k, "table_grad_parity": cfg.table_grad_parity}
    return loss.detach(), aux, grads


def apply_updates(params, opt_state, grads, iter_nr, cfg: PermutoSDFTrainConfig, optimizer):
    """The Adam step at the scheduled lr, then the per-group weight decay
    (in place)."""
    lr_now = lr_schedule(cfg, iter_nr)
    params, opt_state = optimizer.update(grads, opt_state, params, lr_now)
    params = _apply_weight_decay(params, lr_now, iter_nr, cfg)
    return params, opt_state


def train_step(params, opt_state, grid, reel: TensorReel, draws, iter_nr,
               cfg: PermutoSDFTrainConfig, optimizer):
    """One training iteration -> (params, opt_state, loss, aux)."""
    loss, aux, grads = compute_loss_and_grads(params, grid, reel, draws, iter_nr, cfg)
    params, opt_state = apply_updates(params, opt_state, grads, iter_nr, cfg, optimizer)
    return params, opt_state, loss, aux


def occupancy_update(params, grid, draws, iter_nr_anneal, inv_s,
                     cfg: PermutoSDFTrainConfig):
    """SDF-based occupancy refresh of ``grid_nr_random_samples`` voxels
    around a proxy SDF of ``grid_update_max_levels`` levels, in place: on
    the card one launch of kernel If for the flagship SDF (entries 1 and 2
    of kernel I around ``sdf_apply`` for an SDF the fused kernels do not
    evaluate). ``draws`` is a generator or the in-voxel jitter [n, 3] in
    [-0.5, 0.5)."""
    device = grid.values.device
    n = cfg.grid_nr_random_samples
    jitter = (torch.rand((n, 3), generator=draws) - 0.5
              if isinstance(draws, torch.Generator) else draws)
    update_idx = int(iter_nr_anneal) // cfg.grid_update_every
    max_levels = cfg.grid_update_max_levels
    if max_levels is None:
        max_levels = cfg.imp_sampling_max_levels
    return og.refresh_with_sdf(cfg.grid, grid, SDFEval(cfg.sdf_model, max_levels),
                               (params["sdf"], iter_nr_anneal), n, update_idx,
                               jitter.to(device), inv_s, cfg.grid_occupancy_thresh)


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

def _c2f_active_levels(it_anneal: int, cfg: PermutoSDFTrainConfig):
    """SDF levels with a nonzero c2f window weight at this iteration, rounded
    up to a multiple of 4; None once every level is open."""
    if it_anneal >= cfg.sdf_nr_iters_for_c2f:
        return None
    t = 0.3 + 0.7 * it_anneal / max(cfg.sdf_nr_iters_for_c2f, 1)
    act = int(np.ceil(t * cfg.nr_levels))
    act = min(cfg.nr_levels, -(-act // 4) * 4)
    return None if act >= cfg.nr_levels else act


def _ray_bucket(n: int, lo: int = 128, hi: int = 4096, current: Optional[int] = None) -> int:
    """Snap a ray count up to the {2^k, 3 * 2^(k-1)} ladder; stay on the
    current rung while ``n`` is within +-20% of it."""
    if current is not None and 0.8 * current <= n <= 1.2 * current:
        return current
    b = lo
    while b < n and b < hi:
        b = (b * 3 // 2) if (b & (b - 1)) == 0 else (b * 4 // 3)
    return min(b, hi)


_HIT_FRAC_LADDER = (0.25, 0.375, 0.5, 0.625, 0.75, 1.0)


def _hit_frac_bucket(hit_frac: float, current: float) -> float:
    """The hit-ray bucket fraction from the ladder for a measured hit
    fraction: the smallest rung with >= 1.3x headroom, moving down only
    to a rung with >= 1.45x headroom (hysteresis). 1.0 turns the compaction
    off (every ray hits a dense grid)."""
    want = min(1.0, hit_frac * 1.3)
    up = next((f for f in _HIT_FRAC_LADDER if f >= want), 1.0)
    if up > current:
        return up
    down = next((f for f in _HIT_FRAC_LADDER if f >= min(1.0, hit_frac * 1.45)), 1.0)
    return down if down < current else current


def train(reel: TensorReel, cfg: PermutoSDFTrainConfig, nr_iters: Optional[int] = None,
          seed: int = 0, log_every: int = 1000, checkpoint_path: Optional[str] = None,
          experiment_name: str = "permuto_sdf", save_every: int = 10000, callbacks=None,
          dynamic_nr_rays: bool = True, resume_from: Optional[str] = None,
          data_parallel: Optional[bool] = None, device=None):
    """Train from scratch or from ``resume_from`` (a ``<...>/<iter>/models``
    dir holding a train state). ``dynamic_nr_rays`` rescales the ray count
    every 50 iterations toward the target of ``nr_rays * samples_per_ray``
    valid samples, and with ``hit_ray_frac`` set it moves the hit-ray
    bucket along :data:`_HIT_FRAC_LADDER` after the measured hit fraction.

    The approximating levers (``train_lod_top_k``, ``table_grad_alternate``)
    are off until ``lever_start_iter`` (counted after sphere init; None:
    0 with ``with_mask``, else ``forced_variance_finish_iter``), unless the
    run starts past it; with ``table_grad_alternate`` each step's cfg gets
    ``table_grad_parity = it % table_grad_period`` (the grid refresh's does
    not). With ``use_occupancy_grid=False`` there is no grid (None), no
    refresh and no offsurface loss. Single device (None means the GPU); the
    reel is moved there. Returns (params, grid, history of (it, loss,
    loss_rgb))."""
    if data_parallel:
        raise NotImplementedError("data_parallel: data parallelism (Queue 1 item 8) is "
                                  "not ported yet")
    device = resolve_device(device)
    reel = reel.to(device)
    nr_iters = nr_iters or cfg.iter_finish_training
    target_nr_samples = cfg.nr_rays * (cfg.max_nr_samples_per_ray
                                       + 2 * cfg.nr_samples_imp_sampling)
    optimizer = make_optimizer(cfg)
    start_iter = 0
    last_inv_s = float(np.exp(np.float32(0.3 * 10.0)))
    if resume_from:
        st = ckpt.load_train_state(resume_from)
        params = params_from_jax(st["params"], device)
        opt_state = opt_state_from_jax(st["opt_state"], device)
        grid = None
        if st["grid"] is not None:
            g = params_from_jax(st["grid"], device)
            grid = og.OccupancyGridState(values=g["values"], occupancy=g["occupancy"].bool())
        start_iter = int(st["iter"]) + 1
        last_inv_s = float(st["last_inv_s"])
        if dynamic_nr_rays and int(st["nr_rays"]) != cfg.nr_rays:
            cfg = dataclasses.replace(cfg, nr_rays=int(st["nr_rays"]))
        print(f"resumed from {resume_from} at iter {start_iter}")
    else:
        params = init_params(seed, cfg, reel.nr_images, device)
        opt_state = optimizer.init(params)
        grid = (og.make_occupancy_grid(cfg.grid, device=device) if cfg.use_occupancy_grid
                else None)

    # the lever gate: the approximating levers run from lever_start_iter on
    gate_iter = cfg.lever_start_iter
    if gate_iter is None:
        gate_iter = 0 if cfg.with_mask else cfg.forced_variance_finish_iter
    cfg = dataclasses.replace(cfg, lever_start_iter=gate_iter)
    gated_levers = None
    if (cfg.lever_start_iter and start_iter - cfg.nr_iter_sphere_fit < cfg.lever_start_iter
            and (cfg.train_lod_top_k is not None or cfg.table_grad_alternate)):
        gated_levers = dict(train_lod_top_k=cfg.train_lod_top_k,
                            table_grad_alternate=cfg.table_grad_alternate)
        cfg = dataclasses.replace(cfg, train_lod_top_k=None, table_grad_alternate=False)

    history = []
    loss, aux = None, {}
    t0 = time.perf_counter()
    for it in range(start_iter, nr_iters):
        g_step, g_grid = step_generators(seed, it)
        if it < cfg.nr_iter_sphere_fit:
            params, opt_state, loss = sphere_init_step(params, opt_state, g_step, it, cfg,
                                                       optimizer)
            aux = {}
        else:
            it_anneal = it - cfg.nr_iter_sphere_fit
            if gated_levers is not None and it_anneal >= cfg.lever_start_iter:
                cfg = dataclasses.replace(cfg, **gated_levers)
                gated_levers = None
            if cfg.enable_curvature and it_anneal >= cfg.iter_finish_reduce_curv:
                cfg = dataclasses.replace(cfg, enable_curvature=False)
            if cfg.c2f_level_skip:
                act = _c2f_active_levels(it_anneal, cfg)
                if act != cfg.sdf_active_levels:
                    cfg = dataclasses.replace(cfg, sdf_active_levels=act)
            if cfg.use_occupancy_grid and it % cfg.grid_update_every == 0:
                grid = occupancy_update(params, grid, g_grid, it_anneal, last_inv_s, cfg)
            step_cfg = cfg
            if cfg.table_grad_alternate:
                step_cfg = dataclasses.replace(cfg, table_grad_parity=it % cfg.table_grad_period)
            params, opt_state, loss, aux = train_step(params, opt_state, grid, reel, g_step,
                                                      it, step_cfg, optimizer)
            last_inv_s = aux["inv_s"]
            if dynamic_nr_rays and it % 50 == 0:
                cur = max(float(aux["nr_samples"]), 1.0)
                prev_rays = cfg.nr_rays  # the batch aux was measured on
                want = int(cfg.nr_rays * target_nr_samples / cur)
                bucket = _ray_bucket(want, current=cfg.nr_rays)
                if bucket != cfg.nr_rays:
                    cfg = dataclasses.replace(cfg, nr_rays=bucket)
                if cfg.hit_ray_frac is not None:
                    hf = float(aux["nr_hit_rays"]) / max(prev_rays, 1)
                    frac = _hit_frac_bucket(hf, cfg.hit_ray_frac)
                    if frac != cfg.hit_ray_frac:
                        cfg = dataclasses.replace(cfg, hit_ray_frac=frac)
        if it % log_every == 0 or it == nr_iters - 1:
            lv = float(loss)
            history.append((it, lv, float(aux["loss_rgb"]) if aux else None))
            extra = (f"  rgb {float(aux['loss_rgb']):.4f} eik {float(aux['loss_eikonal']):.4f}"
                     if aux else "  (sphere init)")
            print(f"iter {it:6d}  loss {lv:.6f}{extra}  ({time.perf_counter() - t0:.1f}s)")
            for cb in callbacks or ():
                cb(it, loss, aux, params, grid)
        if checkpoint_path and save_every and it > 0 and it % save_every == 0:
            _save(checkpoint_path, experiment_name, it, params, grid, opt_state=opt_state,
                  cfg=cfg, last_inv_s=last_inv_s)
    if checkpoint_path:
        _save(checkpoint_path, experiment_name, nr_iters, params, grid, opt_state=opt_state,
              cfg=cfg, last_inv_s=last_inv_s, final_iter=nr_iters - 1)
    return params, grid, history


def _save(checkpoint_path, experiment_name, it, params, grid, opt_state=None, cfg=None,
          last_inv_s=None, final_iter=None):
    """The JAX trainer's checkpoint: one ``.npz`` per model, the grid and,
    with ``opt_state``, the train state ``--resume`` reads."""
    for name, key in (("sdf_model", "sdf"), ("rgb_model", "rgb"),
                      ("nerf_hash_model_bg", "bg"), ("variance", "variance"),
                      ("colorcal_model", "colorcal")):
        if key in params:
            ckpt.save_model(checkpoint_path, experiment_name, it, name, params[key])
    if grid is not None:
        ckpt.save_model(checkpoint_path, experiment_name, it, "occupancy_grid", grid)
    if opt_state is not None:
        ckpt.save_train_state(checkpoint_path, experiment_name, it, {
            "params": params, "opt_state": opt_state, "grid": grid,
            "iter": np.asarray(final_iter if final_iter is not None else it),
            "last_inv_s": np.float32(last_inv_s if last_inv_s is not None else 0.0),
            "nr_rays": np.asarray(cfg.nr_rays if cfg is not None else 0),
        })


# ---------------------------------------------------------------------------
# Eval rendering
# ---------------------------------------------------------------------------

def _check_on(params, grid, device, what: str):
    table = params["sdf"]["encoding"]["lattice_values"]
    if table.device.type != device.type or (grid is not None
                                           and grid.occupancy.device.type != device.type):
        raise ValueError(f"{what}: params and grid must be on {device}")


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


def _lod_coarse_select(params, grid, origins, dirs, iter_nr_anneal, cos_anneal_ratio,
                       forced_variance, cfg: PermutoSDFTrainConfig, coarse_levels: int,
                       top_k: int):
    """Stage 1 of the LOD eval render: the samples (kernels C, E1, E2, no
    jitter), their sdf and gradient on the ``coarse_levels`` coarsest levels
    (kernels A, B), their NeuS weights (kernel D) and the ``top_k`` heaviest
    samples of each ray. Returns a dict of ray-leading tensors."""
    _, t_entry, _, t_exit, _ = BOUND.ray_intersection(origins, dirs)
    samples, _ = _create_fg_samples(params, grid, origins, dirs, t_entry, t_exit,
                                    iter_nr_anneal, cfg)
    R, S = samples.mask.shape
    pos = samples.flat_positions()
    K = min(top_k, S)
    sdf_c, grads_c, _ = sdf_with_gradient(params["sdf"], pos, iter_nr_anneal, cfg.sdf_model,
                                          max_levels=coarse_levels)
    inv_s = vr.variance_inv_s(params["variance"], forced_variance)
    # kernel D's rgb slot takes any [N, 3] here: only the weights are read
    w_c = vr.neus_render(samples, sdf_c, grads_c, grads_c, inv_s, cos_anneal_ratio)[0]
    # lax.top_k's order: the largest first, ties by the lower index (a stable
    # descending sort; invalid slots rank at -1)
    ik = torch.sort(torch.where(samples.mask, w_c, torch.full_like(w_c, -1.0)), dim=1,
                    descending=True, stable=True).indices[:, :K]
    flat_ik = (torch.arange(R, device=ik.device)[:, None] * S + ik).reshape(-1)
    return {"samples": samples, "sdf_c": sdf_c.reshape(R, S),
            "grads_c": grads_c.reshape(R, S, 3), "ik": ik,
            "sel_mask": samples.flat_mask()[flat_ik].reshape(R, K),
            "pos_k": pos[flat_ik].reshape(R, K, 3),
            "dirs_k": samples.flat_dirs()[flat_ik].reshape(R, K, 3), "t_exit": t_exit}


def _lod_fine_render(params, mid, origins, dirs, iter_nr_anneal, cos_anneal_ratio,
                     forced_variance, cfg: PermutoSDFTrainConfig):
    """Stage 2 of the LOD eval render: the full-width SDF gradient and rgb
    on the selected samples only (kernels A, B), the weights of the mixed
    dense arrays (full-width values at the selected slots, coarse ones
    elsewhere; kernel D), the selected samples' integration and the
    background (kernels A and D). -> (rgb, normals, weights_sum)."""
    samples = mid["samples"]
    R, S = samples.mask.shape
    K = mid["ik"].shape[1]
    flat_ik = (torch.arange(R, device=mid["ik"].device)[:, None] * S + mid["ik"]).reshape(-1)
    sel_mask = mid["sel_mask"].reshape(-1)
    pos_k, dirs_k = mid["pos_k"].reshape(-1, 3), mid["dirs_k"].reshape(-1, 3)
    inv_s = vr.variance_inv_s(params["variance"], forced_variance)
    sdf_k, grads_k, geom_k = sdf_with_gradient(params["sdf"], pos_k, iter_nr_anneal,
                                               cfg.sdf_model)
    rgb_k = rgb_apply(params["rgb"], pos_k, dirs_k, grads_k, geom_k, iter_nr_anneal,
                      cfg.rgb_model)
    sdf_m = mid["sdf_c"].reshape(-1).clone()
    sdf_m[flat_ik] = torch.where(sel_mask, sdf_k.reshape(-1), sdf_m[flat_ik])
    grads_m = mid["grads_c"].reshape(-1, 3).clone()
    grads_m[flat_ik] = torch.where(sel_mask[:, None], grads_k, grads_m[flat_ik])
    w_m, weights_sum, bg_T = vr.neus_render(samples, sdf_m, grads_m, grads_m, inv_s,
                                            cos_anneal_ratio)[:3]
    wk = torch.where(sel_mask, w_m.reshape(-1)[flat_ik], 0.0).reshape(R, K, 1)
    pred_rgb = torch.sum(wk * rgb_k.reshape(R, K, 3), dim=1)
    grad_int = torch.sum(wk * grads_k.reshape(R, K, 3), dim=1)
    pred_normals = grad_int / (torch.linalg.norm(grad_int, dim=-1, keepdim=True) + 1e-12)
    if not cfg.with_mask:
        bg = compute_samples_bg(origins, dirs, mid["t_exit"], cfg.nr_samples_bg,
                                BOUND.radius, BOUND.center)
        rgb_bg, dens_bg = nerf_hash_apply(params["bg"], bg.pos_4d.reshape(-1, 4),
                                          bg.flat_dirs(), iter_nr_anneal, cfg.bg_model)
        pred_rgb = pred_rgb + bg_T[:, None] * vr.nerf_render(bg, dens_bg, rgb_bg)[3]
    return pred_rgb, pred_normals, weights_sum


@torch.no_grad()
def render_rays_eval_lod(params, grid, origins, dirs, iter_nr_anneal, cos_anneal_ratio,
                         forced_variance, cfg: PermutoSDFTrainConfig, coarse_levels: int = 12,
                         top_k: int = 32):
    """LOD eval render of one ray batch: the ``top_k`` samples of each ray
    that carry the most NeuS weight on the ``coarse_levels`` coarsest SDF
    levels get the full-width fields -> (rgb, normals, weights_sum). The
    training-batch contracts are stripped (:func:`_eval_cfg`)."""
    cfg = _eval_cfg(cfg)
    mid = _lod_coarse_select(params, grid, origins, dirs, iter_nr_anneal, cos_anneal_ratio,
                             forced_variance, cfg, coarse_levels, top_k)
    return _lod_fine_render(params, mid, origins, dirs, iter_nr_anneal, cos_anneal_ratio,
                            forced_variance, cfg)


@torch.no_grad()
def render_image(params, grid, K, tf_world_cam, width, height, iter_nr_anneal,
                 cfg: PermutoSDFTrainConfig, forced_variance=0.8, chunk: int = 2048,
                 mesh=None, lod=False, device=None):
    """Volumetric render of one view, ``chunk`` rays at a time -> (rgb
    [H,W,3], normals [H,W,3], alpha [H,W,1]) tensors on ``device`` (None
    means the GPU; params and grid must already live there). Exact, or with
    ``lod`` the LOD render (:func:`render_rays_eval_lod`): ``True`` means
    ``(coarse_levels, top_k) = (12, 32)``, the interactive viewer's
    volumetric mode. Both renders strip the training-batch contracts
    (:func:`_eval_cfg`). A failing LOD render raises (JAX's fallback to the
    exact render works around an XLA:TPU compiler crash). ``grid`` None (or
    ``use_occupancy_grid=False``) samples without the grid."""
    if mesh is not None:
        raise NotImplementedError("multi-device rendering is not ported yet")
    device = resolve_device(device)
    _check_on(params, grid, device, "render_image")
    origins, dirs = rays_from_frame(K, tf_world_cam, width, height, device=device)
    n = origins.shape[0]
    pad = (-n) % chunk
    origins = torch.cat([origins, torch.zeros((pad, 3), device=device)], 0)
    pad_dirs = torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(pad, 3)
    dirs = torch.cat([dirs, pad_dirs], 0)
    if lod:
        cl, tk = lod if isinstance(lod, tuple) else (12, 32)
        render = functools.partial(render_rays_eval_lod, coarse_levels=cl, top_k=tk)
    else:
        render = render_rays_eval
    outs = [render(params, grid, origins[s:s + chunk], dirs[s:s + chunk], iter_nr_anneal,
                   1.0, forced_variance, cfg)
            for s in range(0, n + pad, chunk)]
    rgb, nrm, alpha = (torch.cat(parts, 0)[:n] for parts in zip(*outs))
    return (rgb.reshape(height, width, 3), nrm.reshape(height, width, 3),
            alpha.reshape(height, width, 1))


# ---------------------------------------------------------------------------
# Sphere-traced rendering (the interactive viewer's frame)
# ---------------------------------------------------------------------------

def _make_trace_lod_evals(cfg, ctx, lod_levels, lod_schedule):
    """The tracer's march, refine and per-round SDF evaluations for a LOD
    setting, each an :class:`SDFEval` (ctx = (params_sdf, iteration)), so
    the tracer's rounds take kernel J2f on the card -> (march_eval,
    refine_eval, refine_ctx, round_evals)."""
    full_eval = SDFEval(cfg.sdf_model, None)
    round_evals = ()
    if lod_schedule is not None:
        # explicit per-round LOD ramp (the last entry repeats); full-res refine
        march_eval = SDFEval(cfg.sdf_model, lod_schedule[-1])
        refine_eval, refine_ctx = full_eval, ctx
        round_evals = tuple(SDFEval(cfg.sdf_model, lv) for lv in lod_schedule)
    elif lod_levels is not None and lod_levels < cfg.nr_levels:
        march_eval = SDFEval(cfg.sdf_model, lod_levels)
        refine_eval, refine_ctx = full_eval, ctx
        # round 0 processes every bound-hitting ray: an even coarser LOD
        round_evals = (SDFEval(cfg.sdf_model, max(4, lod_levels // 2)),)
    else:
        march_eval, refine_eval, refine_ctx = full_eval, None, None
    return march_eval, refine_eval, refine_ctx, round_evals


def _lit_and_state(pos, converged, alive, grid, grid_cfg, cfg, bucket=None):
    """The shading gate: every alive ray whose final position is inside the
    bound and, with a grid, in occupied space; convergence is not
    required."""
    in_bounds = BOUND.check_point_inside_primitive(pos)[:, 0]
    if grid_cfg is not None:
        in_bounds = in_bounds & og.check_occupancy(grid_cfg, grid, pos)
    return alive & in_bounds


def _grid_cfg(cfg: PermutoSDFTrainConfig, grid):
    return cfg.grid if (cfg.use_occupancy_grid and grid is not None) else None


def _shade(params, pos, dirs, iter_nr_anneal, cfg: PermutoSDFTrainConfig, sdf_cfg=None):
    """The SDF gradient (of ``sdf_cfg``, default the full-resolution
    ``cfg.sdf_model``) and the RGB model at ``pos`` -> (rgb, unit normals)."""
    _, grads, geom = sdf_with_gradient(params["sdf"], pos, iter_nr_anneal,
                                       sdf_cfg or cfg.sdf_model)
    rgb = rgb_apply(params["rgb"], pos, dirs, grads, geom, iter_nr_anneal, cfg.rgb_model)
    return rgb, grads / (torch.linalg.norm(grads, dim=-1, keepdim=True) + 1e-12)


def _scatter_shaded(idx, R: int, *subs):
    """Bucket rows ``subs`` [B, 3] back to [R, 3] rows at ``idx`` (fill
    slots, == R, land on a dropped pad row)."""
    valid = (idx < R)[:, None].to(torch.float32)
    return tuple(torch.zeros((R + 1, 3), dtype=x.dtype, device=x.device)
                 .index_put((idx,), x * valid)[:R] for x in subs)


@torch.no_grad()
def render_rays_sphere_traced(params, grid, origins, dirs, iter_nr_anneal,
                              cfg: PermutoSDFTrainConfig, nr_sphere_traces: int = 15,
                              sdf_multiplier: float = 0.9, sdf_converged_tresh: float = 2e-4,
                              dist_field=None):
    """Sphere trace every ray to the surface (:func:`~permuto_sdf_tpu_torch.
    ops.sphere_trace.sphere_trace` of the SDF's ``SDFEval``: kernel C3, then
    one launch of J3f, the SDF evaluated inside it, with the grid's jumps),
    then shade one sample per ray with the RGB model; the weight is 1 where
    the ray is alive and its end lies inside the bound (and in occupied
    space), convergence not required -> (rgb [R,3], normals [R,3],
    weights [R,1])."""
    grid_cfg = _grid_cfg(cfg, grid)
    pos, _, converged, alive = sphere_trace(
        SDFEval(cfg.sdf_model), origins, dirs, BOUND, nr_sphere_traces, sdf_multiplier,
        sdf_converged_tresh, grid_cfg=grid_cfg, grid=grid, dist_field=dist_field,
        final_sdf=False,  # the shading re-evaluates the sdf
        ctx=(params["sdf"], iter_nr_anneal))
    weights = _lit_and_state(pos, converged, alive, grid, grid_cfg, cfg).to(torch.float32)[:, None]
    rgb, normals = _shade(params, pos, dirs, iter_nr_anneal, cfg)
    return rgb * weights, normals * weights, weights


@torch.no_grad()
def render_rays_sphere_traced_compacted(params, grid, origins, dirs, iter_nr_anneal,
                                        cfg: PermutoSDFTrainConfig, nr_rounds: int = 5,
                                        iters_per_round: int = 3, sdf_multiplier: float = 0.9,
                                        sdf_converged_tresh: float = 2e-4,
                                        first_bucket_fraction: float = 0.25, dist_field=None):
    """The trace in static buckets (:func:`~permuto_sdf_tpu_torch.ops.
    sphere_trace.sphere_trace_compacted` of the SDF's ``SDFEval``: one
    launch of J3f a round),
    then the lit rays shaded in one
    bucket of max(256, R * first_bucket_fraction) rays (kernel H0). The
    weights are clamped to the rays actually shaded: lit rays that overflow
    the bucket render as background -> (rgb, normals, weights)."""
    grid_cfg = _grid_cfg(cfg, grid)
    pos, _, converged, alive = sphere_trace_compacted(
        SDFEval(cfg.sdf_model), origins, dirs, BOUND, nr_rounds, iters_per_round,
        sdf_multiplier, sdf_converged_tresh, grid_cfg=grid_cfg, grid=grid,
        first_bucket_fraction=first_bucket_fraction, dist_field=dist_field, final_sdf=False,
        ctx=(params["sdf"], iter_nr_anneal))
    lit = _lit_and_state(pos, converged, alive, grid, grid_cfg, cfg)
    R = origins.shape[0]
    idx, _ = nonzero_static(lit, min(R, max(256, int(R * first_bucket_fraction))),
                            fill_value=R)
    pad_dir = torch.tensor([[0.0, 0.0, 1.0]], dtype=dirs.dtype, device=dirs.device)
    sub_rgb, sub_normals = _shade(params, _pad_one(pos)[idx], torch.cat([dirs, pad_dir])[idx],
                                  iter_nr_anneal, cfg)
    rgb, normals = _scatter_shaded(idx, R, sub_rgb, sub_normals)
    shaded = torch.zeros((R + 1,), dtype=torch.bool, device=lit.device)
    shaded[idx] = idx < R
    weights = (lit & shaded[:R]).to(torch.float32)[:, None]
    return rgb * weights, normals * weights, weights


@torch.no_grad()
def _shade_hits(params, pos, dirs, lit, iter_nr_anneal, cfg: PermutoSDFTrainConfig,
                bucket: int):
    """Shade exactly the lit rays, listed into a host-sized bucket (kernel
    H0) -> (rgb [R,3], normals [R,3], weights [R,1] = lit)."""
    R = pos.shape[0]
    idx, _ = nonzero_static(lit, bucket, fill_value=R)
    sub_rgb, sub_normals = _shade(params, _pad_one(pos)[idx], _pad_one(dirs)[idx],
                                  iter_nr_anneal, cfg)
    rgb, normals = _scatter_shaded(idx, R, sub_rgb, sub_normals)
    weights = lit.to(torch.float32)[:, None]
    return rgb * weights, normals * weights, weights


_DIST_FIELD_CACHE: dict = {}


def _cached_dist_field(grid_cfg, grid):
    """One Chebyshev distance field per grid state, so repeated frames of one
    scene skip its build (kernel J0). The cache holds the occupancy tensor
    it was built from and that tensor's version counter, which every
    in-place write bumps (the grid refresh bumps it on the card too, where
    its ctypes launch would not): a refreshed grid gets a new field."""
    occ = grid.occupancy
    if (_DIST_FIELD_CACHE.get("occ") is not occ or _DIST_FIELD_CACHE.get("cfg") != grid_cfg
            or _DIST_FIELD_CACHE.get("version") != occ._version):
        _DIST_FIELD_CACHE.update(occ=occ, cfg=grid_cfg, version=occ._version,
                                 field=_grid_distance_field(grid_cfg, grid))
    return _DIST_FIELD_CACHE["field"]


def _quantize(x):
    """[0, 1] -> uint8, as the JAX render packs its frame (x * 255 + 0.5,
    clipped, truncated)."""
    return torch.clamp(x * 255.0 + 0.5, 0, 255).to(torch.uint8)


def _shade_hits_compact(params, pos, dirs, lit, iter_nr_anneal, cfg: PermutoSDFTrainConfig,
                        bucket: int, shade_sdf_levels: Optional[int] = None):
    """Shade exactly the lit rays, listed into a host-sized bucket (kernel
    H0): the SDF gradient (normals, geometry features) and the RGB model ->
    (idx [bucket] (R in the unused slots), rgb uint8 [bucket, 3], normals
    uint8 [bucket, 3] (n * 0.5 + 0.5), lit). ``shade_sdf_levels`` takes the
    gradient on the coarsest K levels only."""
    R = pos.shape[0]
    idx, _ = nonzero_static(lit, bucket, fill_value=R)
    sdf_cfg = None
    if shade_sdf_levels is not None:
        sdf_cfg = dataclasses.replace(cfg.sdf_model, active_levels=shade_sdf_levels)
    sub_rgb, sub_normals = _shade(params, _pad_one(pos)[idx], _pad_one(dirs)[idx],
                                  iter_nr_anneal, cfg, sdf_cfg)
    return idx, _quantize(sub_rgb), _quantize(sub_normals * 0.5 + 0.5), lit


def _mesh_size(mesh) -> int:
    return mesh.size() if callable(getattr(mesh, "size", None)) else len(mesh)


@torch.no_grad()
def render_image_sphere_traced_fast(
        params, grid, K, tf_world_cam, width, height, iter_nr_anneal,
        cfg: PermutoSDFTrainConfig, chunk: int = 1 << 21,
        lod_levels: Optional[int] = 12, nr_rounds: int = 5,
        iters_per_round: int = 3, nr_refine_iters: int = 4,
        sdf_multiplier: float = 0.9, sdf_converged_tresh: float = 2e-4,
        dist_field=None, mesh=None, lod_schedule: Optional[tuple] = None,
        jump_substeps: int = 4, prepass_jumps: int = 16,
        jump_gate_voxels: float = 1.0, shade_sdf_levels: Optional[int] = None,
        device=None, stats_out: Optional[list] = None):
    """The interactive viewer's frame: host-adaptive sphere tracing
    (:func:`~permuto_sdf_tpu_torch.ops.sphere_trace.sphere_trace_adaptive`)
    with empty-space jumps through the grid's distance field (built once per
    grid state, or pass ``dist_field``), a LOD march on the coarsest
    ``lod_levels`` levels (or the per-round ``lod_schedule``) with a
    full-resolution refine, and the lit rays shaded in a bucket sized from
    the alive count. One device (None means the GPU; params and grid must
    live there); ``mesh`` may name one device only. ``stats_out`` collects
    each chunk's per-round (stage, bucket, n_active, n_hit) and its
    ``("lit", n_lit)``. Returns (rgb [H,W,3], normals [H,W,3], alpha
    [H,W,1]) on ``device``, rgb and normals quantized to 1/255 as the JAX
    render returns them."""
    if mesh is not None and _mesh_size(mesh) > 1:
        raise NotImplementedError("sphere-traced rendering over several devices (ROADMAP "
                                  "Queue 1 item 8) is not ported yet")
    device = resolve_device(device)
    _check_on(params, grid, device, "render_image_sphere_traced_fast")
    origins, dirs = rays_from_frame(K, tf_world_cam, width, height, device=device)
    n = origins.shape[0]
    # clamp the chunk to the frame's ray count (bucket-ladder granularity)
    chunk = min(chunk, pow2_bucket(n, lo=256, hi=chunk))
    pad = (-n) % chunk
    # pad rays start outside the bound pointing away: the boundary
    # intersection kills them before any SDF evaluation
    origins = torch.cat([origins, torch.tensor([[10.0, 0.0, 0.0]], device=device).expand(pad, 3)])
    dirs = torch.cat([dirs, torch.tensor([[1.0, 0.0, 0.0]], device=device).expand(pad, 3)])

    ctx = (params["sdf"], iter_nr_anneal)
    march_eval, refine_eval, refine_ctx, round_evals = _make_trace_lod_evals(
        cfg, ctx, lod_levels, lod_schedule)
    grid_cfg = _grid_cfg(cfg, grid)
    if grid_cfg is not None and dist_field is None:
        dist_field = _cached_dist_field(grid_cfg, grid)
    rgbs, normals, alphas = [], [], []
    for i in range(0, n + pad, chunk):
        o, d = origins[i:i + chunk], dirs[i:i + chunk]
        pos, _, conv, alive, n_alive = sphere_trace_adaptive(
            march_eval, ctx, o, d, BOUND, nr_rounds, iters_per_round, sdf_multiplier,
            sdf_converged_tresh, grid_cfg=grid_cfg, grid=grid, refine_sdf_eval=refine_eval,
            refine_ctx=refine_ctx, nr_refine_iters=nr_refine_iters, dist_field=dist_field,
            return_n_hit=True, round_sdf_evals=round_evals,
            final_refresh=False,  # the shading pass re-evaluates the hits
            jump_substeps=jump_substeps, prepass_jumps=prepass_jumps,
            jump_gate_voxels=jump_gate_voxels, stats_out=stats_out)
        lit = _lit_and_state(pos, conv, alive, grid, grid_cfg, cfg)
        # n_alive >= the lit count: it sizes the shading bucket without
        # another host round-trip
        bucket = pow2_bucket(max(n_alive, 1), lo=256, hi=max(256, chunk))
        idx, rgb_u8, nrm_u8, lit = _shade_hits_compact(params, pos, d, lit, iter_nr_anneal,
                                                       cfg, bucket, shade_sdf_levels)
        if stats_out is not None:
            stats_out.append(("lit", lit.sum()))
        R = o.shape[0]
        w = lit.to(torch.float32)[:, None]
        rgb = torch.zeros((R + 1, 3), device=device)
        nrm = torch.zeros((R + 1, 3), device=device)
        rgb[idx] = rgb_u8.to(torch.float32) / 255.0  # unused slots land on the pad row
        nrm[idx] = nrm_u8.to(torch.float32) / 255.0 * 2.0 - 1.0
        rgbs.append(rgb[:R] * w)
        normals.append(nrm[:R] * w)
        alphas.append(w)
    rgb, nrm, alpha = (torch.cat(parts, 0)[:n] for parts in (rgbs, normals, alphas))
    return (rgb.reshape(height, width, 3), nrm.reshape(height, width, 3),
            alpha.reshape(height, width, 1))


@torch.no_grad()
def render_image_sphere_traced(params, grid, K, tf_world_cam, width, height, iter_nr_anneal,
                               cfg: PermutoSDFTrainConfig, chunk: int = 8192, device=None,
                               **trace_kwargs):
    """The plain sphere-traced frame: :func:`render_rays_sphere_traced` on
    ``chunk`` rays at a time (``trace_kwargs`` go to it), the grid's distance
    field built once per grid state -> (rgb [H,W,3], normals [H,W,3], alpha
    [H,W,1]) on ``device`` (None means the GPU; params and grid must live
    there)."""
    device = resolve_device(device)
    _check_on(params, grid, device, "render_image_sphere_traced")
    if _grid_cfg(cfg, grid) is not None and "dist_field" not in trace_kwargs:
        trace_kwargs["dist_field"] = _cached_dist_field(cfg.grid, grid)
    origins, dirs = rays_from_frame(K, tf_world_cam, width, height, device=device)
    n = origins.shape[0]
    pad = (-n) % chunk
    origins = torch.cat([origins, torch.zeros((pad, 3), device=device)], 0)
    dirs = torch.cat([dirs, torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(pad, 3)], 0)
    outs = [render_rays_sphere_traced(params, grid, origins[i:i + chunk], dirs[i:i + chunk],
                                      iter_nr_anneal, cfg, **trace_kwargs)
            for i in range(0, n + pad, chunk)]
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
