"""Neural fields: SDF, RGB (Lipschitz), the NeRF++ background and the
per-image colour calibration (counterpart of
``permuto_sdf_tpu/models/fields.py``).

Every model is an ``init_*`` returning a dict of tensors plus a plain
``*_apply``. The SDF's spatial gradient is one reverse-mode pass: torch
autograd through the MLP gives the cotangent ``g`` of the encoded
features, and kernel B turns it into the point gradient
(:func:`permuto_point_grad`). In training that gradient keeps its graph,
so the losses on it reach the MLP (double backward through autograd) and
the table (kernel G), as JAX's ``value_and_grad`` of the point VJP does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from permuto_sdf_tpu_torch.models.mlp import (
    gelu,
    init_lipshitz_mlp,
    init_mlp,
    lipshitz_mlp_apply,
    mlp_apply,
)
from permuto_sdf_tpu_torch.ops.permuto_encoding import (
    PermutoEncodingSpec,
    coarse2fine_window,
    init_encoding_params,
    permuto_encode,
    permuto_point_grad,
)
from permuto_sdf_tpu_torch.ops.spherical_harmonics import spherical_harmonics


def _c2f_t(iter_nr, nr_iters_for_c2f):
    """map_range_val(iter, 0, nr_iters_for_c2f, 0.3, 1.0), in float32."""
    x = np.float32(iter_nr) / np.float32(max(nr_iters_for_c2f, 1e-8))
    x = np.clip(x, np.float32(0.0), np.float32(1.0))
    return np.float32(0.3) + np.float32(0.7) * x


def _to(layers: list, device) -> list:
    """MLP layers drawn on the CPU -> on ``device``."""
    return [{k: v.to(device) for k, v in layer.items()} for layer in layers]


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    """The JAX ``SDFConfig`` without its XLA lowering knobs (gather forms,
    AD direction). ``grad_level_parity``/``grad_level_period`` select the
    levels that get table gradients (alternating-level table gradients,
    :class:`PermutoEncodingSpec`)."""

    in_channels: int = 3
    geom_feat_size_out: int = 32
    nr_iters_for_c2f: int = 10000
    capacity: int = 2 ** 18
    nr_levels: int = 24
    sdf_shift: float = 1e-2
    grad_level_parity: Optional[int] = None
    grad_level_period: int = 2
    active_levels: Optional[int] = None

    @property
    def encoding(self) -> PermutoEncodingSpec:
        return PermutoEncodingSpec(
            pos_dim=self.in_channels, capacity=self.capacity,
            nr_levels=self.nr_levels, concat_points=True,
            concat_points_scaling=1e-3, grad_level_parity=self.grad_level_parity,
            grad_level_period=self.grad_level_period)


def init_sdf(generator: torch.Generator, cfg: SDFConfig, device=None) -> dict:
    enc = init_encoding_params(generator, cfg.encoding, device)
    mlp = init_mlp(generator,
                   [cfg.encoding.output_dims, 32, 32, 32, 1 + cfg.geom_feat_size_out],
                   last_layer_linear_init=True)
    mlp[-1]["b"][0] += cfg.sdf_shift
    return {"encoding": enc, "mlp_sdf": _to(mlp, device)}


def _sdf_levels(cfg: SDFConfig, max_levels):
    """The number of encoded levels K (None: all)."""
    if cfg.active_levels is not None:
        max_levels = (cfg.active_levels if max_levels is None
                      else min(max_levels, cfg.active_levels))
    if max_levels is not None and max_levels < cfg.nr_levels:
        return max_levels
    return None


def _sdf_mlp(params, K, cfg: SDFConfig):
    """The SDF MLP, its first layer's rows of the skipped levels sliced away
    when only the K coarsest levels are encoded (their features are 0)."""
    mlp = params["mlp_sdf"]
    if K is None:
        return mlp
    W0 = mlp[0]["w"]
    W0_sliced = torch.cat([W0[:2 * K], W0[2 * cfg.nr_levels:]], dim=0)
    return [{**mlp[0], "w": W0_sliced}] + list(mlp[1:])


def _split_sdf(out, cfg: SDFConfig):
    if cfg.geom_feat_size_out:
        return out[:, 0:1], out[:, -cfg.geom_feat_size_out:]
    return out, None


def sdf_apply(params, points, iter_nr, cfg: SDFConfig, max_levels=None):
    """points [N, d] -> (sdf [N, 1], geom_feat [N, G] or None).

    With ``max_levels`` < nr_levels the encoding returns only the K coarsest
    levels and the first layer's input rows of the skipped levels are
    sliced away (the skipped features would be zero)."""
    window = coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), cfg.nr_levels)
    K = _sdf_levels(cfg, max_levels)
    feats = permuto_encode(params["encoding"], points, cfg.encoding, window,
                           max_levels=K, zero_fill=False)
    return _split_sdf(mlp_apply(_sdf_mlp(params, K, cfg), feats), cfg)


@dataclasses.dataclass(frozen=True)
class SDFEval:
    """The SDF's value on the ``max_levels`` coarsest levels (None: all) as
    a sphere tracer's evaluation, called as ``(ctx, pts [N, 3]) -> sdf
    [N]`` with ``ctx = (params_sdf, iter_nr)``. For such a descriptor the
    tracers of ``ops/sphere_trace.py`` launch their fused kernels on the
    card (J2f, J3f: the SDF evaluated inside the trace loop's launch); any
    other callable is evaluated as it is, between the trace steps."""

    cfg: SDFConfig
    max_levels: Optional[int] = None

    def __call__(self, ctx, pts):
        params_sdf, it = ctx
        return sdf_apply(params_sdf, pts, it, self.cfg, max_levels=self.max_levels)[0].reshape(-1)


def sdf_with_gradient(params, points, iter_nr, cfg: SDFConfig, max_levels=None):
    """(sdf, d sdf / d points, geom_feat): one reverse pass with a unit
    cotangent on the sdf (reverse mode, as the JAX default). With
    ``max_levels`` both come from the K coarsest levels, as
    :func:`sdf_apply` does (JAX takes a ``vjp`` of ``sdf_apply(max_levels=)``).

    With gradients enabled (training) all three keep their graph: the
    point gradient is differentiable in the parameters (kernel G for the
    table) and, through the features, in ``points``. Under
    ``torch.no_grad`` (the eval render) the results carry no graph."""
    train = torch.is_grad_enabled()
    window = coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), cfg.nr_levels)
    K = _sdf_levels(cfg, max_levels)
    with torch.enable_grad():
        feats = permuto_encode(params["encoding"], points, cfg.encoding, window,
                               max_levels=K, zero_fill=False)
        if not feats.requires_grad:
            feats = feats.detach().requires_grad_(True)
        sdf, geom = _split_sdf(mlp_apply(_sdf_mlp(params, K, cfg), feats), cfg)
        (g,) = torch.autograd.grad(sdf, feats, grad_outputs=torch.ones_like(sdf),
                                   create_graph=train)
        grads = permuto_point_grad(params["encoding"], points, g, cfg.encoding, window,
                                   max_levels=K)
    if train:
        return sdf, grads, geom
    return sdf.detach(), grads.detach(), (geom.detach() if geom is not None else None)


def sdf_curvature_from_gradient(params, rand_dirs, points, sdf_gradients, iter_nr,
                                cfg: SDFConfig, epsilon: float = 1e-4):
    """Curvature along a random tangent direction: the normal at p against
    the normal at p + eps * (n x rand_dir), the angle mapped to [0, 1].
    ``rand_dirs [N, 3]`` are standard normal draws (JAX's
    ``normal(key, points.shape)``). -> (sdf_shifted, curvature [N, 1])."""
    rand_dirs = rand_dirs / (torch.linalg.norm(rand_dirs, dim=-1, keepdim=True) + 1e-12)
    normals = sdf_gradients / (torch.linalg.norm(sdf_gradients, dim=-1, keepdim=True) + 1e-12)
    tangent = torch.cross(normals, rand_dirs, dim=-1)
    points_shifted = points + tangent * epsilon
    sdf_shifted, grads_shifted, _ = sdf_with_gradient(params, points_shifted, iter_nr, cfg)
    normals_shifted = grads_shifted / (
        torch.linalg.norm(grads_shifted, dim=-1, keepdim=True) + 1e-12)
    dot = torch.sum(normals * normals_shifted, dim=-1, keepdim=True)
    angle = torch.arccos(torch.clamp(dot, -1.0 + 1e-6, 1.0 - 1e-6))
    return sdf_shifted, angle / np.float32(np.pi)


@dataclasses.dataclass(frozen=True)
class RGBConfig:
    in_channels: int = 3
    geom_feat_size_in: int = 32
    nr_iters_for_c2f: int = 1
    capacity: int = 2 ** 18
    nr_levels: int = 24
    sh_degree: int = 5
    grad_level_parity: Optional[int] = None
    grad_level_period: int = 2

    @property
    def encoding(self) -> PermutoEncodingSpec:
        return PermutoEncodingSpec(
            pos_dim=self.in_channels, capacity=self.capacity,
            nr_levels=self.nr_levels, concat_points=True,
            concat_points_scaling=1.0, grad_level_parity=self.grad_level_parity,
            grad_level_period=self.grad_level_period)

    @property
    def mlp_in_channels(self) -> int:
        return (self.encoding.output_dims + self.sh_degree ** 2 + 3
                + self.geom_feat_size_in)


def init_rgb(generator: torch.Generator, cfg: RGBConfig, device=None) -> dict:
    enc = init_encoding_params(generator, cfg.encoding, device)
    mlp = init_lipshitz_mlp(generator, cfg.mlp_in_channels, [128, 128, 64, 3])
    return {"encoding": enc, "mlp": _to(mlp, device)}


def rgb_apply(params, points, samples_dirs, sdf_gradients, geom_feat, iter_nr,
              cfg: RGBConfig, colorcal_params=None, per_sample_img_indices=None):
    """points/dirs/gradients/geom_feat [N, *] -> rgb [N, 3] in (0, 1), the
    logits calibrated per image (``per_sample_img_indices [N]``) when
    ``colorcal_params`` is given."""
    window = coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), cfg.nr_levels)
    feats = permuto_encode(params["encoding"], points, cfg.encoding, window)
    dirs_enc = spherical_harmonics(samples_dirs, cfg.sh_degree)
    normals = sdf_gradients / (torch.linalg.norm(sdf_gradients, dim=-1, keepdim=True)
                               + 1e-12)
    x = torch.cat([feats, dirs_enc, normals, geom_feat], dim=-1)
    x = lipshitz_mlp_apply(params["mlp"], x)
    if colorcal_params is not None:
        x = colorcal_apply(colorcal_params, x, per_sample_img_indices)
    return torch.sigmoid(x)


@dataclasses.dataclass(frozen=True)
class NerfHashConfig:
    in_channels: int = 3  # 4 for the background model
    nr_iters_for_c2f: int = 1
    capacity: int = 2 ** 18
    nr_levels: int = 24
    nr_feat_for_rgb: int = 64
    sh_degree: int = 4
    grad_level_parity: Optional[int] = None
    grad_level_period: int = 2

    @property
    def encoding(self) -> PermutoEncodingSpec:
        return PermutoEncodingSpec(
            pos_dim=self.in_channels, capacity=self.capacity,
            nr_levels=self.nr_levels, concat_points=True,
            concat_points_scaling=1.0, grad_level_parity=self.grad_level_parity,
            grad_level_period=self.grad_level_period)


def init_nerf_hash(generator: torch.Generator, cfg: NerfHashConfig,
                   device=None) -> dict:
    enc = init_encoding_params(generator, cfg.encoding, device)
    fd = init_mlp(generator,
                  [cfg.encoding.output_dims, 64, 64, 64, cfg.nr_feat_for_rgb + 1],
                  last_layer_linear_init=False)
    rgb = init_mlp(generator, [cfg.nr_feat_for_rgb + cfg.sh_degree ** 2, 64, 64, 3],
                   last_layer_linear_init=True)
    return {"encoding": enc, "mlp_feat_and_density": _to(fd, device),
            "mlp_rgb": _to(rgb, device)}


def nerf_hash_apply(params, samples_pos, samples_dirs, iter_nr, cfg: NerfHashConfig,
                    colorcal_params=None, per_sample_img_indices=None):
    """-> (rgb [N,3], density [N,1]); density softplus, rgb sigmoid (of the
    calibrated logits when ``colorcal_params`` is given)."""
    window = coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), cfg.nr_levels)
    feats = permuto_encode(params["encoding"], samples_pos, cfg.encoding, window)
    dirs_enc = spherical_harmonics(samples_dirs, cfg.sh_degree)
    fd = mlp_apply(params["mlp_feat_and_density"], feats)
    density = torch.nn.functional.softplus(fd[:, 0:1])
    feat_rgb = fd[:, 1:cfg.nr_feat_for_rgb + 1]
    x = torch.cat([gelu(feat_rgb), dirs_enc], dim=-1)
    rgb = mlp_apply(params["mlp_rgb"], x)
    if colorcal_params is not None:
        rgb = colorcal_apply(colorcal_params, rgb, per_sample_img_indices)
    return torch.sigmoid(rgb), density


def nerf_hash_density(params, samples_pos, iter_nr, cfg: NerfHashConfig):
    """The density alone, softplus [N, 1] (the NeRF grid refresh's field)."""
    window = coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), cfg.nr_levels)
    feats = permuto_encode(params["encoding"], samples_pos, cfg.encoding, window)
    fd = mlp_apply(params["mlp_feat_and_density"], feats)
    return torch.nn.functional.softplus(fd[:, 0:1])


def init_colorcal(nr_cams: int, device=None) -> dict:
    return {"weight_delta": torch.zeros((nr_cams, 3), device=device),
            "bias": torch.zeros((nr_cams, 3), device=device)}


def colorcal_apply(params, rgb_samples, per_sample_img_indices,
                   idx_with_fixed_calib: int = 0):
    """rgb [N, 3] * (1 + weight_delta[img]) + bias[img]; the fixed-calib
    camera keeps identity (weight 1, bias 0)."""
    idx = per_sample_img_indices.to(torch.int64)
    w = 1.0 + params["weight_delta"][idx]
    b = params["bias"][idx]
    fixed = (idx == idx_with_fixed_calib)[:, None]
    w = torch.where(fixed, torch.ones_like(w), w)
    b = torch.where(fixed, torch.zeros_like(b), b)
    return rgb_samples * w + b
