"""Neural fields of the eval render: SDF, RGB (Lipschitz) and the NeRF++
background (counterpart of ``permuto_sdf_tpu/models/fields.py``).

Every model is an ``init_*`` returning a dict of tensors plus a plain
``*_apply``. The SDF's spatial gradient is one reverse-mode pass through
the MLP (torch autograd) and the encoding (kernel B on the card).
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
    """The JAX ``SDFConfig`` without its XLA lowering and training knobs
    (gather forms, table-gradient alternation, AD direction)."""

    in_channels: int = 3
    geom_feat_size_out: int = 32
    nr_iters_for_c2f: int = 10000
    capacity: int = 2 ** 18
    nr_levels: int = 24
    sdf_shift: float = 1e-2
    active_levels: Optional[int] = None

    @property
    def encoding(self) -> PermutoEncodingSpec:
        return PermutoEncodingSpec(
            pos_dim=self.in_channels, capacity=self.capacity,
            nr_levels=self.nr_levels, concat_points=True,
            concat_points_scaling=1e-3)


def init_sdf(generator: torch.Generator, cfg: SDFConfig, device=None) -> dict:
    enc = init_encoding_params(generator, cfg.encoding, device)
    mlp = init_mlp(generator,
                   [cfg.encoding.output_dims, 32, 32, 32, 1 + cfg.geom_feat_size_out],
                   last_layer_linear_init=True)
    mlp[-1]["b"][0] += cfg.sdf_shift
    return {"encoding": enc, "mlp_sdf": _to(mlp, device)}


def sdf_apply(params, points, iter_nr, cfg: SDFConfig, max_levels=None):
    """points [N, d] -> (sdf [N, 1], geom_feat [N, G] or None).

    With ``max_levels`` < nr_levels the encoding returns only the K coarsest
    levels and the first layer's input rows of the skipped levels are
    sliced away (the skipped features would be zero)."""
    window = coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), cfg.nr_levels)
    L = cfg.nr_levels
    if cfg.active_levels is not None:
        max_levels = (cfg.active_levels if max_levels is None
                      else min(max_levels, cfg.active_levels))
    if max_levels is not None and max_levels < L:
        K = max_levels
        feats = permuto_encode(params["encoding"], points, cfg.encoding, window,
                               max_levels=K, zero_fill=False)
        mlp = params["mlp_sdf"]
        W0 = mlp[0]["w"]
        F = cfg.encoding.nr_feat_per_level
        W0_sliced = torch.cat([W0[:K * F], W0[L * F:]], dim=0)
        mlp = [{**mlp[0], "w": W0_sliced}] + list(mlp[1:])
        out = mlp_apply(mlp, feats)
    else:
        feats = permuto_encode(params["encoding"], points, cfg.encoding, window)
        out = mlp_apply(params["mlp_sdf"], feats)
    if cfg.geom_feat_size_out:
        return out[:, 0:1], out[:, -cfg.geom_feat_size_out:]
    return out, None


def sdf_with_gradient(params, points, iter_nr, cfg: SDFConfig):
    """(sdf, d sdf / d points, geom_feat): one reverse pass with a unit
    cotangent on the sdf (reverse mode, as the JAX default). Works under
    ``torch.no_grad``; the results carry no graph."""
    with torch.enable_grad():
        p = points.detach().requires_grad_(True)
        sdf, geom = sdf_apply(params, p, iter_nr, cfg)
        (grads,) = torch.autograd.grad(sdf, p, grad_outputs=torch.ones_like(sdf))
    return sdf.detach(), grads.detach(), (geom.detach() if geom is not None else None)


@dataclasses.dataclass(frozen=True)
class RGBConfig:
    in_channels: int = 3
    geom_feat_size_in: int = 32
    nr_iters_for_c2f: int = 1
    capacity: int = 2 ** 18
    nr_levels: int = 24
    sh_degree: int = 5

    @property
    def encoding(self) -> PermutoEncodingSpec:
        return PermutoEncodingSpec(
            pos_dim=self.in_channels, capacity=self.capacity,
            nr_levels=self.nr_levels, concat_points=True,
            concat_points_scaling=1.0)

    @property
    def mlp_in_channels(self) -> int:
        return (self.encoding.output_dims + self.sh_degree ** 2 + 3
                + self.geom_feat_size_in)


def init_rgb(generator: torch.Generator, cfg: RGBConfig, device=None) -> dict:
    enc = init_encoding_params(generator, cfg.encoding, device)
    mlp = init_lipshitz_mlp(generator, cfg.mlp_in_channels, [128, 128, 64, 3])
    return {"encoding": enc, "mlp": _to(mlp, device)}


def rgb_apply(params, points, samples_dirs, sdf_gradients, geom_feat, iter_nr,
              cfg: RGBConfig):
    """points/dirs/gradients/geom_feat [N, *] -> rgb [N, 3] in (0, 1)."""
    window = coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), cfg.nr_levels)
    feats = permuto_encode(params["encoding"], points, cfg.encoding, window)
    dirs_enc = spherical_harmonics(samples_dirs, cfg.sh_degree)
    normals = sdf_gradients / (torch.linalg.norm(sdf_gradients, dim=-1, keepdim=True)
                               + 1e-12)
    x = torch.cat([feats, dirs_enc, normals, geom_feat], dim=-1)
    x = lipshitz_mlp_apply(params["mlp"], x)
    return torch.sigmoid(x)


@dataclasses.dataclass(frozen=True)
class NerfHashConfig:
    in_channels: int = 3  # 4 for the background model
    nr_iters_for_c2f: int = 1
    capacity: int = 2 ** 18
    nr_levels: int = 24
    nr_feat_for_rgb: int = 64
    sh_degree: int = 4

    @property
    def encoding(self) -> PermutoEncodingSpec:
        return PermutoEncodingSpec(
            pos_dim=self.in_channels, capacity=self.capacity,
            nr_levels=self.nr_levels, concat_points=True,
            concat_points_scaling=1.0)


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


def nerf_hash_apply(params, samples_pos, samples_dirs, iter_nr, cfg: NerfHashConfig):
    """-> (rgb [N,3], density [N,1]); density softplus, rgb sigmoid."""
    window = coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), cfg.nr_levels)
    feats = permuto_encode(params["encoding"], samples_pos, cfg.encoding, window)
    dirs_enc = spherical_harmonics(samples_dirs, cfg.sh_degree)
    fd = mlp_apply(params["mlp_feat_and_density"], feats)
    density = torch.nn.functional.softplus(fd[:, 0:1])
    feat_rgb = fd[:, 1:cfg.nr_feat_for_rgb + 1]
    x = torch.cat([gelu(feat_rgb), dirs_enc], dim=-1)
    rgb = mlp_apply(params["mlp_rgb"], x)
    return torch.sigmoid(rgb), density
