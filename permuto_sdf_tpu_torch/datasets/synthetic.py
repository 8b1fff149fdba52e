"""Posed images of an analytic SDF scene (counterpart of
``permuto_sdf_tpu/datasets/synthetic.py``): the sphere + torus scene,
sphere-traced exactly in torch, seen from a golden-spiral ring of cameras.
It is the training data wherever no dataset is at hand.
"""

from __future__ import annotations

import numpy as np
import torch

from permuto_sdf_tpu_torch.datasets.tensor_reel import (
    TensorReel,
    look_at_cam_to_world,
    rays_from_frame,
)
from permuto_sdf_tpu_torch.device import resolve_device

_BG_COLOR = (0.85, 0.9, 0.95)


def _vec(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """Sphere + torus union, inside the r = 0.5 bound."""
    sphere = torch.linalg.norm(p - _vec([0.12, 0.0, 0.0], p), dim=-1) - 0.17
    q = p - _vec([-0.12, 0.0, 0.0], p)
    xy = torch.linalg.norm(q[..., :2], dim=-1)
    torus = torch.sqrt((xy - 0.14) ** 2 + q[..., 2] ** 2) - 0.06
    return torch.minimum(sphere, torus)


def scene_normal(p: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(scene_sdf(q).sum(), q)
    return g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-12)


def scene_color(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Position-striped albedo with lambertian shading from a fixed light."""
    albedo = torch.stack([0.5 + 0.45 * torch.sin(25.0 * p[..., 0]),
                          0.5 + 0.45 * torch.sin(25.0 * p[..., 1] + 1.0),
                          0.5 + 0.45 * torch.sin(25.0 * p[..., 2] + 2.0)], dim=-1)
    light = _vec([0.5, 0.7, -0.5], p)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp(torch.sum(n * light, dim=-1, keepdim=True), 0.0, 1.0)
    return torch.clamp(albedo * (0.25 + 0.75 * lam), 0.0, 1.0)


@torch.no_grad()
def _render_view(K, tf, width, height, n_steps: int = 96, device=None):
    origins, dirs = rays_from_frame(K, tf, width, height, device=device)
    t = torch.full(origins.shape[:-1], 0.3, device=device)
    done = torch.zeros(origins.shape[:-1], dtype=torch.bool, device=device)
    for _ in range(n_steps):
        s = scene_sdf(origins + t[..., None] * dirs)
        t = torch.where(done, t, t + s * 0.9)
        done = done | (torch.abs(s) < 1e-4) | (t > 3.0)
    p = origins + t[..., None] * dirs
    hit = torch.abs(scene_sdf(p)) < 1e-3
    rgb = scene_color(p, scene_normal(p))
    rgb = torch.where(hit[..., None], rgb, _vec(_BG_COLOR, rgb).expand(rgb.shape))
    return rgb.reshape(height, width, 3), hit.reshape(height, width, 1).to(torch.float32)


def spiral_camera(i_frac: float, width: int = 200, height: int = 200,
                  radius: float = 1.3, fov_deg: float = 32.0, nr_views: int = 24):
    """The golden-spiral capture camera at (possibly fractional) index
    ``i_frac`` -> (K [3,3], tf_world_cam [4,4]) float32 numpy."""
    f = 0.5 * width / np.tan(np.radians(fov_deg) / 2)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    zf = 0.8 * (1.0 - 2.0 * (i_frac + 0.5) / nr_views)
    r = np.sqrt(max(1.0 - zf * zf, 1e-6))
    th = golden * i_frac
    eye = radius * np.array([r * np.cos(th), zf, r * np.sin(th)])
    return K, look_at_cam_to_world(eye).astype(np.float32)


def make_synthetic_reel(nr_views: int = 24, width: int = 200, height: int = 200,
                        with_mask: bool = True, device=None) -> TensorReel:
    """The ``nr_views`` posed images (constant background) on ``device``
    (None means the GPU)."""
    device = resolve_device(device)
    rgbs, masks, Ks, tfs = [], [], [], []
    for i in range(nr_views):
        K, tf = spiral_camera(i, width, height, nr_views=nr_views)
        rgb, mask = _render_view(K, tf, width, height, device=device)
        rgbs.append(rgb)
        masks.append(mask)
        Ks.append(torch.from_numpy(K))
        tfs.append(torch.from_numpy(tf))
    return TensorReel(rgb=torch.stack(rgbs), mask=torch.stack(masks) if with_mask else None,
                      K=torch.stack(Ks).to(device), tf_world_cam=torch.stack(tfs).to(device))
