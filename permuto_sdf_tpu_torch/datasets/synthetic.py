"""Posed images of an analytic SDF scene (counterpart of
``permuto_sdf_tpu/datasets/synthetic.py``): the sphere + torus scene or
the busier bench scene (:func:`bench_scene_sdf`), sphere-traced exactly in
torch, seen from a golden-spiral ring of cameras, in front of a constant
or a textured sky sphere (``bg_mode``). It is the training data wherever
no dataset is at hand.
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


def scene_normal(p: torch.Tensor, sdf_fn=scene_sdf) -> torch.Tensor:
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sdf_fn(q).sum(), q)
    return g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-12)


def _sd_sphere(p, c, r):
    return torch.linalg.norm(p - _vec(c, p), dim=-1) - r


def _sd_torus(p, c, R, r, axis=2):
    q = p - _vec(c, p)
    ix = [i for i in range(3) if i != axis]
    xy = torch.linalg.norm(q[..., ix], dim=-1)
    return torch.sqrt((xy - R) ** 2 + q[..., axis] ** 2) - r


def _sd_box(p, c, b, rad=0.02):
    q = torch.abs(p - _vec(c, p)) - _vec(b, p)
    return (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
            + torch.clamp(torch.amax(q, dim=-1), max=0.0) - rad)


def bench_scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """The busier scene of the throughput bench: a wrinkly central blob,
    two interlocked tori, three satellites and a rounded box, all inside
    r = 0.47 (~1.6% band occupancy at 256^3, near a DTU scan's ~2%, where
    the sphere + torus scene settles to ~0.14%). A conservative distance
    lower bound (the displaced blob divided by its Lipschitz constant), so
    the sphere tracer of :func:`_render_view` converges."""
    blob = _sd_sphere(p, [0.0, 0.0, 0.0], 0.30) + 0.02 * (
        torch.sin(40 * p[..., 0]) * torch.sin(40 * p[..., 1]) * torch.sin(40 * p[..., 2]))
    blob = blob / 1.9  # Lipschitz bound of the displaced field
    t1 = _sd_torus(p, [0.0, 0.0, 0.0], 0.40, 0.030, axis=2)
    t2 = _sd_torus(p, [0.0, 0.0, 0.0], 0.40, 0.030, axis=0)
    s1 = _sd_sphere(p, [0.28, 0.28, 0.0], 0.06)
    s2 = _sd_sphere(p, [-0.28, 0.28, 0.0], 0.06)
    s3 = _sd_sphere(p, [0.0, -0.33, 0.18], 0.06)
    bx = _sd_box(p, [0.0, 0.28, -0.20], [0.08, 0.035, 0.08])
    return torch.minimum(blob, torch.minimum(
        torch.minimum(t1, t2),
        torch.minimum(torch.minimum(s1, s2), torch.minimum(s3, bx))))


def scene_color(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Position-striped albedo with lambertian shading from a fixed light."""
    albedo = torch.stack([0.5 + 0.45 * torch.sin(25.0 * p[..., 0]),
                          0.5 + 0.45 * torch.sin(25.0 * p[..., 1] + 1.0),
                          0.5 + 0.45 * torch.sin(25.0 * p[..., 2] + 2.0)], dim=-1)
    light = _vec([0.5, 0.7, -0.5], p)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp(torch.sum(n * light, dim=-1, keepdim=True), 0.0, 1.0)
    return torch.clamp(albedo * (0.25 + 0.75 * lam), 0.0, 1.0)


# The textured background's sky sphere: outside the r = 0.5 bound, near
# enough that cameras at radius 1.3 see parallax between views (the signal
# the NeRF++ background model trains on).
_BG_SPHERE_RADIUS = 4.0


def bg_color_at(p: torch.Tensor) -> torch.Tensor:
    """The sky sphere's procedural texture, a smooth function of the 3D hit
    point (not of the view direction alone)."""
    u = p / _BG_SPHERE_RADIUS
    r = 0.55 + 0.25 * torch.sin(3.0 * u[..., 0] + 5.0 * u[..., 1])
    g = 0.55 + 0.25 * torch.sin(4.0 * u[..., 1] + 3.0 * u[..., 2] + 1.3)
    b = 0.60 + 0.25 * torch.sin(5.0 * u[..., 2] + 4.0 * u[..., 0] + 2.1)
    bands = 0.12 * torch.sin(9.0 * u[..., 1])
    return torch.clamp(torch.stack([r + bands, g + bands, b], dim=-1), 0.0, 1.0)


def _bg_sphere_hit(origins, dirs):
    """The far intersection of unit rays with the sky sphere."""
    b = torch.sum(origins * dirs, dim=-1)
    c = torch.sum(origins * origins, dim=-1) - _BG_SPHERE_RADIUS ** 2
    t = -b + torch.sqrt(torch.clamp(b * b - c, min=0.0))
    return origins + t[..., None] * dirs


@torch.no_grad()
def _render_view(K, tf, width, height, sdf_fn=scene_sdf, n_steps: int = 96,
                 bg_mode: str = "constant", device=None):
    origins, dirs = rays_from_frame(K, tf, width, height, device=device)
    t = torch.full(origins.shape[:-1], 0.3, device=device)
    done = torch.zeros(origins.shape[:-1], dtype=torch.bool, device=device)
    for _ in range(n_steps):
        s = sdf_fn(origins + t[..., None] * dirs)
        t = torch.where(done, t, t + s * 0.9)
        done = done | (torch.abs(s) < 1e-4) | (t > 3.0)
    p = origins + t[..., None] * dirs
    hit = torch.abs(sdf_fn(p)) < 1e-3
    rgb = scene_color(p, scene_normal(p, sdf_fn=sdf_fn))
    if bg_mode == "textured":
        bg = bg_color_at(_bg_sphere_hit(origins, dirs))
    else:
        bg = _vec(_BG_COLOR, rgb).expand(rgb.shape)
    rgb = torch.where(hit[..., None], rgb, bg)
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
                        radius: float = 1.3, fov_deg: float = 32.0,
                        with_mask: bool = True, sdf_fn=scene_sdf,
                        bg_mode: str = "constant", device=None) -> TensorReel:
    """The ``nr_views`` posed images of ``sdf_fn``'s scene (``bg_mode``
    "constant" or "textured") on ``device`` (None means the GPU)."""
    device = resolve_device(device)
    rgbs, masks, Ks, tfs = [], [], [], []
    for i in range(nr_views):
        K, tf = spiral_camera(i, width, height, radius, fov_deg, nr_views)
        rgb, mask = _render_view(K, tf, width, height, sdf_fn=sdf_fn, bg_mode=bg_mode,
                                 device=device)
        rgbs.append(rgb)
        masks.append(mask)
        Ks.append(torch.from_numpy(K))
        tfs.append(torch.from_numpy(tf))
    return TensorReel(rgb=torch.stack(rgbs), mask=torch.stack(masks) if with_mask else None,
                      K=torch.stack(Ks).to(device), tf_world_cam=torch.stack(tfs).to(device))
