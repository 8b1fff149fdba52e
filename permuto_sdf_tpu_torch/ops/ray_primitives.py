"""Bounding sphere with ray intersection, the inside test and uniform
sampling inside it (counterpart of
``permuto_sdf_tpu/ops/ray_primitives.py::Sphere``)."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Sphere:
    radius: float = 0.5
    center: tuple = (0.0, 0.0, 0.0)

    def ray_intersection(self, ray_origins: torch.Tensor, ray_dirs: torch.Tensor):
        """-> (points_entry [N,3], t_entry [N,1], points_exit [N,3],
        t_exit [N,1], does_intersect [N,1] bool). A ray that misses gets
        ``t_entry = t_exit = 0``; the entry is clamped to >= 0."""
        center = torch.tensor(self.center, dtype=ray_origins.dtype,
                              device=ray_origins.device)
        oc = ray_origins - center
        a = torch.sum(ray_dirs * ray_dirs, dim=-1, keepdim=True)
        b = 2.0 * torch.sum(oc * ray_dirs, dim=-1, keepdim=True)
        c = torch.sum(oc * oc, dim=-1, keepdim=True) - self.radius ** 2
        disc = b * b - 4 * a * c
        sq = torch.sqrt(torch.abs(disc))
        t0 = (-b - sq) / (2.0 * a)
        t1 = (-b + sq) / (2.0 * a)
        hit = disc >= 0
        t0 = torch.where(hit, t0, torch.zeros_like(t0))
        t1 = torch.where(hit, t1, torch.zeros_like(t1))
        t0 = torch.clamp(t0, min=0.0)
        p0 = ray_origins + t0 * ray_dirs
        p1 = ray_origins + t1 * ray_dirs
        return p0, t0, p1, t1, hit

    def check_point_inside_primitive(self, points: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> [N, 1] bool: strictly inside the sphere."""
        center = torch.tensor(self.center, dtype=points.dtype, device=points.device)
        d2 = torch.sum((points - center) ** 2, dim=-1, keepdim=True)
        return d2 < self.radius ** 2

    def rand_points_inside(self, nr_points: int, generator=None, draws=None,
                           device=None) -> torch.Tensor:
        """Uniform points in the ball via (phi, cos theta, u^(1/3)).
        ``draws`` = (phi [n] in [0, 2 pi), cos theta [n] in [-1, 1), u [n]
        in [0, 1)) as JAX draws them from the three parts of its key; else
        they are drawn from ``generator`` on the CPU. On ``device``."""
        if draws is None:
            u3 = torch.rand((3, nr_points), generator=generator, dtype=torch.float32)
            draws = (u3[0] * (2 * math.pi), u3[1] * 2.0 - 1.0, u3[2])
        phi, costheta, u = (torch.as_tensor(t, dtype=torch.float32).to(device)
                            for t in draws)
        theta = torch.arccos(costheta)
        r = self.radius * u ** (1.0 / 3.0)
        sin_t = torch.sin(theta)
        pts = torch.stack([r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi),
                           r * torch.cos(theta)], dim=-1)
        return pts + torch.tensor(self.center, dtype=torch.float32, device=pts.device)
