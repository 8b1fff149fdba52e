"""Bounding sphere with ray intersection (counterpart of
``permuto_sdf_tpu/ops/ray_primitives.py``; only what the eval render uses)."""

from __future__ import annotations

import dataclasses

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
