"""Counterpart of ``permuto_sdf_tpu/utils/losses.py``: the range map and
the sphere-init loss (the trainer forms its other loss terms inline, as
the JAX trainer does)."""

from __future__ import annotations

import torch


def map_range_val(x: torch.Tensor, in_start, in_end, out_start, out_end):
    """Linear remap of a tensor with clamping."""
    x = torch.clamp(x, in_start, in_end)
    return out_start + ((out_end - out_start) / (in_end - in_start)) * (x - in_start)


def sdf_loss_sphere(points, sdf, sdf_gradients, sphere_radius: float, sphere_center,
                    distance_scale: float = 1.0):
    """Fit the field to an analytic sphere SDF (the sphere-init phase).
    Returns (loss, loss_sdf, loss_eik)."""
    center = torch.tensor(sphere_center, dtype=points.dtype, device=points.device)
    dist = torch.linalg.norm(points - center, dim=-1, keepdim=True)
    target = (dist - sphere_radius) * distance_scale
    loss_dists = torch.mean((sdf - target) ** 2)
    eik = torch.mean((torch.linalg.norm(sdf_gradients, dim=-1) - distance_scale) ** 2)
    return loss_dists * 3e3 + eik * 5e1, loss_dists, eik
