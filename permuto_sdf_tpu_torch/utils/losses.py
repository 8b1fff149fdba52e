"""Counterpart of ``permuto_sdf_tpu/utils/losses.py``: the range map, the
SIREN-style SDF fit loss of the SDF-from-mesh trainer, the sphere-init
losses, the masked rgb L1 and the eikonal term (the flagship trainer forms
its loss terms inline, as the JAX trainer does)."""

from __future__ import annotations

import torch


def map_range_val(x: torch.Tensor, in_start, in_end, out_start, out_end):
    """Linear remap of a tensor with clamping."""
    x = torch.clamp(x, in_start, in_end)
    return out_start + ((out_end - out_start) / (in_end - in_start)) * (x - in_start)


def sdf_loss(surface_sdf, surface_sdf_gradients, offsurface_sdf, offsurface_sdf_gradients,
             gt_normals):
    """SIREN eq. 6 fit loss: eikonal * 5e1 + surface-normal cos * 1e2 +
    |surface sdf| * 3e3 + offsurface exp * 1e2."""
    all_gradients = torch.cat([surface_sdf_gradients, offsurface_sdf_gradients], 0)
    eikonal = torch.abs(torch.linalg.norm(all_gradients, dim=-1) - 1.0)
    loss_surface_sdf = torch.abs(surface_sdf)
    g = surface_sdf_gradients
    cos = torch.sum(g * gt_normals, dim=-1) / (
        torch.linalg.norm(g, dim=-1) * torch.linalg.norm(gt_normals, dim=-1) + 1e-12)
    loss_surface_normal = 1.0 - cos
    loss_offsurface_high_sdf = torch.exp(-1e2 * torch.abs(offsurface_sdf))
    return (eikonal.mean() * 5e1 + loss_surface_normal.mean() * 1e2
            + loss_surface_sdf.mean() * 3e3 + loss_offsurface_high_sdf.mean() * 1e2)


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


def sdf_loss_spheres(points, sdf, sdf_gradients, sphere_list, distance_scale: float = 1.0):
    """Union-of-spheres (min-combined) variant of :func:`sdf_loss_sphere`;
    ``sphere_list`` holds (radius, center) pairs."""
    dists = None
    for radius, center in sphere_list:
        c = torch.tensor(center, dtype=points.dtype, device=points.device)
        d = (torch.linalg.norm(points - c, dim=-1, keepdim=True) - radius) * distance_scale
        dists = d if dists is None else torch.minimum(dists, d)
    loss_dists = torch.mean((sdf - dists) ** 2)
    eik = torch.mean((torch.linalg.norm(sdf_gradients, dim=-1) - distance_scale) ** 2)
    return loss_dists * 3e3 + eik * 5e1, loss_dists, eik


def rgb_loss(gt_rgb, pred_rgb, does_ray_intersect):
    """Masked L1."""
    return torch.mean(torch.abs(gt_rgb - pred_rgb) * does_ray_intersect)


def eikonal_loss(sdf_gradients):
    """(||grad|| - 1)^2; gradients [N, 3], or [N, ...] flattened per row."""
    return torch.mean(
        (torch.linalg.norm(sdf_gradients.reshape(sdf_gradients.shape[0], -1), dim=-1) - 1.0) ** 2)
