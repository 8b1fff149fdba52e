"""Foreground and background ray samplers without the occupancy grid
(counterpart of ``permuto_sdf_tpu/ops/ray_sampler.py``).

Foreground, ``compute_samples_fg_in_sphere`` (kernel C2,
``kernels/csrc/ray_sampler.cu``; its plain PyTorch version below is the
CPU path and the kernel's reference): the rays' entry into and exit from
the bound sphere, then uniform samples between them at
``min_dist_between_samples`` (at most S a ray, rays with <= 2 samples
discarded), the start moved by ``start [R, 1]`` in [0, 1) of a step (the
training jitter), z clipped to the range and the last dt the distance left
to t_exit, all in one launch on the card. ``compute_samples_fg`` places
the same samples from a given range, on the CPU only.

Background, NeRF++: ``nr_samples_bg`` samples per ray at inverse depth
t in [1 -> 1e-3] (each moved by up to half a step with the jitter ``rand
[R, S]`` in [0, 1) when given), z = t_exit / t, with the 4D
parameterisation (direction from the sphere center, radius / distance);
dt in z-space and the last dt = 1e10.
"""

from __future__ import annotations

import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask


def samples_fg_plain(t_entry, t_exit, min_dist: float, S: int, start=None):
    """The sampling half of kernel C2's plain version: the range [t_entry,
    t_exit] -> (z, dt, mask, ray_fixed_dt)."""
    t0 = t_entry.reshape(-1)
    t1 = t_exit.reshape(-1)
    R = t0.shape[0]
    dist = t1 - t0
    nr = torch.clamp((dist / torch.tensor(min_dist, dtype=torch.float32)).to(torch.int32), 0, S)
    dt_ray = torch.where(nr > 0, dist / torch.clamp(nr, min=1).to(torch.float32),
                         torch.zeros_like(dist))
    nr = torch.where(nr <= 2, torch.zeros_like(nr), nr)  # the reference's discard rule
    base = t0[:, None] + (start.reshape(R, 1) * dt_ray[:, None] if start is not None
                          else torch.zeros((R, 1), device=t0.device))
    z = base + torch.arange(S, device=t0.device, dtype=torch.float32)[None, :] * dt_ray[:, None]
    mask = prefix_mask(nr, S)
    z = torch.where(mask, torch.minimum(torch.maximum(z, t0[:, None]), t1[:, None]),
                    torch.zeros_like(z))
    last_idx = torch.clamp(nr - 1, min=0).to(torch.int64)
    z_last = torch.gather(z, 1, last_idx[:, None])[:, 0]
    rem = torch.minimum(torch.clamp(t1 - z_last, min=0.0), dt_ray)
    is_last = (torch.arange(S, device=t0.device)[None, :] == last_idx[:, None]) & mask
    dt = torch.where(is_last, rem[:, None], dt_ray[:, None].expand(R, S))
    dt = torch.where(mask, dt, torch.zeros_like(dt))
    return z, dt, mask, torch.where(nr > 0, dt_ray, torch.zeros_like(dt_ray))


def _sum3(x):
    """[..., 3] -> [..., 1]: (x0 + x1) + x2, kernel C2's order on every
    device (``torch.sum`` adds three values in this order on the CPU and in
    another on the card)."""
    return (x[..., 0:1] + x[..., 1:2]) + x[..., 2:3]


def _sqrt_rounded(x):
    """Float32 square root, correctly rounded as the card's ``sqrtf``: the
    CPU's vectorised float32 root is not always, so there the root is
    taken in float64 and rounded once (exact for a square root)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def samples_fg_sphere_plain(origins, dirs, sphere: Sphere, min_dist: float, S: int,
                            start=None):
    """Plain version of kernel C2: ``sphere.ray_intersection``'s t_entry,
    t_exit and does_intersect in the kernel's float order, then
    :func:`samples_fg_plain` -> (z, dt, mask, ray_fixed_dt, t_entry [R, 1],
    t_exit [R, 1], does_intersect [R, 1])."""
    center = torch.tensor(sphere.center, dtype=origins.dtype, device=origins.device)
    oc = origins - center
    a = _sum3(dirs * dirs)
    b = 2.0 * _sum3(oc * dirs)
    c = _sum3(oc * oc) - sphere.radius ** 2
    disc = b * b - 4 * a * c
    sq = _sqrt_rounded(torch.abs(disc))
    hit = disc >= 0
    zero = torch.zeros_like(a)
    t_entry = torch.clamp(torch.where(hit, (-b - sq) / (2.0 * a), zero), min=0.0)
    t_exit = torch.where(hit, (-b + sq) / (2.0 * a), zero)
    return (*samples_fg_plain(t_entry, t_exit, min_dist, S, start), t_entry, t_exit, hit)


def samples_fg_sphere_cuda(origins, dirs, sphere: Sphere, min_dist: float, S: int,
                           start=None):
    """Kernel C2 launch: same returns as :func:`samples_fg_sphere_plain`.
    Counts launches in ``samples_fg_sphere_cuda.launches``."""
    if not isinstance(sphere, Sphere):
        raise ValueError("fg sampler: kernel C2 intersects a Sphere")
    o = origins.contiguous()
    d = dirs.contiguous()
    R = o.shape[0]
    dev = o.device
    if start is not None:
        start = start.reshape(-1).contiguous()
    for t in (o, d):
        if t.dtype != torch.float32 or t.device != dev or t.shape != (R, 3):
            raise ValueError("fg sampler: float32 [R, 3] origins and dirs on one device")
    if start is not None and (start.dtype != torch.float32 or start.device != dev
                              or start.shape != (R,)):
        raise ValueError("fg sampler: a float32 [R] jitter on the rays' device")
    z = torch.empty((R, S), dtype=torch.float32, device=dev)
    dt = torch.empty((R, S), dtype=torch.float32, device=dev)
    mask = torch.empty((R, S), dtype=torch.bool, device=dev)
    fixed = torch.empty((R,), dtype=torch.float32, device=dev)
    t_entry = torch.empty((R, 1), dtype=torch.float32, device=dev)
    t_exit = torch.empty((R, 1), dtype=torch.float32, device=dev)
    hit = torch.empty((R, 1), dtype=torch.bool, device=dev)
    cx, cy, cz = (float(c) for c in sphere.center)
    lib = kernels.load("ray_sampler")
    err = lib.psdf_samples_fg(
        R, int(S), kernels.ptr(o), kernels.ptr(d), kernels.ptr(start), cx, cy, cz,
        float(sphere.radius ** 2), float(min_dist), kernels.ptr(z),
        kernels.ptr(dt), kernels.ptr(mask), kernels.ptr(fixed), kernels.ptr(t_entry),
        kernels.ptr(t_exit), kernels.ptr(hit), kernels.current_stream(dev))
    kernels.check(lib, err, "fg sampler (kernel C2)")
    samples_fg_sphere_cuda.launches += 1
    return z, dt, mask, fixed, t_entry, t_exit, hit


samples_fg_sphere_cuda.launches = 0


def compute_samples_fg_in_sphere(origins, dirs, sphere: Sphere,
                                 min_dist_between_samples: float,
                                 max_nr_samples_per_ray: int, start=None):
    """:func:`compute_samples_fg` between the entry into and the exit from
    the bound ``sphere``, with the intersection inside kernel C2's launch on
    the card -> (samples, t_entry [R, 1], t_exit [R, 1], does_intersect
    [R, 1]), as ``sphere.ray_intersection`` gives them (its root correctly
    rounded on the CPU too)."""
    fn = kernels.dispatch(origins.device, samples_fg_sphere_cuda, samples_fg_sphere_plain)
    z, dt, mask, fixed, t_entry, t_exit, hit = fn(
        origins, dirs, sphere, min_dist_between_samples, max_nr_samples_per_ray, start)
    return (RaySamples(origins=origins, dirs=dirs, z=z, dt=dt, mask=mask, ray_fixed_dt=fixed),
            t_entry, t_exit, hit)


def compute_samples_fg(origins, dirs, t_entry, t_exit, min_dist_between_samples: float,
                       max_nr_samples_per_ray: int, start=None) -> RaySamples:
    """Uniform samples between ``t_entry`` and ``t_exit`` [R, 1] at
    ``min_dist_between_samples``, at most ``max_nr_samples_per_ray`` a ray.
    ``start [R, 1]`` in [0, 1) moves the first sample by that part of a step
    (JAX's ``uniform(key, (R, 1))``); None (no jitter) starts at t_entry.
    On the CPU only: the card samples in the bound through
    :func:`compute_samples_fg_in_sphere` (kernel C2)."""
    if origins.device.type != "cpu":
        raise ValueError("compute_samples_fg runs on the CPU; on the card, "
                         "compute_samples_fg_in_sphere samples in the bound (kernel C2)")
    z, dt, mask, fixed = samples_fg_plain(t_entry, t_exit, min_dist_between_samples,
                                          max_nr_samples_per_ray, start)
    return RaySamples(origins=origins, dirs=dirs, z=z, dt=dt, mask=mask, ray_fixed_dt=fixed)


def compute_samples_bg(origins, dirs, t_exit, nr_samples_bg: int,
                       sphere_radius: float, sphere_center, rand=None) -> RaySamples:
    R = origins.shape[0]
    S = nr_samples_bg
    dev = origins.device
    t1 = t_exit.reshape(-1, 1)
    center = torch.tensor(sphere_center, dtype=origins.dtype, device=dev)
    min_t = 1e-3
    t_between = (1.0 - min_t) / (S - 1)
    t = 1.0 - torch.arange(S, dtype=torch.float32, device=dev)[None, :] * t_between
    t = t.expand(R, S)
    if rand is not None:
        t = t + (t_between * rand - t_between / 2.0)
    t = torch.clamp(t, min_t, 1.0)
    z = t1 / t
    pos3d = origins[:, None, :] + z[..., None] * dirs[:, None, :]
    rel = pos3d - center
    dist = torch.linalg.norm(rel, dim=-1, keepdim=True)
    dir_from_center = rel / torch.clamp(dist, min=1e-12)
    t_10 = sphere_radius / torch.clamp(dist, min=1e-6)
    pos_4d = torch.cat([dir_from_center, t_10], dim=-1)
    dt = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 1e10, device=dev)], dim=-1)
    mask = torch.ones((R, S), dtype=torch.bool, device=dev)
    return RaySamples(origins=origins, dirs=dirs, z=z, dt=dt, mask=mask,
                      ray_fixed_dt=torch.zeros((R,), device=dev), pos_4d=pos_4d)
