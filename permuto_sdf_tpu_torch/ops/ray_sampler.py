"""Foreground and background ray samplers without the occupancy grid
(counterpart of ``permuto_sdf_tpu/ops/ray_sampler.py``).

Foreground, ``compute_samples_fg`` (kernel C2, ``kernels/csrc/ray_sampler.cu``;
its plain PyTorch version below is the CPU path and the kernel's
reference): uniform samples between t_entry and t_exit at
``min_dist_between_samples`` (at most S a ray, rays with <= 2 samples
discarded), the start moved by ``start [R, 1]`` in [0, 1) of a step (the
training jitter), z clipped to the range and the last dt the distance left
to t_exit.

Background, NeRF++: ``nr_samples_bg`` samples per ray at inverse depth
t in [1 -> 1e-3] (each moved by up to half a step with the jitter ``rand
[R, S]`` in [0, 1) when given), z = t_exit / t, with the 4D
parameterisation (direction from the sphere center, radius / distance);
dt in z-space and the last dt = 1e10.
"""

from __future__ import annotations

import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask


def samples_fg_plain(t_entry, t_exit, min_dist: float, S: int, start=None):
    """Plain version of kernel C2 -> (z, dt, mask, ray_fixed_dt)."""
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


def samples_fg_cuda(t_entry, t_exit, min_dist: float, S: int, start=None):
    """Kernel C2 launch. Counts launches in ``samples_fg_cuda.launches``."""
    t0 = t_entry.reshape(-1).contiguous()
    t1 = t_exit.reshape(-1).contiguous()
    R = t0.shape[0]
    dev = t0.device
    if start is not None:
        start = start.reshape(-1).contiguous()
    for t in (t0, t1) + ((start,) if start is not None else ()):
        if t.dtype != torch.float32 or t.device != dev or t.shape != (R,):
            raise ValueError("fg sampler: float32 [R] ranges and jitter on one device")
    z = torch.empty((R, S), dtype=torch.float32, device=dev)
    dt = torch.empty((R, S), dtype=torch.float32, device=dev)
    mask = torch.empty((R, S), dtype=torch.bool, device=dev)
    fixed = torch.empty((R,), dtype=torch.float32, device=dev)
    lib = kernels.load("ray_sampler")
    err = lib.psdf_samples_fg(R, int(S), kernels.ptr(t0), kernels.ptr(t1), kernels.ptr(start),
                              float(min_dist), kernels.ptr(z), kernels.ptr(dt),
                              kernels.ptr(mask), kernels.ptr(fixed),
                              kernels.current_stream(dev))
    kernels.check(lib, err, "fg sampler (kernel C2)")
    samples_fg_cuda.launches += 1
    return z, dt, mask, fixed


samples_fg_cuda.launches = 0


def compute_samples_fg(origins, dirs, t_entry, t_exit, min_dist_between_samples: float,
                       max_nr_samples_per_ray: int, start=None) -> RaySamples:
    """Uniform samples between ``t_entry`` and ``t_exit`` [R, 1] at
    ``min_dist_between_samples``, at most ``max_nr_samples_per_ray`` a ray.
    ``start [R, 1]`` in [0, 1) moves the first sample by that part of a step
    (JAX's ``uniform(key, (R, 1))``); None (no jitter) starts at t_entry."""
    fn = kernels.dispatch(origins.device, samples_fg_cuda, samples_fg_plain)
    z, dt, mask, fixed = fn(t_entry, t_exit, min_dist_between_samples,
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
