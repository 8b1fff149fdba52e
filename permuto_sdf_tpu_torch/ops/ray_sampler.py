"""Background ray sampler (counterpart of
``permuto_sdf_tpu/ops/ray_sampler.py::compute_samples_bg``).

NeRF++ background: ``nr_samples_bg`` samples per ray at inverse depth
t in [1 -> 1e-3] (each moved by up to half a step with the jitter ``rand
[R, S]`` in [0, 1) when given), z = t_exit / t, with the 4D
parameterisation (direction from the sphere center, radius / distance);
dt in z-space and the last dt = 1e10.
"""

from __future__ import annotations

import torch

from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples


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
