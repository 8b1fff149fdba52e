"""Occupancy grid and the sampler through occupied space (counterpart of
``permuto_sdf_tpu/ops/occupancy_grid.py``; the eval-render subset).

The sampler ``compute_samples_in_occupied_regions`` is kernel C on the card
(``kernels/csrc/occupancy_grid.cu``); its plain PyTorch version below is
the CPU path and the kernel's reference. Both keep the occupied-probe
counts as integers and form the cumulative occupied length as
``count * seg_len`` with one rounding (the JAX op takes an f32 cumsum of
``occ * seg_len`` instead, which can move a sample that lands exactly on a
probe boundary across an unoccupied gap).
"""

from __future__ import annotations

import dataclasses

import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask


@dataclasses.dataclass
class OccupancyGridState:
    values: torch.Tensor  # [V^3] float
    occupancy: torch.Tensor  # [V^3] bool


@dataclasses.dataclass(frozen=True)
class OccupancyGridConfig:
    nr_voxels_per_dim: int = 256
    grid_extent: float = 1.0
    grid_translation: tuple = (0.0, 0.0, 0.0)

    @property
    def nr_voxels(self) -> int:
        return self.nr_voxels_per_dim ** 3

    @property
    def voxel_size(self) -> float:
        return self.grid_extent / self.nr_voxels_per_dim

    @property
    def half_diagonal(self) -> float:
        return (3.0 ** 0.5) * self.voxel_size / 2.0


def make_occupancy_grid(cfg: OccupancyGridConfig, initial_occupied: bool = True,
                        device=None) -> OccupancyGridState:
    """Fresh grid, fully occupied by default (as the reference starts)."""
    return OccupancyGridState(
        values=torch.zeros((cfg.nr_voxels,), dtype=torch.float32, device=device),
        occupancy=torch.full((cfg.nr_voxels,), bool(initial_occupied),
                             dtype=torch.bool, device=device),
    )


def point_to_lin_idx(cfg: OccupancyGridConfig, points: torch.Tensor):
    """World point -> (row-major linear index, in_bounds mask)."""
    v = cfg.nr_voxels_per_dim
    t = torch.tensor(cfg.grid_translation, dtype=points.dtype, device=points.device)
    p = (points - t + cfg.grid_extent / 2.0) / torch.tensor(
        cfg.voxel_size, dtype=points.dtype)
    ijk = torch.floor(p).to(torch.int32)
    in_bounds = torch.all((ijk >= 0) & (ijk < v), dim=-1)
    ijk = torch.clamp(ijk, 0, v - 1).to(torch.int64)
    lin = (ijk[..., 0] * v + ijk[..., 1]) * v + ijk[..., 2]
    return lin, in_bounds


def check_occupancy(cfg: OccupancyGridConfig, grid: OccupancyGridState,
                    points: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N] bool (out-of-grid points report unoccupied)."""
    lin, in_bounds = point_to_lin_idx(cfg, points)
    return grid.occupancy[lin] & in_bounds


def probe_sampler_plain(cfg: OccupancyGridConfig, occupancy, origins, dirs,
                        t_entry, t_exit, min_dist: float, S: int, P: int):
    """Plain version of kernel C. Returns (z, dt, mask, ray_fixed_dt)."""
    R = origins.shape[0]
    dev = origins.device
    t_entry = t_entry.reshape(-1, 1)
    t_exit = t_exit.reshape(-1, 1)
    frac = (torch.arange(P, device=dev, dtype=torch.float32) + 0.5) / float(P)
    ts = t_entry + frac[None, :] * (t_exit - t_entry)  # [R, P]
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    occ = check_occupancy(cfg, OccupancyGridState(None, occupancy),
                          pts.reshape(-1, 3)).reshape(R, P)
    counts = torch.cumsum(occ.to(torch.int32), dim=-1)  # [R, P] exact
    seg_len = (t_exit - t_entry)[:, 0] / float(P)
    occupied_dist = counts[:, -1].to(torch.float32) * seg_len

    nr = torch.floor(occupied_dist / torch.tensor(min_dist, dtype=torch.float32)
                     ).to(torch.int32)
    nr = torch.clamp(nr, 0, S)
    nr = torch.where(nr <= 2, torch.zeros_like(nr), nr)
    dt_ray = torch.where(nr > 0, occupied_dist / torch.clamp(nr, min=1).to(torch.float32),
                         torch.zeros_like(occupied_dist))

    arc = (torch.arange(S, device=dev, dtype=torch.float32)[None, :] + 0.5) * dt_ray[:, None]
    cum = counts.to(torch.float32) * seg_len[:, None]
    idx = torch.searchsorted(cum, arc.contiguous(), right=True)
    idx = torch.clamp(idx, 0, P - 1)
    cum_before = torch.where(idx > 0, torch.gather(cum, 1, torch.clamp(idx - 1, min=0)),
                             torch.zeros_like(arc))
    into = torch.minimum(torch.clamp(arc - cum_before, min=0.0), seg_len[:, None])
    t = (t_entry + idx.to(torch.float32) * seg_len[:, None]) + into

    mask = prefix_mask(nr, S)
    z = torch.where(mask, t, torch.zeros_like(t))
    last_idx = torch.clamp(nr - 1, min=0).to(torch.int64)
    z_last = torch.gather(z, 1, last_idx[:, None])[:, 0]
    rem = torch.minimum(torch.clamp(t_exit[:, 0] - z_last, min=0.0), dt_ray)
    is_last = torch.arange(S, device=dev)[None, :] == last_idx[:, None]
    dt = torch.where(is_last & mask, rem[:, None], dt_ray[:, None].expand(R, S))
    dt = torch.where(mask, dt, torch.zeros_like(dt))
    return z, dt, mask, torch.where(nr > 0, dt_ray, torch.zeros_like(dt_ray))


def probe_sampler_cuda(cfg: OccupancyGridConfig, occupancy, origins, dirs,
                       t_entry, t_exit, min_dist: float, S: int, P: int):
    """Kernel C launch. Counts launches in ``probe_sampler_cuda.launches``."""
    R = origins.shape[0]
    dev = origins.device
    if occupancy.dtype != torch.bool or occupancy.numel() != cfg.nr_voxels:
        raise ValueError("probe sampler: occupancy must be a bool [V^3] tensor")
    if P % 32:
        raise ValueError("probe sampler: nr_probes must be a multiple of 32")
    args = [t.contiguous() for t in (origins, dirs, t_entry.reshape(-1), t_exit.reshape(-1))]
    for t in args + [occupancy]:
        if t.device != dev or (t is not occupancy and t.dtype != torch.float32):
            raise ValueError("probe sampler: float32 rays and the grid on one device")
    z = torch.empty((R, S), dtype=torch.float32, device=dev)
    dt = torch.empty((R, S), dtype=torch.float32, device=dev)
    mask = torch.empty((R, S), dtype=torch.bool, device=dev)
    fixed = torch.empty((R,), dtype=torch.float32, device=dev)
    lib = kernels.load("occupancy_grid")
    tx, ty, tz = (float(v) for v in cfg.grid_translation)
    err = lib.psdf_probe_sampler(
        R, *(kernels.ptr(a) for a in args), kernels.ptr(occupancy.contiguous()),
        cfg.nr_voxels_per_dim, cfg.grid_extent / 2.0, tx, ty, tz, cfg.voxel_size,
        float(min_dist), S, P, kernels.ptr(z), kernels.ptr(dt), kernels.ptr(mask),
        kernels.ptr(fixed), kernels.current_stream(dev))
    kernels.check(lib, err, "occupancy probe sampler (kernel C)")
    probe_sampler_cuda.launches += 1
    return z, dt, mask, fixed


probe_sampler_cuda.launches = 0


def compute_samples_in_occupied_regions(
    cfg: OccupancyGridConfig, grid: OccupancyGridState, origins, dirs, t_entry,
    t_exit, min_dist_between_samples: float, max_nr_samples_per_ray: int,
    nr_probes: int = 512,
) -> RaySamples:
    """Equispaced samples inside occupied voxels along each ray (jitter off:
    the eval render). Rays with <= 2 samples are zeroed."""
    if origins.is_cuda:
        fn = probe_sampler_cuda
    elif origins.device.type == "cpu":
        fn = probe_sampler_plain
    else:
        raise ValueError(f"probe sampler: unsupported device {origins.device}")
    z, dt, mask, fixed = fn(cfg, grid.occupancy, origins, dirs, t_entry, t_exit,
                            min_dist_between_samples, max_nr_samples_per_ray,
                            nr_probes)
    return RaySamples(origins=origins, dirs=dirs, z=z, dt=dt, mask=mask,
                      ray_fixed_dt=fixed)
