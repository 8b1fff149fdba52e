"""Occupancy grid, the sampler through occupied space, the grid refresh
and the empty-space distance field (counterpart of
``permuto_sdf_tpu/ops/occupancy_grid.py``).

The sampler ``compute_samples_in_occupied_regions`` is kernel C on the card
(``kernels/csrc/occupancy_grid.cu``), the plain sphere tracers' seed
``compute_first_sample_start_of_occupied_regions`` kernel C3 (the same
file, the same probes, runs of them ruled out by the grid's distance
field); ``compute_stratified_sample_of_grid_points``
and ``update_with_sdf_random_sample`` are the two entry points of kernel
I, and ``refresh_with_sdf`` is the flagship trainer's refresh: on the card
kernel If (both entries and the SDF between them in one launch) for an SDF
the fused kernels evaluate (``ops/sdf_net.py``), else the two entries
around the SDF; ``update_with_density_random_sample`` (NeRF's update) is
kernel I2, and ``refresh_with_density`` NeRF's refresh: on the card kernel
I2f (entry 1, the density field and I2 in one launch) for every foreground
``NerfHashConfig``, else entry 1, the density and I2;
``chebyshev_empty_distance`` is kernel J0 (``kernels/csrc/sphere_trace.cu``).
Their plain PyTorch versions below are the CPU path and the kernels'
reference. ``compute_random_sample_of_grid_points``, ``mip_config``,
``downsample_occupancy`` and ``advance_sample_to_next_occupied_voxel`` are
plain PyTorch only: no tracer or trainer calls them. Kernel C and its plain version keep the occupied-probe counts
as integers and form the cumulative occupied length as ``count * seg_len``
with one rounding (the JAX op takes an f32 cumsum of ``occ * seg_len``
instead, which can move a sample that lands exactly on a probe boundary
across an unoccupied gap). The grid refresh updates the state in place and
bumps the occupancy tensor's version counter on both paths (the kernel's
ctypes launch does it by hand), so a cache keyed by that counter sees the
change.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.models.fields import NerfHashConfig, SDFEval, nerf_hash_density
from permuto_sdf_tpu_torch.ops import sdf_net as sn
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


def lin_idx_to_voxel_center(cfg: OccupancyGridConfig, lin: torch.Tensor) -> torch.Tensor:
    """Row-major linear index -> world voxel center [N, 3]."""
    v = cfg.nr_voxels_per_dim
    ijk = torch.stack([lin // (v * v), (lin // v) % v, lin % v], dim=-1).to(torch.float32)
    t = torch.tensor(cfg.grid_translation, dtype=torch.float32, device=lin.device)
    return ((ijk + 0.5) * cfg.voxel_size - cfg.grid_extent / 2.0) + t


def _probe_occupancy(cfg: OccupancyGridConfig, occupancy, origins, dirs, t_entry,
                     t_exit, P: int):
    """Occupancy at the P probe midpoints ``t_entry + ((i + 0.5) / P)
    (t_exit - t_entry)`` of each ray -> (occ [R, P] bool, seg_len [R])."""
    R = origins.shape[0]
    t_entry = t_entry.reshape(-1, 1)
    t_exit = t_exit.reshape(-1, 1)
    frac = (torch.arange(P, device=origins.device, dtype=torch.float32) + 0.5) / float(P)
    ts = t_entry + frac[None, :] * (t_exit - t_entry)  # [R, P]
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    occ = check_occupancy(cfg, OccupancyGridState(None, occupancy),
                          pts.reshape(-1, 3)).reshape(R, P)
    return occ, (t_exit - t_entry)[:, 0] / float(P)


def probe_sampler_plain(cfg: OccupancyGridConfig, occupancy, origins, dirs,
                        t_entry, t_exit, min_dist: float, S: int, P: int, start=None):
    """Plain version of kernel C. ``start [R]`` is the per-ray jitter of the
    first sample in [0, 1) (None: 0.5). Returns (z, dt, mask, ray_fixed_dt)."""
    R = origins.shape[0]
    dev = origins.device
    occ, seg_len = _probe_occupancy(cfg, occupancy, origins, dirs, t_entry, t_exit, P)
    t_entry = t_entry.reshape(-1, 1)
    t_exit = t_exit.reshape(-1, 1)
    counts = torch.cumsum(occ.to(torch.int32), dim=-1)  # [R, P] exact
    occupied_dist = counts[:, -1].to(torch.float32) * seg_len

    nr = torch.floor(occupied_dist / torch.tensor(min_dist, dtype=torch.float32)
                     ).to(torch.int32)
    nr = torch.clamp(nr, 0, S)
    nr = torch.where(nr <= 2, torch.zeros_like(nr), nr)
    dt_ray = torch.where(nr > 0, occupied_dist / torch.clamp(nr, min=1).to(torch.float32),
                         torch.zeros_like(occupied_dist))

    st = start.reshape(R, 1) if start is not None else 0.5
    arc = (torch.arange(S, device=dev, dtype=torch.float32)[None, :] + st) * dt_ray[:, None]
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
                       t_entry, t_exit, min_dist: float, S: int, P: int, start=None):
    """Kernel C launch (``P`` a multiple of 32 up to 1024: the kernel keeps
    one ballot of 32 probes per lane). Counts launches in
    ``probe_sampler_cuda.launches``."""
    R = origins.shape[0]
    dev = origins.device
    if (occupancy.dtype != torch.bool or occupancy.numel() != cfg.nr_voxels
            or occupancy.device != dev):
        raise ValueError("probe sampler: occupancy must be a bool [V^3] tensor on the rays' "
                         "device")
    if P % 32 or not 0 < P <= 1024:
        raise ValueError("probe sampler: nr_probes must be a multiple of 32 up to 1024")
    # t_entry, t_exit and start are read as R floats: [R] and [R, 1] alike
    rays = [origins, dirs, t_entry, t_exit] + ([start] if start is not None else [])
    for i, t in enumerate(rays):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != (3 * R if i < 2 else R):
            raise ValueError("probe sampler: float32 rays [R, 3], t_entry, t_exit and start "
                             "[R] on one device")
    o, d, t0, t1, *st = (t.contiguous() for t in rays)
    occ = occupancy.contiguous()
    z = torch.empty((R, S), dtype=torch.float32, device=dev)
    dt = torch.empty((R, S), dtype=torch.float32, device=dev)
    mask = torch.empty((R, S), dtype=torch.bool, device=dev)
    fixed = torch.empty((R,), dtype=torch.float32, device=dev)
    lib = kernels.load("occupancy_grid")
    tx, ty, tz = cfg.grid_translation
    err = lib.psdf_probe_sampler(
        R, o.data_ptr(), d.data_ptr(), t0.data_ptr(), t1.data_ptr(),
        st[0].data_ptr() if st else None, occ.data_ptr(),
        cfg.nr_voxels_per_dim, cfg.grid_extent / 2.0, tx, ty, tz, cfg.voxel_size, min_dist,
        S, P, z.data_ptr(), dt.data_ptr(), mask.data_ptr(), fixed.data_ptr(),
        kernels.current_stream(dev))
    kernels.check(lib, err, "occupancy probe sampler (kernel C)")
    probe_sampler_cuda.launches += 1
    return z, dt, mask, fixed


probe_sampler_cuda.launches = 0


def compute_samples_in_occupied_regions(
    cfg: OccupancyGridConfig, grid: OccupancyGridState, origins, dirs, t_entry,
    t_exit, min_dist_between_samples: float, max_nr_samples_per_ray: int,
    nr_probes: int = 512, start=None,
) -> RaySamples:
    """Equispaced samples inside occupied voxels along each ray. ``start
    [R, 1]`` is the training jitter of the first sample in [0, 1) (JAX's
    ``uniform(key, (R, 1))``); None (the eval render) places it at 0.5.
    Rays with <= 2 samples are zeroed."""
    fn = kernels.dispatch(origins.device, probe_sampler_cuda, probe_sampler_plain)
    z, dt, mask, fixed = fn(cfg, grid.occupancy, origins, dirs, t_entry, t_exit,
                            min_dist_between_samples, max_nr_samples_per_ray,
                            nr_probes, start)
    return RaySamples(origins=origins, dirs=dirs, z=z, dt=dt, mask=mask,
                      ray_fixed_dt=fixed)


# ---------------------------------------------------------------------------
# Kernel C3: the first occupied probe segment (the plain tracers' seed)
# ---------------------------------------------------------------------------

def first_occupied_plain(cfg: OccupancyGridConfig, occupancy, origins, dirs, t_entry,
                         t_exit, P: int):
    """Plain version of kernel C3 -> (t_first [R], has [R] bool)."""
    occ, seg_len = _probe_occupancy(cfg, occupancy, origins, dirs, t_entry, t_exit, P)
    has = torch.any(occ, dim=-1)
    first = torch.argmax(occ.to(torch.uint8), dim=-1)  # the first True
    t_first = t_entry.reshape(-1) + first.to(torch.float32) * seg_len
    return torch.where(has, t_first, t_exit.reshape(-1)), has


def first_occupied_cuda(cfg: OccupancyGridConfig, occupancy, origins, dirs, t_entry,
                        t_exit, P: int, dist_field=None):
    """Kernel C3 launch, reading ``dist_field``, the grid state's
    :func:`chebyshev_empty_distance` at any cap (the plain tracers pass
    theirs); kernel J0 builds it here at cap 63, the tracers' cap, when it
    is None. Counts launches in ``first_occupied_cuda.launches``."""
    R = origins.shape[0]
    dev = origins.device
    if occupancy.dtype != torch.bool or occupancy.numel() != cfg.nr_voxels:
        raise ValueError("first occupied probe: occupancy must be a bool [V^3] tensor")
    args = [t.contiguous() for t in (origins, dirs, t_entry.reshape(-1), t_exit.reshape(-1))]
    for t in args + [occupancy]:
        if t.device != dev or (t is not occupancy and t.dtype != torch.float32):
            raise ValueError("first occupied probe: float32 rays and the grid on one device")
    if dist_field is None:
        dist_field = chebyshev_field_cuda(cfg, occupancy, 63)
    elif (dist_field.dtype != torch.uint8 or dist_field.device != dev
          or dist_field.numel() != cfg.nr_voxels):
        raise ValueError("first occupied probe: dist_field must be the grid's uint8 [V^3] "
                         "distance field on the rays' device")
    t_first = torch.empty((R,), dtype=torch.float32, device=dev)
    has = torch.empty((R,), dtype=torch.bool, device=dev)
    lib = kernels.load("occupancy_grid")
    tx, ty, tz = (float(v) for v in cfg.grid_translation)
    err = lib.psdf_first_occupied(
        R, *(kernels.ptr(a) for a in args), kernels.ptr(occupancy.contiguous()),
        kernels.ptr(dist_field.contiguous()), cfg.nr_voxels_per_dim, cfg.grid_extent / 2.0,
        tx, ty, tz, cfg.voxel_size, int(P), kernels.ptr(t_first), kernels.ptr(has),
        kernels.current_stream(dev))
    kernels.check(lib, err, "first occupied probe (kernel C3)")
    first_occupied_cuda.launches += 1
    return t_first, has


first_occupied_cuda.launches = 0


def compute_first_sample_start_of_occupied_regions(cfg: OccupancyGridConfig,
                                                   grid: OccupancyGridState, origins, dirs,
                                                   t_entry, t_exit, nr_probes: int = 512,
                                                   dist_field=None):
    """The plain tracers' seed: per ray, the start ``t_entry + first *
    seg_len`` of the first of ``nr_probes`` probe segments whose midpoint
    lies in an occupied voxel, or ``t_exit`` without one -> (t_first [R],
    has_occupied [R] bool). On the card kernel C3 reads the grid's
    ``dist_field`` (see :func:`first_occupied_cuda`); the CPU path reads the
    grid alone."""
    fn = kernels.dispatch(origins.device,
                          functools.partial(first_occupied_cuda, dist_field=dist_field),
                          first_occupied_plain)
    return fn(cfg, grid.occupancy, origins, dirs, t_entry, t_exit, nr_probes)


# ---------------------------------------------------------------------------
# Kernel I: the grid refresh from SDF probes
# ---------------------------------------------------------------------------

_WEYL_A, _WEYL_B = 2654435761, 340573321


def grid_points_plain(cfg: OccupancyGridConfig, nr_points: int, update_idx: int,
                      jitter=None, device=None):
    """Plain version of kernel I, entry 1 -> (centers [n, 3], lin [n] int32)."""
    if cfg.nr_voxels & (cfg.nr_voxels - 1):
        raise ValueError("the stratified grid sample needs a power-of-2 voxel count")
    k = torch.arange(nr_points, dtype=torch.int64, device=device)
    i = ((update_idx * nr_points) + k) & 0xFFFFFFFF
    # (i * a) mod 2^32 without int64 overflow: split a into 16-bit halves
    ia = (i * (_WEYL_A & 0xFFFF) + (((i * (_WEYL_A >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF
    lin = (ia + _WEYL_B) & (cfg.nr_voxels - 1)
    centers = lin_idx_to_voxel_center(cfg, lin)
    if jitter is not None:
        centers = centers + jitter * cfg.voxel_size
    return centers, lin.to(torch.int32)


def grid_points_cuda(cfg: OccupancyGridConfig, nr_points: int, update_idx: int,
                     jitter=None, device=None):
    """Kernel I launch, entry 1. Counts launches in ``grid_points_cuda.launches``."""
    device = torch.device(device)
    if jitter is not None:
        jitter = jitter.contiguous()
        if (jitter.shape != (nr_points, 3) or jitter.dtype != torch.float32
                or jitter.device.type != device.type):
            raise ValueError("grid points: jitter must be float32 [n, 3] on the device")
        device = jitter.device
    lin = torch.empty((nr_points,), dtype=torch.int32, device=device)
    centers = torch.empty((nr_points, 3), dtype=torch.float32, device=device)
    lib = kernels.load("occupancy_grid")
    tx, ty, tz = (float(v) for v in cfg.grid_translation)
    err = lib.psdf_grid_points(
        nr_points, int(update_idx) & 0xFFFFFFFF, cfg.nr_voxels_per_dim, cfg.voxel_size,
        cfg.grid_extent / 2.0, tx, ty, tz, kernels.ptr(jitter), kernels.ptr(lin),
        kernels.ptr(centers), kernels.current_stream(device))
    kernels.check(lib, err, "occupancy grid points (kernel I)")
    grid_points_cuda.launches += 1
    return centers, lin


grid_points_cuda.launches = 0


def _logistic_density(x, s):
    e = torch.exp(-s * x)
    return s * e / ((1.0 + e) * (1.0 + e))


def grid_update_plain(cfg: OccupancyGridConfig, grid: OccupancyGridState, lin, sdf,
                      inv_s: float, occupancy_thresh: float):
    """Plain version of kernel I, entry 2 (in place)."""
    sdf = sdf.reshape(-1)
    lin = lin.to(torch.int64)
    grid.values[lin] = sdf
    x = torch.clamp(torch.abs(sdf) - cfg.half_diagonal, 0.0, 1e10)
    s = torch.tensor(inv_s, dtype=torch.float32)
    grid.occupancy[lin] = _logistic_density(x, s) > occupancy_thresh
    return grid


def grid_update_cuda(cfg: OccupancyGridConfig, grid: OccupancyGridState, lin, sdf,
                     inv_s: float, occupancy_thresh: float):
    """Kernel I launch, entry 2 (in place). Counts launches in
    ``grid_update_cuda.launches``."""
    sdf = sdf.reshape(-1).contiguous()
    n = sdf.shape[0]
    dev = sdf.device
    if (lin.shape != (n,) or lin.dtype != torch.int32 or sdf.dtype != torch.float32
            or lin.device != dev or grid.values.device != dev
            or grid.occupancy.dtype != torch.bool or not grid.values.is_contiguous()
            or not grid.occupancy.is_contiguous()):
        raise ValueError("grid update: int32 ids, float32 sdf and the grid on one device")
    lib = kernels.load("occupancy_grid")
    err = lib.psdf_grid_update(
        n, kernels.ptr(lin.contiguous()), kernels.ptr(sdf), float(inv_s),
        float(cfg.half_diagonal), float(occupancy_thresh), kernels.ptr(grid.values),
        kernels.ptr(grid.occupancy), kernels.current_stream(dev))
    kernels.check(lib, err, "occupancy grid update (kernel I)")
    grid_update_cuda.launches += 1
    for t in (grid.values, grid.occupancy):
        torch.autograd.graph.increment_version(t)
    return grid


grid_update_cuda.launches = 0


def compute_stratified_sample_of_grid_points(cfg: OccupancyGridConfig, nr_points: int,
                                             update_idx: int, jitter=None, device=None):
    """Voxel sample of update ``update_idx``: ``lin = (a i + b) mod V`` for
    ``i`` in ``[k n, (k+1) n)`` (uint32; a bijection of the voxel ids), the
    voxel centers moved by ``jitter [n, 3]`` in [-0.5, 0.5) voxels (JAX's
    ``uniform(key, (n, 3), -0.5, 0.5)``). -> (centers [n, 3], lin [n] int32)."""
    fn = kernels.dispatch(device, grid_points_cuda, grid_points_plain)
    return fn(cfg, nr_points, update_idx, jitter, device)


def update_with_sdf_random_sample(cfg: OccupancyGridConfig, grid: OccupancyGridState,
                                  lin_indices, sdf, inv_s: float,
                                  occupancy_thresh: float = 1e-4) -> OccupancyGridState:
    """values[lin] = sdf; occupancy[lin] = logistic density of
    clip(|sdf| - half_diagonal, 0, 1e10) at ``inv_s`` > thresh. Updates
    ``grid`` in place and returns it."""
    fn = kernels.dispatch(grid.values.device, grid_update_cuda, grid_update_plain)
    return fn(cfg, grid, lin_indices, sdf, inv_s, occupancy_thresh)


# ---------------------------------------------------------------------------
# Kernel If: the flagship trainer's grid refresh in one launch
# ---------------------------------------------------------------------------

def _refresh_through(points_fn, update_fn, cfg: OccupancyGridConfig, grid: OccupancyGridState,
                     sdf_eval, ctx, nr_points: int, update_idx: int, jitter, inv_s: float,
                     occupancy_thresh: float):
    """Entry 1 (``points_fn``), the SDF ``sdf_eval(ctx, centers)``, entry 2
    (``update_fn``), in place."""
    centers, lin = points_fn(cfg, nr_points, update_idx, jitter, grid.values.device)
    with torch.no_grad():
        sdf = sdf_eval(ctx, centers)
    return update_fn(cfg, grid, lin, sdf, inv_s, occupancy_thresh)


def grid_refresh_plain(cfg: OccupancyGridConfig, grid: OccupancyGridState, sdf_eval, ctx,
                       nr_points: int, update_idx: int, jitter, inv_s: float,
                       occupancy_thresh: float):
    """Plain version of kernel If (in place): entry 1's plain version, the
    SDF ``sdf_eval(ctx, centers)`` of the probes, entry 2's plain version."""
    return _refresh_through(grid_points_plain, grid_update_plain, cfg, grid, sdf_eval, ctx,
                            nr_points, update_idx, jitter, inv_s, occupancy_thresh)


def _refresh_inputs(what: str, cfg: OccupancyGridConfig, grid: OccupancyGridState,
                    nr_points: int, jitter):
    """The grid's device and the contiguous jitter of a one-launch refresh
    (kernels If and I2f), after checking them."""
    dev = grid.values.device
    if (grid.values.dtype != torch.float32 or grid.occupancy.dtype != torch.bool
            or grid.occupancy.device != dev or not grid.values.is_contiguous()
            or not grid.occupancy.is_contiguous()):
        raise ValueError(f"{what}: float32 values and bool occupancy, contiguous, on one device")
    if cfg.nr_voxels & (cfg.nr_voxels - 1):
        raise ValueError("the stratified grid sample needs a power-of-2 voxel count")
    if jitter is not None:
        jitter = jitter.contiguous()
        if (jitter.shape != (nr_points, 3) or jitter.dtype != torch.float32
                or jitter.device != dev):
            raise ValueError(f"{what}: jitter must be float32 [n, 3] on the grid's device")
    return dev, jitter


def grid_refresh_cuda(cfg: OccupancyGridConfig, grid: OccupancyGridState, sdf_eval: SDFEval,
                      ctx, nr_points: int, update_idx: int, jitter, inv_s: float,
                      occupancy_thresh: float):
    """Kernel If launch (in place): the probes of update ``update_idx``,
    the SDF of ``sdf_eval`` (an :class:`SDFEval` with ``ctx = (params_sdf,
    iter_nr)``) at their centers and the update, in one launch. Counts
    launches in ``grid_refresh_cuda.launches``."""
    dev, jitter = _refresh_inputs("grid refresh", cfg, grid, nr_points, jitter)
    net, keep = sn.sdf_net(sdf_eval, ctx, dev)  # keep: the tensors net points at
    lib = kernels.load("occupancy_grid")
    tx, ty, tz = (float(v) for v in cfg.grid_translation)
    err = lib.psdf_grid_refresh(
        nr_points, int(update_idx) & 0xFFFFFFFF, cfg.nr_voxels_per_dim, cfg.voxel_size,
        cfg.grid_extent / 2.0, tx, ty, tz, kernels.ptr(jitter), ctypes.byref(net),
        float(inv_s), float(cfg.half_diagonal), float(occupancy_thresh),
        kernels.ptr(grid.values), kernels.ptr(grid.occupancy), kernels.current_stream(dev))
    kernels.check(lib, err, "occupancy grid refresh (kernel If)")
    grid_refresh_cuda.launches += 1
    for t in (grid.values, grid.occupancy):
        torch.autograd.graph.increment_version(t)
    return grid


grid_refresh_cuda.launches = 0


def refresh_with_sdf(cfg: OccupancyGridConfig, grid: OccupancyGridState, sdf_eval, ctx,
                     nr_points: int, update_idx: int, jitter, inv_s: float,
                     occupancy_thresh: float = 1e-4) -> OccupancyGridState:
    """The SDF-based refresh of ``nr_points`` voxels of update
    ``update_idx`` (jitter [n, 3] in [-0.5, 0.5) voxels, or None), in place:
    values[lin] = the SDF at the probe, occupancy[lin] = its logistic
    density at ``inv_s`` > thresh. For an :class:`SDFEval` that the fused
    kernels evaluate (``sdf_net.fused_sdf_supported``: every flagship
    config) kernel If on the card; otherwise entry 1, ``sdf_eval(ctx,
    centers)`` and entry 2. The CPU runs the plain versions. The route comes
    from the SDF's config and shapes, before any launch."""
    if isinstance(sdf_eval, SDFEval) and sn.fused_sdf_supported(sdf_eval.cfg, ctx[0]):
        fn = kernels.dispatch(grid.values.device, grid_refresh_cuda, grid_refresh_plain)
        return fn(cfg, grid, sdf_eval, ctx, nr_points, update_idx, jitter, inv_s,
                  occupancy_thresh)
    dev = grid.values.device
    return _refresh_through(kernels.dispatch(dev, grid_points_cuda, grid_points_plain),
                            kernels.dispatch(dev, grid_update_cuda, grid_update_plain), cfg,
                            grid, sdf_eval, ctx, nr_points, update_idx, jitter, inv_s,
                            occupancy_thresh)


# ---------------------------------------------------------------------------
# Kernel I2: the grid refresh from density probes (NeRF)
# ---------------------------------------------------------------------------

def density_update_plain(cfg: OccupancyGridConfig, grid: OccupancyGridState, lin, density,
                         decay: float, occupancy_thresh: float):
    """Plain version of kernel I2 (in place): the gather of the old values,
    then the scatter of the new ones."""
    density = density.reshape(-1)
    lin = lin.to(torch.int64)
    updated = torch.maximum(density, grid.values[lin] * decay)
    grid.values[lin] = updated
    grid.occupancy[lin] = updated > occupancy_thresh
    return grid


def density_update_cuda(cfg: OccupancyGridConfig, grid: OccupancyGridState, lin, density,
                        decay: float, occupancy_thresh: float):
    """Kernel I2 launch (in place; ``lin`` distinct, as the stratified probes
    of one refresh are). Counts launches in ``density_update_cuda.launches``."""
    density = density.reshape(-1).contiguous()
    n = density.shape[0]
    dev = density.device
    if (lin.shape != (n,) or lin.dtype != torch.int32 or density.dtype != torch.float32
            or lin.device != dev or grid.values.device != dev
            or grid.occupancy.dtype != torch.bool or not grid.values.is_contiguous()
            or not grid.occupancy.is_contiguous()):
        raise ValueError("density update: int32 ids, float32 density and the grid on one "
                         "device")
    lib = kernels.load("occupancy_grid")
    err = lib.psdf_density_update(
        n, kernels.ptr(lin.contiguous()), kernels.ptr(density), float(decay),
        float(occupancy_thresh), kernels.ptr(grid.values), kernels.ptr(grid.occupancy),
        kernels.current_stream(dev))
    kernels.check(lib, err, "occupancy density update (kernel I2)")
    density_update_cuda.launches += 1
    for t in (grid.values, grid.occupancy):
        torch.autograd.graph.increment_version(t)
    return grid


density_update_cuda.launches = 0


def update_with_density_random_sample(cfg: OccupancyGridConfig, grid: OccupancyGridState,
                                      lin_indices, density, decay: float = 0.7,
                                      occupancy_thresh: float = 1e-3) -> OccupancyGridState:
    """value = max(density, old * decay) and occupied = value > thresh at
    the probed voxels (distinct within one call). Updates ``grid`` in place
    and returns it."""
    fn = kernels.dispatch(grid.values.device, density_update_cuda, density_update_plain)
    return fn(cfg, grid, lin_indices, density, decay, occupancy_thresh)


# ---------------------------------------------------------------------------
# Kernel I2f: NeRF's grid refresh in one launch
# ---------------------------------------------------------------------------

def _density_refresh_through(points_fn, update_fn, cfg: OccupancyGridConfig,
                             grid: OccupancyGridState, field_cfg: NerfHashConfig, params, iter_nr,
                             nr_points: int, update_idx: int, jitter, decay: float,
                             occupancy_thresh: float):
    """Entry 1 (``points_fn``), ``nerf_hash_density`` of ``params`` at the
    probes, I2 (``update_fn``), in place."""
    centers, lin = points_fn(cfg, nr_points, update_idx, jitter, grid.values.device)
    with torch.no_grad():
        density = nerf_hash_density(params, centers, iter_nr, field_cfg)
    return update_fn(cfg, grid, lin, density, decay, occupancy_thresh)


def density_refresh_plain(cfg: OccupancyGridConfig, grid: OccupancyGridState,
                          field_cfg: NerfHashConfig, params, iter_nr, nr_points: int,
                          update_idx: int, jitter, decay: float, occupancy_thresh: float):
    """Plain version of kernel I2f (in place): entry 1's plain version,
    ``nerf_hash_density`` of the probes, I2's plain version."""
    return _density_refresh_through(grid_points_plain, density_update_plain, cfg, grid,
                                    field_cfg, params, iter_nr, nr_points, update_idx, jitter,
                                    decay, occupancy_thresh)


def density_refresh_cuda(cfg: OccupancyGridConfig, grid: OccupancyGridState,
                         field_cfg: NerfHashConfig, params, iter_nr, nr_points: int,
                         update_idx: int, jitter, decay: float, occupancy_thresh: float):
    """Kernel I2f launch (in place): the probes of update ``update_idx``,
    the density of the NerfHash model ``params`` (config ``field_cfg``) at
    ``iter_nr`` there and I2's update, in one launch. Counts launches in
    ``density_refresh_cuda.launches``."""
    dev, jitter = _refresh_inputs("density refresh", cfg, grid, nr_points, jitter)
    net, keep = sn.density_net(field_cfg, params, iter_nr, dev)  # keep: what net points at
    lib = kernels.load("occupancy_grid")
    tx, ty, tz = (float(v) for v in cfg.grid_translation)
    err = lib.psdf_density_refresh(
        nr_points, int(update_idx) & 0xFFFFFFFF, cfg.nr_voxels_per_dim, cfg.voxel_size,
        cfg.grid_extent / 2.0, tx, ty, tz, kernels.ptr(jitter), ctypes.byref(net), float(decay),
        float(occupancy_thresh), kernels.ptr(grid.values), kernels.ptr(grid.occupancy),
        kernels.current_stream(dev))
    kernels.check(lib, err, "occupancy density refresh (kernel I2f)")
    density_refresh_cuda.launches += 1
    for t in (grid.values, grid.occupancy):
        torch.autograd.graph.increment_version(t)
    return grid


density_refresh_cuda.launches = 0


def refresh_with_density(cfg: OccupancyGridConfig, grid: OccupancyGridState,
                         field_cfg: NerfHashConfig, params, iter_nr, nr_points: int,
                         update_idx: int, jitter, decay: float = 0.7,
                         occupancy_thresh: float = 1e-3) -> OccupancyGridState:
    """NeRF's density refresh of ``nr_points`` voxels of update
    ``update_idx`` (jitter [n, 3] in [-0.5, 0.5) voxels, or None), in place:
    value = max(density, old * decay) and occupied = value > thresh, the
    density that of the NerfHash model ``params`` at ``iter_nr``. For a
    field kernel I2f evaluates (``sdf_net.fused_density_supported``: every
    foreground ``NerfHashConfig``) kernel I2f on the card; otherwise entry
    1, ``nerf_hash_density`` and I2. The CPU runs the plain versions. The
    route comes from the config and the parameters' shapes, before any
    launch."""
    args = (field_cfg, params, iter_nr, nr_points, update_idx, jitter, decay, occupancy_thresh)
    if sn.fused_density_supported(field_cfg, params):
        fn = kernels.dispatch(grid.values.device, density_refresh_cuda, density_refresh_plain)
        return fn(cfg, grid, *args)
    dev = grid.values.device
    return _density_refresh_through(kernels.dispatch(dev, grid_points_cuda, grid_points_plain),
                                    kernels.dispatch(dev, density_update_cuda,
                                                     density_update_plain), cfg, grid, *args)


# ---------------------------------------------------------------------------
# Kernel J0: the Chebyshev empty-space distance field
# ---------------------------------------------------------------------------

def chebyshev_field_plain(cfg: OccupancyGridConfig, occupancy, max_dist: int):
    """Plain version of kernel J0, the JAX op's form: ``max_dist`` sweeps of
    d = min(d, 3x3x3 min-pool of d + 1) from 0 (occupied) / max_dist, the
    voxels outside the grid ignored. -> [V^3] uint8."""
    v = cfg.nr_voxels_per_dim
    d = torch.where(occupancy.reshape(1, 1, v, v, v), 0.0, float(max_dist))
    for _ in range(max_dist):
        d = torch.minimum(d, 1.0 - F.max_pool3d(-d, 3, stride=1, padding=1))
    return d.reshape(-1).to(torch.uint8)


def chebyshev_field_cuda(cfg: OccupancyGridConfig, occupancy, max_dist: int):
    """Kernel J0 launch (three separable passes in one call). Counts
    launches in ``chebyshev_field_cuda.launches``."""
    nv = cfg.nr_voxels
    if (occupancy.dtype != torch.bool or occupancy.numel() != nv
            or not occupancy.is_contiguous()):
        raise ValueError("distance field: occupancy must be a contiguous bool [V^3] tensor")
    field = torch.empty((nv,), dtype=torch.uint8, device=occupancy.device)
    scratch = torch.empty_like(field)
    lib = kernels.load("sphere_trace")
    err = lib.psdf_chebyshev_field(cfg.nr_voxels_per_dim, int(max_dist), kernels.ptr(occupancy),
                                   kernels.ptr(scratch), kernels.ptr(field),
                                   kernels.current_stream(occupancy.device))
    kernels.check(lib, err, "Chebyshev distance field (kernel J0)")
    chebyshev_field_cuda.launches += 1
    return field


chebyshev_field_cuda.launches = 0


def chebyshev_empty_distance(cfg: OccupancyGridConfig, occupancy: torch.Tensor,
                             max_dist: int = 15) -> torch.Tensor:
    """[V^3] uint8: the L-inf voxel distance to the nearest occupied voxel,
    capped at ``max_dist`` (0 = occupied; at most 255). A point in a voxel
    at distance k can advance (k - 1) voxels along any ray without entering
    occupied space. The JAX op returns the same values as int32."""
    if not 0 <= max_dist <= 255:
        raise ValueError("distance field: max_dist must fit in a byte")
    fn = kernels.dispatch(occupancy.device, chebyshev_field_cuda, chebyshev_field_plain)
    return fn(cfg, occupancy, max_dist)


def empty_distance_at(cfg: OccupancyGridConfig, dist_field: torch.Tensor,
                      points: torch.Tensor, max_dist: int = 15) -> torch.Tensor:
    """[N] int32 voxel distances at world points (out-of-grid -> max_dist)."""
    lin, in_bounds = point_to_lin_idx(cfg, points)
    return torch.where(in_bounds, dist_field[lin].to(torch.int32), max_dist)


# ---------------------------------------------------------------------------
# Plain PyTorch only: no tracer or trainer of the JAX package calls these
# ---------------------------------------------------------------------------

def compute_random_sample_of_grid_points(cfg: OccupancyGridConfig, nr_points: int,
                                         generator=None, jitter: bool = True, draws=None,
                                         device=None):
    """Random voxel centres, moved within their voxel with ``jitter`` ->
    (centers [n, 3], lin [n] int64). ``draws = (lin [n], mov [n, 3])``
    (JAX's ``randint(k_idx, (n,), 0, V^3)`` and ``uniform(k_jit, (n, 3),
    -0.5, 0.5)``), else drawn from ``generator`` on the CPU."""
    if draws is None:
        draws = (torch.randint(0, cfg.nr_voxels, (nr_points,), generator=generator),
                 torch.rand((nr_points, 3), generator=generator) - 0.5)
    lin, mov = (t.to(device) for t in draws)
    centers = lin_idx_to_voxel_center(cfg, lin.to(torch.int64))
    if jitter:
        centers = centers + mov * cfg.voxel_size
    return centers, lin


def mip_config(cfg: OccupancyGridConfig, factor: int) -> OccupancyGridConfig:
    """The config of the ``factor``x downsampled grid (same extent and
    translation)."""
    if cfg.nr_voxels_per_dim % factor:
        raise ValueError("mip_config: the factor must divide the grid size")
    return dataclasses.replace(cfg, nr_voxels_per_dim=cfg.nr_voxels_per_dim // factor)


def downsample_occupancy(cfg: OccupancyGridConfig, occupancy: torch.Tensor,
                         factor: int) -> torch.Tensor:
    """Conservative occupancy mip: a coarse voxel is occupied iff any of its
    factor^3 fine voxels is. Row-major [V^3] -> [(V/f)^3]."""
    c = cfg.nr_voxels_per_dim // factor
    occ = occupancy.reshape(c, factor, c, factor, c, factor)
    return occ.any(dim=5).any(dim=3).any(dim=1).reshape(-1)


def advance_sample_to_next_occupied_voxel(cfg: OccupancyGridConfig, grid: OccupancyGridState,
                                          dirs, pos, max_steps: int = 48):
    """From ``pos`` along ``dirs``, probe ``max_steps`` points half a voxel
    apart (the first at ``pos``) and move to the first occupied one; without
    one, past the probed span -> (new_pos [N, 3], is_within_grid_bounds [N]:
    an occupied probe was found or the span's far end is in the grid)."""
    step = cfg.voxel_size * 0.5
    ts = torch.arange(max_steps, dtype=torch.float32, device=pos.device) * step
    probes = (pos[:, None, :] + ts[None, :, None] * dirs[:, None, :]).reshape(-1, 3)
    occ = check_occupancy(cfg, grid, probes).reshape(pos.shape[0], max_steps)
    _, in_bounds = point_to_lin_idx(cfg, probes)
    in_bounds = in_bounds.reshape(pos.shape[0], max_steps)
    found = torch.any(occ, dim=-1)
    t_jump = ts[torch.argmax(occ.to(torch.uint8), dim=-1)]
    t_adv = torch.where(found, t_jump, ts[-1] + step)
    return pos + t_adv[:, None] * dirs, found | in_bounds[:, -1]
