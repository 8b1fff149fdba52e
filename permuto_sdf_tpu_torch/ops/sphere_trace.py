"""Host-adaptive sphere tracing, the interactive render's tracer
(counterpart of ``permuto_sdf_tpu/ops/sphere_trace.py``:
``sphere_trace_adaptive`` and its helpers, on one device).

Every ray keeps its state in full-size tensors padded by one row (index R,
never alive) that the bucket's fill slots point at: the distance ``t``
along the ray, ``alive``, ``conv`` (converged) and the last ``sdf``. Each
round, the host sizes a bucket from the active count it fetched, kernel H0
(``ops/compaction.py``) lists the active rays into it, and ``iters`` times
the SDF is evaluated at the bucket's positions (kernel A and the MLP) and
kernel J2 updates the state in place: the step ``t + s * mult``, the
convergence test, the chained empty-space jumps through the Chebyshev
field (kernel J0, ``ops/occupancy_grid.py``) and the death past the bound.
Kernel J1 is the jump-only prepass before round 0. The host fetches two
counts per round and nothing else. The plain PyTorch versions of J1 and J2
below are the CPU path and the kernels' reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.ops import occupancy_grid as og
from permuto_sdf_tpu_torch.ops.compaction import nonzero_static

# The distance field's cap: also the largest empty-space jump, in voxels.
_EMPTY_DIST_CAP = 63


def pow2_bucket(n: int, lo: int = 256, hi: int = 1 << 22) -> int:
    """Snap n up to the next bucket in the {2^k, 1.5*2^k} ladder (max 1.5x
    overshoot)."""
    b = lo
    while b < n and b < hi:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else b * 4 // 3
    return min(b, hi)


def _check_time(time_val):
    if time_val is not None:
        raise NotImplementedError("time_val: tracing the 4D SDF's time sweep belongs to the "
                                  "4D trainer (ROADMAP Queue 1 item 5), not ported yet")


def _grid_distance_field(grid_cfg: og.OccupancyGridConfig, grid: og.OccupancyGridState):
    return og.chebyshev_empty_distance(grid_cfg, grid.occupancy, _EMPTY_DIST_CAP)


def _padded(x, fill=0.0):
    pad = torch.full((1,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], 0)


def _grid_scalars(grid_cfg):
    """(V, half extent, translation x/y/z, voxel size) of the kernels'
    field lookup (zeros without a grid)."""
    if grid_cfg is None:
        return (0,) + (0.0,) * 5
    tx, ty, tz = (float(v) for v in grid_cfg.grid_translation)
    return (grid_cfg.nr_voxels_per_dim, grid_cfg.grid_extent / 2.0, tx, ty, tz,
            grid_cfg.voxel_size)


def _jump(grid_cfg, dist_field, origins, dirs, t, allow):
    """One chained empty-space jump: t + max(k - 1, 0) voxels where allowed."""
    k = og.empty_distance_at(grid_cfg, dist_field, origins + t[:, None] * dirs,
                             _EMPTY_DIST_CAP)
    jump = torch.clamp(k - 1, min=0).to(t.dtype) * grid_cfg.voxel_size
    return torch.where(allow, t + jump, t)


def _check_state(what, dev, floats=(), flags=()):
    for t in floats:
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: float32 contiguous state on one device")
    for t in flags:
        if t.dtype != torch.bool or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: bool contiguous flags on one device")


# ---------------------------------------------------------------------------
# Kernel J1: the jump-only prepass
# ---------------------------------------------------------------------------

def jump_prepass_plain(dist_field, origins_f, dirs_f, texit_f, t_f, alive_f, grid_cfg,
                       jumps: int):
    """Plain version of kernel J1, in place on ``t_f`` and ``alive_f`` ->
    the alive count of the rows below R ([] int32)."""
    t = t_f
    for _ in range(jumps):
        t = _jump(grid_cfg, dist_field, origins_f, dirs_f, t, alive_f)
    t_f.copy_(t)
    alive_f &= t_f <= texit_f
    return alive_f[:-1].sum().to(torch.int32)


def jump_prepass_cuda(dist_field, origins_f, dirs_f, texit_f, t_f, alive_f, grid_cfg,
                      jumps: int):
    """Kernel J1 launch. Counts launches in ``jump_prepass_cuda.launches``."""
    dev = t_f.device
    _check_state("jump prepass", dev, (origins_f, dirs_f, texit_f, t_f), (alive_f,))
    if dist_field.dtype != torch.uint8 or dist_field.device != dev:
        raise ValueError("jump prepass: the distance field must be uint8 on the state's device")
    n_rows = t_f.shape[0]
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = kernels.load("sphere_trace")
    err = lib.psdf_jump_prepass(
        n_rows, n_rows - 1, kernels.ptr(dist_field.contiguous()), *_grid_scalars(grid_cfg),
        _EMPTY_DIST_CAP, kernels.ptr(origins_f), kernels.ptr(dirs_f), kernels.ptr(texit_f),
        kernels.ptr(t_f), kernels.ptr(alive_f), int(jumps), kernels.ptr(count),
        kernels.current_stream(dev))
    kernels.check(lib, err, "sphere-trace jump prepass (kernel J1)")
    jump_prepass_cuda.launches += 1
    return count.reshape(())


jump_prepass_cuda.launches = 0


# ---------------------------------------------------------------------------
# Kernel J2: one trace iteration of a bucket after its SDF values
# ---------------------------------------------------------------------------

def trace_step_plain(idx, s, origins_f, dirs_f, texit_f, t_f, alive_f, conv_f, sdf_f,
                     dist_field, grid_cfg, sdf_multiplier: float, sdf_converged_tresh: float,
                     jump_substeps: int, jump_gate: float, counts: bool = False):
    """Plain version of kernel J2. With ``s [B]`` (the SDF at the bucket's
    positions) one trace iteration of the rays ``idx [B]`` (fill slots
    point at the pad row), in place on the state; without, nothing changes.
    -> (the bucket's positions o + t d [B, 3], and with ``counts`` the
    bucket's (active, converged) alive rays [2] int32, else None)."""
    R = t_f.shape[0] - 1
    o, d, t = origins_f[idx], dirs_f[idx], t_f[idx]
    alive, conv = alive_f[idx] & (idx < R), conv_f[idx]
    if s is not None:
        sdf = sdf_f[idx]
        act = ~conv & alive
        sdf = torch.where(act, s, sdf)
        conv = conv | ((torch.abs(s) < sdf_converged_tresh) & alive)
        act = ~conv & alive
        t_new = t + s * sdf_multiplier
        if dist_field is not None:
            allow = act & (s > jump_gate)
            t_new = torch.where(act, t_new, t)
            for _ in range(jump_substeps):
                t_new = _jump(grid_cfg, dist_field, o, d, t_new, allow)
        dead = t_new > texit_f[idx]
        alive = alive & (conv | ~dead)
        t = torch.where(act, t_new, t)
        # fill slots write the pad row's own values back
        t_f[idx], alive_f[idx], conv_f[idx], sdf_f[idx] = t, alive, conv, sdf
    pos = o + t[:, None] * d
    if not counts:
        return pos, None
    return pos, torch.stack([(alive & ~conv).sum(), (alive & conv).sum()]).to(torch.int32)


def trace_step_cuda(idx, s, origins_f, dirs_f, texit_f, t_f, alive_f, conv_f, sdf_f,
                    dist_field, grid_cfg, sdf_multiplier: float, sdf_converged_tresh: float,
                    jump_substeps: int, jump_gate: float, counts: bool = False):
    """Kernel J2 launch. Counts launches in ``trace_step_cuda.launches``."""
    dev = t_f.device
    B = idx.shape[0]
    s = s.contiguous() if s is not None else None
    _check_state("trace step", dev, (origins_f, dirs_f, texit_f, t_f, sdf_f)
                 + ((s,) if s is not None else ()), (alive_f, conv_f))
    if idx.dtype != torch.int64 or idx.device != dev or (s is not None and s.shape != (B,)):
        raise ValueError("trace step: int64 bucket ids and [B] sdf values on the state's device")
    if dist_field is not None and (dist_field.dtype != torch.uint8 or dist_field.device != dev):
        raise ValueError("trace step: the distance field must be uint8 on the state's device")
    pos = torch.empty((B, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((2,), dtype=torch.int32, device=dev) if counts else None
    lib = kernels.load("sphere_trace")
    err = lib.psdf_trace_step(
        B, t_f.shape[0] - 1, kernels.ptr(idx.contiguous()), kernels.ptr(s),
        kernels.ptr(origins_f), kernels.ptr(dirs_f), kernels.ptr(texit_f), kernels.ptr(t_f),
        kernels.ptr(alive_f), kernels.ptr(conv_f), kernels.ptr(sdf_f),
        kernels.ptr(dist_field.contiguous() if dist_field is not None else None),
        *_grid_scalars(grid_cfg if dist_field is not None else None), _EMPTY_DIST_CAP,
        float(sdf_multiplier), float(sdf_converged_tresh), float(jump_gate),
        int(jump_substeps), kernels.ptr(pos), kernels.ptr(cnt), kernels.current_stream(dev))
    kernels.check(lib, err, "sphere-trace step (kernel J2)")
    trace_step_cuda.launches += 1
    return pos, cnt


trace_step_cuda.launches = 0


# ---------------------------------------------------------------------------
# The rounds
# ---------------------------------------------------------------------------

def _trace_rounds_impl(sdf_eval, ctx, origins_f, dirs_f, texit_f, dist_field,
                       t_f, alive_f, conv_f, sdf_f, grid_cfg,
                       iters: int, bucket: int, sdf_multiplier: float,
                       sdf_converged_tresh: float, time_val,
                       jump_substeps: int = 1, jump_gate: float = 0.0):
    """``iters`` trace steps on a host-sized bucket of the active rays
    (alive, not converged), in place on the full-size state. Returns the
    state and the bucket's counts [2] (still active, converged and alive):
    every active ray is in the bucket, so the first is the frame's active
    count; the frame's hits are the second plus those before the round."""
    _check_time(time_val)
    R = t_f.shape[0] - 1
    idx, _ = nonzero_static(alive_f[:R] & ~conv_f[:R], bucket, fill_value=R)
    if grid_cfg is None:
        dist_field = None
    step = kernels.dispatch(t_f.device, trace_step_cuda, trace_step_plain)
    args = (origins_f, dirs_f, texit_f, t_f, alive_f, conv_f, sdf_f, dist_field, grid_cfg,
            sdf_multiplier, sdf_converged_tresh, jump_substeps, jump_gate)
    pos, counts = step(idx, None, *args, counts=iters == 0)
    for i in range(iters):
        s = sdf_eval(ctx, pos).reshape(-1)
        pos, counts = step(idx, s, *args, counts=i == iters - 1)
    return t_f, alive_f, conv_f, sdf_f, counts


def _jump_prepass_impl(dist_field, origins_f, dirs_f, texit_f, t_f, alive_f,
                       grid_cfg, jumps: int):
    """``jumps`` chained empty-space jumps on every alive ray, no SDF
    evaluation: a ray parks at the occupied shell or leaves the bound and
    dies. In place; returns (t_f, alive_f, the alive count [] int32)."""
    fn = kernels.dispatch(t_f.device, jump_prepass_cuda, jump_prepass_plain)
    count = fn(dist_field, origins_f, dirs_f, texit_f, t_f, alive_f, grid_cfg, jumps)
    return t_f, alive_f, count


def _refresh_sdf_impl(sdf_eval, ctx, pos_f, mask_f, sdf_f, bucket: int, time_val):
    """Re-evaluate the sdf at the final position of the masked rays, in
    place (bucket sized by the host from the true count)."""
    _check_time(time_val)
    R = pos_f.shape[0] - 1
    idx, _ = nonzero_static(mask_f[:R], bucket, fill_value=R)
    s = sdf_eval(ctx, pos_f[idx]).reshape(-1)
    sdf_f[idx] = torch.where(idx < R, s, sdf_f[idx])
    return sdf_f


def sphere_trace_adaptive(
    sdf_eval,                    # (ctx, pts [N, 3]) -> sdf [N]
    ctx,
    ray_origins, ray_dirs, boundary_primitive,
    nr_rounds: int = 5,
    iters_per_round: int = 3,
    sdf_multiplier: float = 0.9,
    sdf_converged_tresh: float = 2e-4,
    grid_cfg: Optional[og.OccupancyGridConfig] = None,
    grid: Optional[og.OccupancyGridState] = None,
    time_val: Optional[float] = None,
    refine_sdf_eval=None,        # full-res sdf for the LOD refinement
    refine_ctx=None,
    nr_refine_iters: int = 3,
    min_bucket: int = 256,
    dist_field=None,             # a precomputed _grid_distance_field(grid_cfg, grid)
    return_n_hit: bool = False,
    round_sdf_evals: tuple = (),  # per-round eval override (LOD schedule)
    final_refresh: bool = True,
    jump_substeps: int = 1,      # chained empty-space jumps per SDF eval
    prepass_jumps: int = 0,      # jump-only prepass before round 0
    jump_gate_voxels: float = 1.0,  # jumps only while sdf > this many voxels
    stats_out: Optional[list] = None,  # appended: (stage, bucket, n_active, n_hit)
):
    """Sphere tracing with host-sized compaction: every round lists the
    active rays into a bucket from the {2^k, 1.5*2^k} ladder, so no ray is
    dropped however much of the frame is foreground. Empty space is skipped
    through the grid's Chebyshev distance field (built here unless
    ``dist_field`` is given). LOD: march with a cheap ``sdf_eval`` (or one
    per round, ``round_sdf_evals``), then re-open every alive ray for
    ``nr_refine_iters`` steps of ``refine_sdf_eval``.

    Returns (pos [R,3], sdf [R], converged [R], within_bounds [R]) (+ the
    alive count when ``return_n_hit``)."""
    _check_time(time_val)
    R = ray_origins.shape[0]
    _, t_entry_c, _, t_exit_c, hit = boundary_primitive.ray_intersection(ray_origins, ray_dirs)
    if grid is not None and grid_cfg is not None and dist_field is None:
        dist_field = _grid_distance_field(grid_cfg, grid)
    if grid is None or grid_cfg is None:
        dist_field = None

    origins_f = _padded(ray_origins.contiguous())
    dirs_f = _padded(ray_dirs.contiguous())
    texit_f = _padded(t_exit_c[:, 0])
    t_f = _padded(t_entry_c[:, 0])
    alive_f = _padded(hit[:, 0], False)
    conv_f = torch.zeros_like(alive_f)
    sdf_f = torch.zeros_like(t_f)

    if prepass_jumps > 0 and dist_field is not None:
        t_f, alive_f, n_act = _jump_prepass_impl(dist_field, origins_f, dirs_f, texit_f, t_f,
                                                 alive_f, grid_cfg, prepass_jumps)
        n_active = int(n_act)
    else:
        n_active = int(alive_f[:R].sum())
    n_hit = 0
    jump_gate = (float(jump_gate_voxels) * grid_cfg.voxel_size
                 if grid_cfg is not None else 0.0)
    trace = dict(sdf_multiplier=sdf_multiplier, sdf_converged_tresh=sdf_converged_tresh,
                 time_val=None, jump_substeps=jump_substeps, jump_gate=jump_gate)
    for rnd in range(nr_rounds):
        if n_active == 0:
            break
        ev = round_sdf_evals[rnd] if rnd < len(round_sdf_evals) else sdf_eval
        bucket = pow2_bucket(n_active, lo=min_bucket, hi=max(min_bucket, R))
        t_f, alive_f, conv_f, sdf_f, counts = _trace_rounds_impl(
            ev, ctx, origins_f, dirs_f, texit_f, dist_field, t_f, alive_f, conv_f, sdf_f,
            grid_cfg, iters_per_round, bucket, **trace)
        n_active, new_hits = counts.tolist()  # the round's one host fetch
        n_hit += new_hits
        if stats_out is not None:
            stats_out.append((f"round{rnd}", bucket, n_active, n_hit))

    n_alive = n_active + n_hit
    if refine_sdf_eval is not None and n_alive > 0:
        # re-open every alive ray (converged hits and the stragglers) and
        # march it with the full-resolution field
        open_f = alive_f.clone()
        bucket = pow2_bucket(n_alive, lo=min_bucket, hi=max(min_bucket, R))
        t_f, alive_ref, conv_ref, sdf_f, counts = _trace_rounds_impl(
            refine_sdf_eval, refine_ctx, origins_f, dirs_f, texit_f, dist_field, t_f,
            alive_f, torch.zeros_like(conv_f), sdf_f, grid_cfg, nr_refine_iters, bucket,
            **trace)
        conv_f = torch.where(open_f, conv_ref & alive_ref, conv_f)
        alive_f = torch.where(open_f, alive_ref, open_f)
        n_active, n_hit = counts.tolist()
        n_alive = n_active + n_hit
        if stats_out is not None:
            stats_out.append(("refine", bucket, n_active, n_hit))
        final_eval, final_ctx = refine_sdf_eval, refine_ctx
    else:
        final_eval, final_ctx = sdf_eval, ctx

    pos_f = origins_f + t_f[:, None] * dirs_f
    # final_refresh=False skips the last-position sdf re-evaluation: callers
    # that shade the hits right after recompute the sdf anyway
    if final_refresh and n_alive > 0:
        bucket = pow2_bucket(n_alive, lo=min_bucket, hi=max(min_bucket, R))
        sdf_f = _refresh_sdf_impl(final_eval, final_ctx, pos_f, alive_f, sdf_f, bucket, None)

    out = (pos_f[:R], sdf_f[:R], (conv_f & alive_f)[:R], alive_f[:R])
    return out + (n_alive,) if return_n_hit else out
