"""Sphere tracing (counterpart of ``permuto_sdf_tpu/ops/sphere_trace.py``
on one device): the host-adaptive tracer of the interactive render,
``sphere_trace_adaptive`` and its helpers, and the plain tracers
``sphere_trace`` and ``sphere_trace_compacted`` with
``filter_unconverged_points``.

Every ray keeps its state in full-size tensors padded by one row (index R,
never alive) that the bucket's fill slots point at: the distance ``t``
along the ray, ``alive``, ``conv`` (converged) and the last ``sdf``. Each
round, the host sizes a bucket from the active count it fetched, kernel H0
(``ops/compaction.py``) lists the active rays into it, and ``iters`` times
the SDF is evaluated at the bucket's positions (kernel A and the MLP) and
kernel J2 updates the state in place: the step ``t + s * mult``, the
convergence test, the chained empty-space jumps through the Chebyshev
field (kernel J0, ``ops/occupancy_grid.py``) and the death past the bound.
Kernel J1 is the jump-only prepass before round 0; its second launch
lists round 0's bucket, so round 0 runs no H0. The host fetches two
counts per round and nothing else. The plain PyTorch versions of J1 and J2
below are the CPU path and the kernels' reference.

The plain tracers keep the JAX tracers' position state (``pos``, ``alive``,
``conv``, and in the compacted tracer the last ``sdf``): they are seeded at
the bound's entry or, with a grid, half a voxel past the start of the first
occupied probe segment (kernel C3, ``ops/occupancy_grid.py``), and each
iteration after the SDF is kernel J3, which steps, tests convergence, takes
one Chebyshev jump gated on ``sdf > voxel_size`` and kills rays that leave
the bound sphere. ``sphere_trace`` runs all ``nr_sphere_traces`` iterations
on every ray: JAX's loop stops early once no ray is active, and every
iteration after that leaves the state as it is, so the result is the same
without a host read per iteration. ``sphere_trace_compacted`` lists its
active rays into buckets of the JAX op's static sizes (kernel H0) and
launches J3 on the bucket, in place on the padded full-size state.

For the flagship SDF the loops run on the card in one launch each, with
the SDF evaluated inside it: given an
:class:`~permuto_sdf_tpu_torch.models.fields.SDFEval` (and its ctx, the
SDF's params and iteration), ``sphere_trace`` and
``sphere_trace_compacted`` launch kernel J3f once a trace (once a round
compacted), and ``sphere_trace_adaptive`` launches kernel J2f once a
round (the trainer's LOD evaluations are such descriptors). An opaque
``sdf_fn`` or ``sdf_eval`` keeps the loop of SDF calls and J3 or J2
launches, and the CPU always runs the plain loop, which is also the fused
kernels' reference.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.models.fields import SDFEval
from permuto_sdf_tpu_torch.ops import occupancy_grid as og
from permuto_sdf_tpu_torch.ops import sdf_net as sn
from permuto_sdf_tpu_torch.ops.compaction import nonzero_static, nonzero_static_plain
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere

# The distance field's cap: also the largest empty-space jump, in voxels.
_EMPTY_DIST_CAP = 63
# Kernel J1's rows a block (kJumpRows in csrc/sphere_trace.cu).
PREPASS_ROWS = 256


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
                       jumps: int, list_size: Optional[int] = None):
    """Plain version of kernel J1, in place on ``t_f`` and ``alive_f`` ->
    (the alive count of the rows below R [] int32, round 0's list
    [list_size] int64: those rows in ascending order, then the fill R).
    ``list_size`` (default R) is at least R."""
    R = t_f.shape[0] - 1
    t = t_f
    for _ in range(jumps):
        t = _jump(grid_cfg, dist_field, origins_f, dirs_f, t, alive_f)
    t_f.copy_(t)
    alive_f &= t_f <= texit_f
    idx, count = nonzero_static_plain(alive_f[:R], R if list_size is None else list_size, R)
    return count, idx


def jump_prepass_cuda(dist_field, origins_f, dirs_f, texit_f, t_f, alive_f, grid_cfg,
                      jumps: int, list_size: Optional[int] = None):
    """Kernel J1's launches (the jumps, then round 0's list from their tile
    counts): same returns as :func:`jump_prepass_plain`. Counts its calls
    (two kernel launches each) in ``jump_prepass_cuda.launches``."""
    dev = t_f.device
    _check_state("jump prepass", dev, (origins_f, dirs_f, texit_f, t_f), (alive_f,))
    if dist_field.dtype != torch.uint8 or dist_field.device != dev:
        raise ValueError("jump prepass: the distance field must be uint8 on the state's device")
    n_rows = t_f.shape[0]
    R = n_rows - 1
    list_size = R if list_size is None else int(list_size)
    if list_size < R or max(n_rows, list_size) >= 2 ** 31:
        raise ValueError("jump prepass: the list holds at least the R rows, fewer than 2^31")
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    idx = torch.empty((list_size,), dtype=torch.int64, device=dev)
    tile_counts = torch.empty((-(-n_rows // PREPASS_ROWS),), dtype=torch.int32, device=dev)
    lib = kernels.load("sphere_trace")
    err = lib.psdf_jump_prepass(
        n_rows, R, list_size, kernels.ptr(dist_field.contiguous()), *_grid_scalars(grid_cfg),
        _EMPTY_DIST_CAP, kernels.ptr(origins_f), kernels.ptr(dirs_f), kernels.ptr(texit_f),
        kernels.ptr(t_f), kernels.ptr(alive_f), int(jumps), kernels.ptr(count),
        kernels.ptr(idx), kernels.ptr(tile_counts), kernels.current_stream(dev))
    kernels.check(lib, err, "sphere-trace jump prepass (kernel J1)")
    jump_prepass_cuda.launches += 1
    return count.reshape(()), idx


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
# Kernel J3: one iteration of the plain tracers, on position state
# ---------------------------------------------------------------------------

def _sphere_bound(prim):
    """(center, radius^2) of the bound sphere J3's death test reads."""
    if not isinstance(prim, Sphere):
        raise NotImplementedError("the plain sphere tracers take a Sphere bound (kernel J3 "
                                  "kills a ray when it leaves the sphere)")
    return tuple(float(c) for c in prim.center), float(prim.radius) ** 2


def trace_step_pos_plain(idx, s, dirs_f, pos_f, alive_f, conv_f, sdf_f, dist_field, grid_cfg,
                         sdf_multiplier: float, sdf_converged_tresh: float, bound,
                         pos_out: bool = False):
    """Plain version of kernel J3. With the index list ``idx [B]`` (fill
    slots point at the last row of the state, which is never alive) the
    rows ``idx``, else the B = len(s) rows of the state, take one iteration
    with ``s [B]``, the SDF at their positions, in place; ``sdf_f`` (or
    None) stores s where the row was active. -> the slots' new positions
    [B, 3] with ``pos_out``, else None."""
    R = pos_f.shape[0] - 1 if idx is not None else pos_f.shape[0]
    rows = idx if idx is not None else torch.arange(R, device=pos_f.device)
    d, pos = dirs_f[rows], pos_f[rows]
    alive, conv = alive_f[rows] & (rows < R), conv_f[rows]
    act = ~conv & alive
    new = torch.where(act[:, None], pos + d * (s * sdf_multiplier)[:, None], pos)
    conv = conv | ((torch.abs(s) < sdf_converged_tresh) & alive)
    if dist_field is not None:
        k = og.empty_distance_at(grid_cfg, dist_field, new, _EMPTY_DIST_CAP)
        jump = torch.clamp(k - 1, min=0).to(new.dtype) * grid_cfg.voxel_size
        move = ~conv & alive & (s > grid_cfg.voxel_size)
        new = torch.where(move[:, None], new + jump[:, None] * d, new)
    center, r2 = bound
    # the squared norm summed in the kernel's order, which torch.sum's
    # reduction on the card need not keep
    e = new - torch.tensor(center, dtype=new.dtype, device=new.device)
    inside = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2] < r2
    alive = alive & (conv | inside)
    # fill slots write the fill row's own values back
    pos_f[rows], alive_f[rows], conv_f[rows] = new, alive, conv
    if sdf_f is not None:
        sdf_f[rows] = torch.where(act, s, sdf_f[rows])
    return new if pos_out else None


def trace_step_pos_cuda(idx, s, dirs_f, pos_f, alive_f, conv_f, sdf_f, dist_field, grid_cfg,
                        sdf_multiplier: float, sdf_converged_tresh: float, bound,
                        pos_out: bool = False):
    """Kernel J3 launch. Counts launches in ``trace_step_pos_cuda.launches``."""
    dev = pos_f.device
    B = s.shape[0]
    s = s.contiguous()
    _check_state("plain trace step", dev, (s, dirs_f, pos_f) + ((sdf_f,) if sdf_f is not None
                                                                else ()), (alive_f, conv_f))
    R = pos_f.shape[0] - 1 if idx is not None else pos_f.shape[0]
    if idx is not None and (idx.dtype != torch.int64 or idx.device != dev
                            or idx.shape != (B,)):
        raise ValueError("plain trace step: int64 [B] row ids on the state's device")
    if idx is None and B != R:
        raise ValueError("plain trace step: without row ids, one sdf value per row")
    if dist_field is not None and (dist_field.dtype != torch.uint8 or dist_field.device != dev):
        raise ValueError("plain trace step: the distance field must be uint8 on the state's "
                         "device")
    out = torch.empty((B, 3), dtype=torch.float32, device=dev) if pos_out else None
    (cx, cy, cz), r2 = bound
    lib = kernels.load("sphere_trace")
    err = lib.psdf_trace_step_pos(
        B, R, kernels.ptr(idx.contiguous() if idx is not None else None), kernels.ptr(s),
        kernels.ptr(dirs_f), kernels.ptr(pos_f), kernels.ptr(alive_f), kernels.ptr(conv_f),
        kernels.ptr(sdf_f),
        kernels.ptr(dist_field.contiguous() if dist_field is not None else None),
        *_grid_scalars(grid_cfg if dist_field is not None else None), _EMPTY_DIST_CAP,
        float(sdf_multiplier), float(sdf_converged_tresh),
        float(grid_cfg.voxel_size) if dist_field is not None else 0.0, cx, cy, cz, r2,
        kernels.ptr(out), kernels.current_stream(dev))
    kernels.check(lib, err, "plain sphere-trace step (kernel J3)")
    trace_step_pos_cuda.launches += 1
    return out


trace_step_pos_cuda.launches = 0


# ---------------------------------------------------------------------------
# Kernels J3f and J2f: the trace loops with the flagship SDF inside the launch
# ---------------------------------------------------------------------------

def _trace_loop_pos(step, sdf_eval, ctx, idx, dirs_f, pos_f, alive_f, conv_f, sdf_f, dist_field,
                    grid_cfg, iters: int, sdf_multiplier: float, sdf_converged_tresh: float,
                    bound):
    """``iters`` times the SDF at the rows' positions, then ``step`` (J3 or
    its plain version), in place: the rows ``idx`` (a bucket whose fill
    slots point at the state's last row) or every row."""
    sub_pos = pos_f[idx] if idx is not None else pos_f
    for _ in range(iters):
        s = sdf_eval(ctx, sub_pos).reshape(-1)
        out = step(idx, s, dirs_f, pos_f, alive_f, conv_f, sdf_f, dist_field, grid_cfg,
                   sdf_multiplier, sdf_converged_tresh, bound, pos_out=idx is not None)
        sub_pos = out if idx is not None else pos_f


def trace_loop_pos_plain(sdf_eval, ctx, idx, dirs_f, pos_f, alive_f, conv_f, sdf_f, dist_field,
                         grid_cfg, iters: int, sdf_multiplier: float,
                         sdf_converged_tresh: float, bound):
    """Plain version of kernel J3f: ``iters`` times ``sdf_eval(ctx, pos)``
    and J3's plain version, on the rows ``idx`` (or every row), in place."""
    _trace_loop_pos(trace_step_pos_plain, sdf_eval, ctx, idx, dirs_f, pos_f, alive_f, conv_f,
                    sdf_f, dist_field, grid_cfg, iters, sdf_multiplier, sdf_converged_tresh,
                    bound)


def trace_loop_pos_cuda(sdf_eval, ctx, idx, dirs_f, pos_f, alive_f, conv_f, sdf_f, dist_field,
                        grid_cfg, iters: int, sdf_multiplier: float,
                        sdf_converged_tresh: float, bound):
    """Kernel J3f launch: J3's ``iters`` iterations with the SDF of
    ``sdf_eval`` (an :class:`SDFEval`) evaluated inside one launch. Counts
    launches in ``trace_loop_pos_cuda.launches``."""
    dev = pos_f.device
    _check_state("fused plain trace", dev, (dirs_f, pos_f) + ((sdf_f,) if sdf_f is not None
                                                               else ()), (alive_f, conv_f))
    R = pos_f.shape[0] - 1 if idx is not None else pos_f.shape[0]
    if idx is not None and (idx.dtype != torch.int64 or idx.device != dev or idx.dim() != 1):
        raise ValueError("fused plain trace: int64 [B] row ids on the state's device")
    if dist_field is not None and (dist_field.dtype != torch.uint8 or dist_field.device != dev):
        raise ValueError("fused plain trace: the distance field must be uint8 on the state's "
                         "device")
    B = idx.shape[0] if idx is not None else R
    net, keep = sn.sdf_net(sdf_eval, ctx, dev)  # keep: the tensors net points at
    (cx, cy, cz), r2 = bound
    lib = kernels.load("sphere_trace")
    err = lib.psdf_trace_loop_pos(
        B, R, kernels.ptr(idx.contiguous() if idx is not None else None), ctypes.byref(net),
        kernels.ptr(dirs_f), kernels.ptr(pos_f),
        kernels.ptr(alive_f), kernels.ptr(conv_f), kernels.ptr(sdf_f),
        kernels.ptr(dist_field.contiguous() if dist_field is not None else None),
        *_grid_scalars(grid_cfg if dist_field is not None else None), _EMPTY_DIST_CAP,
        int(iters), float(sdf_multiplier), float(sdf_converged_tresh),
        float(grid_cfg.voxel_size) if dist_field is not None else 0.0, cx, cy, cz, r2,
        kernels.current_stream(dev))
    kernels.check(lib, err, "fused plain sphere trace (kernel J3f)")
    trace_loop_pos_cuda.launches += 1


trace_loop_pos_cuda.launches = 0


def _trace_round(step, sdf_eval, ctx, idx, origins_f, dirs_f, texit_f, t_f, alive_f, conv_f,
                 sdf_f, dist_field, grid_cfg, iters: int, sdf_multiplier: float,
                 sdf_converged_tresh: float, jump_substeps: int, jump_gate: float):
    """One round on the bucket ``idx``: the positions, then ``iters`` times
    the SDF and ``step`` (J2 or its plain version), in place -> the round's
    counts [2] int32 (still active, converged and alive)."""
    args = (origins_f, dirs_f, texit_f, t_f, alive_f, conv_f, sdf_f, dist_field, grid_cfg,
            sdf_multiplier, sdf_converged_tresh, jump_substeps, jump_gate)
    pos, counts = step(idx, None, *args, counts=iters == 0)
    for i in range(iters):
        s = sdf_eval(ctx, pos).reshape(-1)
        pos, counts = step(idx, s, *args, counts=i == iters - 1)
    return counts


def trace_round_plain(sdf_eval, ctx, idx, origins_f, dirs_f, texit_f, t_f, alive_f, conv_f,
                      sdf_f, dist_field, grid_cfg, iters: int, sdf_multiplier: float,
                      sdf_converged_tresh: float, jump_substeps: int, jump_gate: float):
    """Plain version of kernel J2f: one round of ``iters`` times
    ``sdf_eval(ctx, pos)`` and J2's plain version -> the round's counts."""
    return _trace_round(trace_step_plain, sdf_eval, ctx, idx, origins_f, dirs_f, texit_f, t_f,
                        alive_f, conv_f, sdf_f, dist_field, grid_cfg, iters, sdf_multiplier,
                        sdf_converged_tresh, jump_substeps, jump_gate)


def trace_round_cuda(sdf_eval, ctx, idx, origins_f, dirs_f, texit_f, t_f, alive_f, conv_f,
                     sdf_f, dist_field, grid_cfg, iters: int, sdf_multiplier: float,
                     sdf_converged_tresh: float, jump_substeps: int, jump_gate: float):
    """Kernel J2f launch: one round of J2 with the SDF of ``sdf_eval`` (an
    :class:`SDFEval`) evaluated inside one launch -> the round's counts [2]
    int32. Counts launches in ``trace_round_cuda.launches``."""
    dev = t_f.device
    _check_state("fused trace round", dev, (origins_f, dirs_f, texit_f, t_f, sdf_f),
                 (alive_f, conv_f))
    if idx.dtype != torch.int64 or idx.device != dev or idx.dim() != 1:
        raise ValueError("fused trace round: int64 [B] bucket ids on the state's device")
    if dist_field is not None and (dist_field.dtype != torch.uint8 or dist_field.device != dev):
        raise ValueError("fused trace round: the distance field must be uint8 on the state's "
                         "device")
    net, keep = sn.sdf_net(sdf_eval, ctx, dev)  # keep: the tensors net points at
    counts = torch.zeros((2,), dtype=torch.int32, device=dev)
    lib = kernels.load("sphere_trace")
    err = lib.psdf_trace_round(
        idx.shape[0], t_f.shape[0] - 1, kernels.ptr(idx.contiguous()), ctypes.byref(net),
        kernels.ptr(origins_f), kernels.ptr(dirs_f),
        kernels.ptr(texit_f), kernels.ptr(t_f), kernels.ptr(alive_f), kernels.ptr(conv_f),
        kernels.ptr(sdf_f),
        kernels.ptr(dist_field.contiguous() if dist_field is not None else None),
        *_grid_scalars(grid_cfg if dist_field is not None else None), _EMPTY_DIST_CAP,
        int(iters), float(sdf_multiplier), float(sdf_converged_tresh), float(jump_gate),
        int(jump_substeps), kernels.ptr(counts), kernels.current_stream(dev))
    kernels.check(lib, err, "fused sphere-trace round (kernel J2f)")
    trace_round_cuda.launches += 1
    return counts


trace_round_cuda.launches = 0


def _plain_seed(ray_origins, ray_dirs, boundary_primitive, grid_cfg, grid, dist_field):
    """The plain tracers' start: the bound's entry, or with a grid half a
    voxel past the start of the first occupied probe segment (kernel C3,
    which reads the grid's distance field, built here unless given)
    -> (pos [R, 3], alive [R], dist_field or None)."""
    p_entry, t_entry, _, t_exit, hit = boundary_primitive.ray_intersection(ray_origins,
                                                                           ray_dirs)
    if grid is None or grid_cfg is None:
        return p_entry, hit[:, 0], None
    if dist_field is None:
        dist_field = _grid_distance_field(grid_cfg, grid)
    t_first, has_occ = og.compute_first_sample_start_of_occupied_regions(
        grid_cfg, grid, ray_origins, ray_dirs, t_entry, t_exit, dist_field=dist_field)
    pos = ray_origins + t_first[:, None] * ray_dirs
    pos = pos + ray_dirs * grid_cfg.voxel_size * 0.5  # half a voxel inside
    return pos, has_occ & hit[:, 0], dist_field


def _trace_route(sdf_fn, ctx, device):
    """How a plain tracer runs ``sdf_fn`` on ``device`` -> (the loop, the
    evaluation ``(ctx, pts) -> sdf``, its ctx): for an :class:`SDFEval`
    kernel J3f's loop on the card (its plain version on the CPU), else the
    loop of ``sdf_fn(pts)`` and J3 (or J3's plain version)."""
    if isinstance(sdf_fn, SDFEval):  # the flagship SDF: one launch of J3f on the card
        if ctx is None:
            raise ValueError("an SDFEval is traced with its ctx = (params_sdf, iter_nr)")
        return kernels.dispatch(device, trace_loop_pos_cuda, trace_loop_pos_plain), sdf_fn, ctx
    step = kernels.dispatch(device, trace_step_pos_cuda, trace_step_pos_plain)
    return functools.partial(_trace_loop_pos, step), lambda _, p: sdf_fn(p), None


def sphere_trace(sdf_fn, ray_origins, ray_dirs, boundary_primitive,
                 nr_sphere_traces: int = 15, sdf_multiplier: float = 0.9,
                 sdf_converged_tresh: float = 2e-4,
                 grid_cfg: Optional[og.OccupancyGridConfig] = None,
                 grid: Optional[og.OccupancyGridState] = None,
                 time_val: Optional[float] = None, dist_field=None,
                 final_sdf: bool = True, ctx=None):
    """Masked sphere tracing of every ray for ``nr_sphere_traces``
    iterations (``sdf_fn`` maps [N, 3] to [N] sdf values), with the grid's
    empty-space jumps when ``grid`` is given (its distance field built here
    unless ``dist_field`` is). ``sdf_fn`` may be an :class:`SDFEval` with
    its ``ctx = (params_sdf, iter_nr)``: then all the iterations are one
    launch of kernel J3f on the card, which evaluates the SDF inside the
    loop. Returns (pos [R, 3], sdf [R] at the final positions (None with
    ``final_sdf=False``), converged [R], within_bounds [R])."""
    _check_time(time_val)
    loop, sdf_eval, ctx = _trace_route(sdf_fn, ctx, ray_origins.device)
    bound = _sphere_bound(boundary_primitive)
    pos, alive, dist_field = _plain_seed(ray_origins, ray_dirs, boundary_primitive, grid_cfg,
                                         grid, dist_field)
    pos_f = pos.contiguous()
    dirs_f = ray_dirs.contiguous()
    alive_f = alive.contiguous()
    conv_f = torch.zeros_like(alive_f)
    loop(sdf_eval, ctx, None, dirs_f, pos_f, alive_f, conv_f, None, dist_field, grid_cfg,
         nr_sphere_traces, sdf_multiplier, sdf_converged_tresh, bound)
    sdf = sdf_eval(ctx, pos_f).reshape(-1) if final_sdf else None
    return pos_f, sdf, conv_f, alive_f


def filter_unconverged_points(points, sdf, sdf_gradients, sdf_converged_tresh: float = 0.01):
    """Zero the points (and gradients) whose sdf is not below the threshold
    -> (points, gradients or None, ok [N, 1] as points' dtype)."""
    ok = (sdf.reshape(-1, 1) < sdf_converged_tresh).to(points.dtype)
    grads = sdf_gradients * ok if sdf_gradients is not None else None
    return points * ok, grads, ok


def sphere_trace_compacted(sdf_fn, ray_origins, ray_dirs, boundary_primitive,
                           nr_rounds: int = 5, iters_per_round: int = 3,
                           sdf_multiplier: float = 0.9, sdf_converged_tresh: float = 2e-4,
                           grid_cfg: Optional[og.OccupancyGridConfig] = None,
                           grid: Optional[og.OccupancyGridState] = None,
                           time_val: Optional[float] = None,
                           first_bucket_fraction: float = 0.25, dist_field=None,
                           final_sdf: bool = True, ctx=None):
    """Sphere tracing in ``nr_rounds`` rounds of ``iters_per_round``
    iterations, each round on a bucket of the active rays of a static size:
    max(256, R * first_bucket_fraction) (at most R), halved every round.
    Active rays that overflow a bucket wait for the next round. A final
    bucket of that first size re-evaluates the sdf of the converged alive
    rays. For an :class:`SDFEval` ``sdf_fn`` with its ``ctx`` each round is
    one launch of kernel J3f on the card, on its bucket (H0). Returns (pos
    [R, 3], sdf [R] (None with ``final_sdf=False``), converged & alive [R],
    within_bounds [R])."""
    _check_time(time_val)
    loop, sdf_eval, ctx = _trace_route(sdf_fn, ctx, ray_origins.device)
    bound = _sphere_bound(boundary_primitive)
    R = ray_origins.shape[0]
    pos, alive, dist_field = _plain_seed(ray_origins, ray_dirs, boundary_primitive, grid_cfg,
                                         grid, dist_field)
    # full-size state padded by one fill row (never alive) for the buckets'
    # unused slots
    pos_f = _padded(pos.contiguous())
    dirs_f = _padded(ray_dirs.contiguous())
    alive_f = _padded(alive, False)
    conv_f = torch.zeros_like(alive_f)
    sdf_f = torch.zeros((R + 1,), dtype=pos_f.dtype, device=pos_f.device)
    first_bucket = max(256, int(R * first_bucket_fraction))
    bucket = first_bucket
    for _ in range(nr_rounds):
        bucket = min(bucket, R)
        idx, _ = nonzero_static(alive_f[:R], bucket, fill_value=R, other=conv_f[:R],
                                negate_other=True)
        loop(sdf_eval, ctx, idx, dirs_f, pos_f, alive_f, conv_f, sdf_f, dist_field, grid_cfg,
             iters_per_round, sdf_multiplier, sdf_converged_tresh, bound)
        bucket = bucket // 2
    sdf = None
    if final_sdf:
        # the final sdf of the converged rays that fit one first-size bucket
        # (the rest keep their last evaluated sdf, as in the JAX op)
        idx, _ = nonzero_static(conv_f[:R], min(first_bucket, R), fill_value=R,
                                other=alive_f[:R])
        s = sdf_eval(ctx, pos_f[idx]).reshape(-1)
        sdf_f[idx] = torch.where(idx < R, s, sdf_f[idx])
        sdf = sdf_f[:R]
    return pos_f[:R], sdf, (conv_f & alive_f)[:R], alive_f[:R]


# ---------------------------------------------------------------------------
# The rounds
# ---------------------------------------------------------------------------

def _trace_rounds_impl(sdf_eval, ctx, origins_f, dirs_f, texit_f, dist_field,
                       t_f, alive_f, conv_f, sdf_f, grid_cfg,
                       iters: int, bucket: int, sdf_multiplier: float,
                       sdf_converged_tresh: float, time_val,
                       jump_substeps: int = 1, jump_gate: float = 0.0, idx=None):
    """``iters`` trace steps on a host-sized bucket of the active rays
    (alive, not converged), in place on the full-size state: one launch of
    kernel J2f on the card when ``sdf_eval`` is an :class:`SDFEval`, else
    ``iters`` times the SDF and kernel J2. Returns the state and the
    bucket's counts [2] (still active, converged and alive): every active
    ray is in the bucket, so the first is the frame's active count; the
    frame's hits are the second plus those before the round. ``idx`` is
    the round's bucket when the caller has it already (round 0's from the
    prepass, kernel J1), else H0 lists it."""
    _check_time(time_val)
    R = t_f.shape[0] - 1
    if idx is None:
        idx, _ = nonzero_static(alive_f[:R], bucket, fill_value=R, other=conv_f[:R],
                                negate_other=True)
    if grid_cfg is None:
        dist_field = None
    if isinstance(sdf_eval, SDFEval):  # the flagship SDF: one launch of J2f on the card
        rnd = kernels.dispatch(t_f.device, trace_round_cuda, trace_round_plain)
    else:
        rnd = functools.partial(_trace_round, kernels.dispatch(t_f.device, trace_step_cuda,
                                                               trace_step_plain))
    counts = rnd(sdf_eval, ctx, idx, origins_f, dirs_f, texit_f, t_f, alive_f, conv_f, sdf_f,
                 dist_field, grid_cfg, iters, sdf_multiplier, sdf_converged_tresh,
                 jump_substeps, jump_gate)
    return t_f, alive_f, conv_f, sdf_f, counts


def _jump_prepass_impl(dist_field, origins_f, dirs_f, texit_f, t_f, alive_f,
                       grid_cfg, jumps: int, list_size: Optional[int] = None):
    """``jumps`` chained empty-space jumps on every alive ray, no SDF
    evaluation: a ray parks at the occupied shell or leaves the bound and
    dies. In place; returns (t_f, alive_f, the alive count [] int32, the
    alive rays in ascending order then the fill R [list_size]: round 0's
    bucket is its head)."""
    fn = kernels.dispatch(t_f.device, jump_prepass_cuda, jump_prepass_plain)
    count, idx = fn(dist_field, origins_f, dirs_f, texit_f, t_f, alive_f, grid_cfg, jumps,
                    list_size)
    return t_f, alive_f, count, idx


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

    first_idx = None  # round 0's bucket, written by the prepass
    if prepass_jumps > 0 and dist_field is not None:
        t_f, alive_f, n_act, first_idx = _jump_prepass_impl(
            dist_field, origins_f, dirs_f, texit_f, t_f, alive_f, grid_cfg, prepass_jumps,
            max(min_bucket, R))
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
            grid_cfg, iters_per_round, bucket, **trace,
            idx=first_idx[:bucket] if rnd == 0 and first_idx is not None else None)
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
