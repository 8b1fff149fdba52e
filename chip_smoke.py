#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``permuto_sdf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. print the card (``nvidia-smi`` name and power limit), turn TF32 off for
   matmuls and convolutions, build the kernels from ``kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card, with the
   tolerance stated, and time both (CUDA events): A-D at the shapes of one
   2048-ray chunk of the flagship eval render, F, G, D' and I at the shapes
   of the flagship training step;
3. render 400x400 frames of the full-width flagship model (random weights
   from a seed, plus a planted plane SDF so the frame has a surface) with
   ``render_image`` on a fully occupied grid and on a sparse shell grid,
   N_FRAMES timed frames each after a warm-up (median and spread), with
   every kernel's launch count reset just before and read just after;
4. render 1024 of those rays again on the CPU (the plain path) and compare:
   the CPU's samples rendered on the card must agree within TOL_CROSS,
   and the card's whole path may differ by more only on rays whose
   samples differ from the CPU's;
5. train the full-width flagship model on the synthetic scene (24 views,
   200x200): 4 ``sphere_init_step`` s (the loss must fall), ``_save`` of
   the train state at iteration nr_iter_sphere_fit + TRAIN_FROM (every SDF
   level open, curvature on, the lr past warm-up), then ``train`` resumed
   from it for TRAIN_STEPS steps (3 occupancy refreshes), with the launch
   counts reset before and read after; ms/step, rays/s, launches per step,
   every parameter group changed and finite; one more step profiled;
6. one full-width training step on the card and on the CPU with the same
   draws and the CPU's fg samples: the loss and every leaf's gradient
   within TOL_GRAD_CROSS;
7. the sphere scene (the full-width model after SPHERE_INIT_STEPS
   ``sphere_init_step`` s, its grid refreshed over every voxel) and the
   planted-plane scene on a full grid; kernels J0, J1, J2 and H0 against
   their plain versions at the shapes of one 400x400 chunk of
   ``render_image_sphere_traced_fast``;
8. sphere-traced frames at the interactive viewer's operating point
   (ST_KW): 400x400 on both scenes (ST_FRAMES timed frames after a warm-up)
   and 1920x1080 on the sphere scene (ST_FRAMES_1080), with the launch
   counts reset before the warm-up frame and read after the last, and one
   more profiled 400x400 frame;
9. 1024 rays of the sphere scene (a strided subsample of the whole view:
   misses, prepass deaths, silhouettes and hits) traced and shaded on the
   card and on the CPU: the lit masks agree on ST_CROSS_LIT_AGREE of the
   rays, the CPU's final positions shaded on the card give its rgb and
   normals within TOL_ST_CROSS, and on the whole path a ray lit in both
   differs by more only where its final position differs by at most
   ST_CROSS_MAX_POS_GAP, and on at most ST_CROSS_MAX_OFF_SHARE of the rays
   lit in both;
10. print ``render``, ``train``, ``sphere_traced`` and ``kernels`` JSON
   lines, then as the last line ``{"ok": true, "device": {...}}``.

It needs the CUDA toolkit (``nvcc``) and no network. It imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
ITER = 20000  # past the SDF's coarse-to-fine ease-in: every level is open
WIDTH = HEIGHT = 400  # the interactive viewer's frame
CHUNK = 2048
CROSS_RAYS = 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores

# Tolerances of kernel vs plain version on the card (same inputs).
TOL_A = 1e-6  # features ~1e-4: same lattice float order (--fmad=false), only the blend-sum order differs
TOL_B = 1e-5  # relative to max |grad|: sums over 24 levels in the same order
TOL_C = 1e-6  # z and dt: identical float ops; the mask must match exactly
TOL_D = 1e-5  # weights and integrals: warp-scan vs serial cumprod association
# F and G add into the table with float atomics in no fixed order; each
# level is held to TOL_F of its largest |gradient| (coarse slots sum ~1e5
# terms in float32).
TOL_F = 1e-4
TOL_G = 1e-4  # G's table gradient per level as F; its feature cotangent is a gather
# D' vs autograd of the plain forward: the transmittance recurrence sums in
# another association; relative to each gradient's largest |value|.
TOL_DB = 1e-4
TOL_I = 0.0  # voxel ids, centers, values and occupancy: identical float ops
# Card vs CPU render of the same samples: matmul summation order (cuBLAS
# vs CPU BLAS) moves sdf by ~1e-7, which NeuS alphas amplify by inv_s ~ 3e3.
TOL_CROSS = 2e-3
N_FRAMES = 5  # timed frames per grid, after one warm-up frame
TRAIN_FROM = 20000  # the resumed run starts past the SDF's c2f ease-in
TRAIN_STEPS = 24  # three occupancy refreshes (every 8 iterations)
WARMUP_STEPS = 2
# Card vs CPU gradient of one training step on the same draws and samples,
# per leaf as ||card - cpu|| / ||cpu||: matmul summation order moves the sdf
# by ~1e-7, NeuS amplifies it by inv_s, and F/G add in atomic order. Not the
# largest entry's error: the curvature loss takes arccos of a clipped dot
# product, whose slope is ~700 just inside the clip and 0 outside, so a
# rounding can move one sample across the bound and one table slot with it
# (6.8e-3 of the SDF table's largest |gradient| on one run, 1.4e-5 on
# another); the largest entry's error is printed beside.
TOL_GRAD_CROSS = 1e-2
TOL_LOSS_CROSS = 1e-3

# Float operations per unit of work, for the operations side of the bound.
# A, B and D: approximate counts from the kernel source; their bytes side
# is at least twice their operations side. C: counted operation by
# operation from the kernel body (see probe_sampler_ops).
OPS_PER_POINT_LEVEL_A = 110
OPS_PER_POINT_LEVEL_B = 150
OPS_PER_SAMPLE_D = 60
OPS_PER_POINT_LEVEL_F = 120  # A's lattice math + 2 (d+1) products
OPS_PER_POINT_LEVEL_G = 170  # B's lattice math + the transposed E and the gathers
OPS_PER_SAMPLE_DB = 120  # D's forward again + the reverse scan and the chain rule
OPS_PER_PROBE_I = 40  # the Weyl map, the center, the logistic density
OPS_PER_LOOKUP = 20  # a distance-field jump: position 6, voxel index 9, floor 3, jump 2
OPS_PER_TRACE_STEP = 12  # J2's update of one ray around its jumps
# J0's function in linear time: the lower-envelope scans of Meijster, Roerdink
# and Hesselink (2000), which cover the L-inf metric, take about 10 operations
# per voxel per 1-D pass, whatever the field's values.
OPS_PER_CHEBYSHEV_VOXEL_PASS = 10

# The sphere-traced render (slice 3).
SPHERE_INIT_STEPS = 300
INV_S_TRAINED = 2981.0  # exp(0.8 * 10): the forced variance at the end of training
# the interactive viewer's sphere mode (permuto_sdf_tpu/experiments/interactive.py:122-126)
ST_KW = dict(nr_rounds=3, iters_per_round=5, nr_refine_iters=3, lod_schedule=(6, 12, 18))
ST_FRAMES = 5  # timed 400x400 frames per scene, after one warm-up frame
ST_FRAMES_1080 = 3  # timed 1920x1080 frames, after one warm-up frame
ST_RUNS = (("sphere_400", "sphere", WIDTH, HEIGHT, ST_FRAMES),
           ("plane_400", "plane", WIDTH, HEIGHT, ST_FRAMES),
           ("sphere_1080p", "sphere", 1920, 1080, ST_FRAMES_1080))
TOL_J = 1e-6  # J1, J2: t and positions, the same float operations (--fmad=false); masks exact
# Card vs CPU sphere-traced pixels: one quantization step of the uint8 frame,
# plus the finest level's ~1e-3 (the two packages' float order differs).
TOL_ST_CROSS = 2.0 / 255
ST_CROSS_LIT_AGREE = 0.99
# Share of the rays lit in both that may be off by more than TOL_ST_CROSS on
# the whole path, each only where its final position differs from the CPU's,
# by at most ST_CROSS_MAX_POS_GAP in any coordinate (the SDF's matmuls sum in
# another order, ~1e-7, and the random fine levels make the normal jump where
# a position crosses a fine lattice cell's face).
ST_CROSS_MAX_OFF_SHARE = 0.01
ST_CROSS_MAX_POS_GAP = 1e-6


def fail(msg: str):
    print(f"CHIP_SMOKE FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, device) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm-up call."""
    import torch

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(nbytes: float, ops: float):
    """(least ms, which side bounds it, ms of the bytes side, ms of the
    operations side)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def plant_plane_sdf(params, normal=(0.3, 1.0, 0.2), offset=-0.05):
    """Make the SDF's first output ``n . p - offset`` (a plane) plus a small
    random bump from all 24 encoding levels, keeping the random geometry
    features and colour: hidden unit 0 of each layer carries 10 + n.p
    through GELU (identity at +10) from the concatenated point columns
    (scaled 1e-3 by the encoding). The random fine levels make the SDF
    gradient jump at lattice-cell boundaries ~1e-4 apart, as a trained
    model's fine detail does."""
    import torch

    mlp = params["sdf"]["mlp_sdf"]
    n = torch.tensor(normal, dtype=torch.float32)
    n = n / n.norm()
    w0 = mlp[0]["w"]
    d = n.numel()
    w0[:-d, 0] *= 0.05
    w0[-d:, 0] = (n * 1e3).to(w0.device)
    mlp[0]["b"][0] = 10.0
    for layer in mlp[1:-1]:
        layer["w"][:, 0] = 0.0
        layer["w"][0, 0] = 1.0
        layer["b"][0] = 0.0
    mlp[-1]["w"][:, 0] = 0.0
    mlp[-1]["w"][0, 0] = 1.0
    mlp[-1]["b"][0] = -10.0 - offset
    return params


def shell_grid(cfg, device):
    """Sparse grid: voxels whose center is within 2 voxels of |x| = 0.3."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    v = cfg.nr_voxels_per_dim
    c = (torch.arange(v, dtype=torch.float32, device=device) + 0.5) * cfg.voxel_size - 0.5
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    r = torch.sqrt(x * x + y * y + z * z)
    occ = (torch.abs(r - 0.3) < 2 * cfg.voxel_size).reshape(-1)
    return og.OccupancyGridState(values=torch.zeros_like(occ, dtype=torch.float32),
                                 occupancy=occ)


def camera():
    import numpy as np

    from permuto_sdf_tpu_torch.datasets.tensor_reel import look_at_cam_to_world

    K = np.array([[WIDTH * 1.1, 0, WIDTH / 2], [0, HEIGHT * 1.1, HEIGHT / 2], [0, 0, 1]],
                 np.float32)
    return K, look_at_cam_to_world((0.35, 0.55, 1.1)).astype(np.float32)


def probe_sampler_ops(t_entry, t_exit, mask, P: int) -> int:
    """Float operations kernel C's body does for these rays: per probe of a
    ray that meets the bound (t_exit > t_entry; the others have nothing to
    probe) 23: probe fraction 2, t 3, point 6, three voxel indices 4 each;
    per such ray 8: seg_len 2, occupied length 2, sample count 2, dt 2; per
    valid sample 11 + 3 per step of the binary search over the P counts:
    arc 2, each step's count * seg_len and compare 3, cum_before 2, into 3,
    t 4. Invalid sample slots only store zeros."""
    steps = math.ceil(math.log2(P + 1))
    hit = int((t_exit > t_entry).sum())
    return hit * (23 * P + 8) + int(mask.sum()) * (11 + 3 * steps)


def _report(name, err, tol, ms, plain_ms, bound):
    print(f"[kernel {name}] max_err={err:.3e} tol={tol:.1e} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound[0]:.3g} ({bound[1]}; bytes side "
          f"{bound[2]:.3g} ms, operations side {bound[3]:.3g} ms)", flush=True)
    if not err <= tol:
        fail(f"kernel {name}: error {err:.3e} above tolerance {tol:.1e}")


def kernel_phases(device, cfg, reps=20, plain_reps=3):
    """Each kernel against its plain version on one chunk's shapes.
    Returns {kernel: dict of numbers}."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr
    from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask

    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(SEED)
    L = cfg.nr_levels
    S_fg = cfg.max_nr_samples_per_ray + 2 * cfg.nr_samples_imp_sampling
    R = CHUNK
    results = {}

    def rand_points(n, d):
        return torch.from_numpy(rng.uniform(-0.45, 0.45, (n, d)).astype(np.float32)).to(device)

    # --- A: encode forward (SDF/RGB d=3 full, proxy K=12, background d=4)
    errs, timing = [], None
    for label, d, n, K, scaling in (
            ("d3_full", 3, R * S_fg, L, 1e-3),
            ("d3_K12", 3, R * cfg.max_nr_samples_per_ray, cfg.imp_sampling_max_levels, 1e-3),
            ("d4_bg", 4, R * cfg.nr_samples_bg, L, 1.0)):
        spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=cfg.capacity, nr_levels=L,
                                      concat_points_scaling=scaling)
        prm = pe.init_encoding_params(gen, spec, device)
        pts = rand_points(n, d)
        scales, E, _ = pe.encoding_constants(spec, None, device)
        window = torch.ones(L, device=device)
        args = (pts, prm["lattice_values"], prm["shift_per_level"], scales, window, E,
                K, scaling, True)
        got = pe.encode_fwd_cuda(*args)
        want = pe.encode_fwd_plain(*args)
        err = (got - want).abs().max().item()
        errs.append(err)
        ms = time_ms(lambda: pe.encode_fwd_cuda(*args), reps, device)
        pms = time_ms(lambda: pe.encode_fwd_plain(*args), plain_reps, device)
        uniq = torch.unique(pe.flat_slot_ids(pts, prm["lattice_values"], prm["shift_per_level"],
                                             scales, E, K)).numel()
        nbytes = pts.numel() * 4 + uniq * 2 * 4 + got.numel() * 4
        b = bound_ms(nbytes, OPS_PER_POINT_LEVEL_A * n * K)
        _report(f"A:{label} N={n} K={K}", err, TOL_A, ms, pms, b)
        if label == "d3_full":
            timing = (ms, pms, b)
            b_inputs = (args, uniq)
    results["A"] = dict(max_abs_err=max(errs), ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1])

    # --- B: point gradient of the SDF encoding (d=3, full width)
    args, uniq = b_inputs
    pts = args[0]
    g = torch.from_numpy(rng.normal(size=(pts.shape[0], 2 * L + 3)).astype(np.float32)).to(device)
    got = pe.encode_point_grad_cuda(*args, g)
    want = pe.encode_point_grad_plain(*args, g)
    err = ((got - want).abs().max() / want.abs().max()).item()
    ms = time_ms(lambda: pe.encode_point_grad_cuda(*args, g), reps, device)
    pms = time_ms(lambda: pe.encode_point_grad_plain(*args, g), plain_reps, device)
    nbytes = pts.numel() * 4 + g.numel() * 4 + uniq * 2 * 4 + got.numel() * 4
    b = bound_ms(nbytes, OPS_PER_POINT_LEVEL_B * pts.shape[0] * L)
    _report(f"B N={pts.shape[0]} (relative)", err, TOL_B, ms, pms, b)
    results["B"] = dict(max_abs_err=(got - want).abs().max().item(), ms=ms, plain_ms=pms,
                        bound_ms=b[0], bound_by=b[1])

    # --- C: probe sampler on the chunk of rays through the frame's center
    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame

    K_cam, tf = camera()
    origins, dirs = rays_from_frame(K_cam, tf, WIDTH, HEIGHT, device=device)
    mid = (origins.shape[0] // 2 // R) * R
    o, dr = origins[mid:mid + R].contiguous(), dirs[mid:mid + R].contiguous()
    _, te, _, tx, _ = Sphere().ray_intersection(o, dr)
    gcfg = cfg.grid
    P, S = 512, cfg.max_nr_samples_per_ray
    errs, timing = [], None
    for label, grid in (("full", og.make_occupancy_grid(gcfg, device=device)),
                        ("shell", shell_grid(gcfg, device))):
        cargs = (gcfg, grid.occupancy, o, dr, te, tx, cfg.min_dist_between_samples, S, P)
        got = og.probe_sampler_cuda(*cargs)
        want = og.probe_sampler_plain(*cargs)
        if not torch.equal(got[2], want[2]):
            fail(f"kernel C:{label}: sample masks differ in "
                 f"{(got[2] != want[2]).sum().item()} slots")
        err = max((got[i] - want[i]).abs().max().item() for i in (0, 1, 3))
        errs.append(err)
        ms = time_ms(lambda: og.probe_sampler_cuda(*cargs), reps, device)
        pms = time_ms(lambda: og.probe_sampler_plain(*cargs), plain_reps, device)
        frac = (torch.arange(P, device=device, dtype=torch.float32) + 0.5) / P
        ts = te + frac[None, :] * (tx - te)
        lin, _ = og.point_to_lin_idx(gcfg, (o[:, None, :] + ts[..., None] * dr[:, None, :]).reshape(-1, 3))
        probed = torch.unique(lin).numel()
        nbytes = R * 8 * 4 + probed + R * S * 9 + R * 4
        b = bound_ms(nbytes, probe_sampler_ops(te, tx, want[2], P))
        _report(f"C:{label} R={R} valid={int(want[2].sum())}", err, TOL_C, ms, pms, b)
        if label == "full":
            timing = (ms, pms, b)
    results["C"] = dict(max_abs_err=max(errs), ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1])

    # --- D: NeuS mode (fg, S=96) and NeRF mode (bg, S=32)
    errs, timing = [], None
    for label, S in (("neus", S_fg), ("nerf", cfg.nr_samples_bg)):
        nr = torch.from_numpy(rng.integers(0, S + 1, R)).to(device)
        mask = prefix_mask(nr, S) if label == "neus" else torch.ones((R, S), dtype=torch.bool, device=device)
        dt = torch.from_numpy(rng.uniform(0, 0.02, (R, S)).astype(np.float32)).to(device)
        smp = RaySamples(origins=o, dirs=dr, z=torch.zeros((R, S), device=device), dt=dt,
                         mask=mask, ray_fixed_dt=torch.zeros(R, device=device))
        rgb = torch.from_numpy(rng.uniform(size=(R * S, 3)).astype(np.float32)).to(device)
        if label == "neus":
            val = torch.from_numpy(rng.uniform(-0.01, 0.01, (R, S)).astype(np.float32)).to(device)
            grads = torch.from_numpy(rng.normal(size=(R * S, 3)).astype(np.float32)).to(device)
            run_k = lambda: vr.render_weights_cuda(0, smp, val, grads, rgb, 2981.0, 1.0)  # noqa: E731
            run_p = lambda: vr.neus_render_plain(smp, val, grads, rgb, 2981.0, 1.0)  # noqa: E731
            nbytes = R * S * (4 + 12 + 12 + 4 + 1 + 4) + R * (12 + 4 + 4 + 12 + 12)
        else:
            val = torch.from_numpy(rng.uniform(0, 80, (R, S)).astype(np.float32)).to(device)
            run_k = lambda: vr.render_weights_cuda(1, smp, val, None, rgb, 0.0, 0.0)[:4]  # noqa: E731
            run_p = lambda: vr.nerf_render_plain(smp, val, rgb)  # noqa: E731
            nbytes = R * S * (4 + 12 + 4 + 1 + 4) + R * (4 + 4 + 12)
        got, want = run_k(), run_p()
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        errs.append(err)
        ms = time_ms(run_k, reps, device)
        pms = time_ms(run_p, plain_reps, device)
        b = bound_ms(nbytes, OPS_PER_SAMPLE_D * R * S)
        _report(f"D:{label} R={R} S={S}", err, TOL_D, ms, pms, b)
        if label == "neus":
            timing = (ms, pms, b)
    results["D"] = dict(max_abs_err=max(errs), ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1])
    return results


def _level_err(got, want):
    """Largest per-level error of a [L, 2, C] table gradient, relative to
    the level's largest |value|."""
    err = 0.0
    for lvl in range(want.shape[0]):
        scale = want[lvl].abs().max().item()
        if scale > 0:
            err = max(err, (got[lvl] - want[lvl]).abs().max().item() / scale)
        elif got[lvl].abs().max().item() > 0:
            err = math.inf
    return err


def train_kernel_phases(device, cfg, reps=20, plain_reps=3):
    """Kernels F, G, D' and I against their plain versions at the shapes of
    the flagship training step. Returns {kernel: dict of numbers}."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr
    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask

    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator().manual_seed(SEED + 1)
    L = cfg.nr_levels
    R = cfg.nr_rays
    S_fg = cfg.samples_per_ray
    M = R * S_fg
    results = {}

    def tensor(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    def encoding(d, scaling):
        spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=cfg.capacity, nr_levels=L,
                                      concat_points_scaling=scaling)
        prm = pe.init_encoding_params(gen, spec, device)
        prm["lattice_values"] *= 1e3  # a trained table's magnitude
        scales, E, _ = pe.encoding_constants(spec, None, device)
        return prm, scales, E

    # --- F: the table gradient, for every encode of the step
    timing = None
    for label, d, n, scaling in (("sdf", 3, M, 1e-3), ("bg", 4, R * cfg.nr_samples_bg, 1.0),
                                 ("sphere_init", 3, cfg.sphere_init_points, 1e-3),
                                 ("offsurface", 3, 1024, 1e-3)):
        prm, scales, E = encoding(d, scaling)
        pts = tensor(rng.uniform(-0.45, 0.45, (n, d)))
        window = torch.ones(L, device=device)
        g = tensor(rng.normal(size=(n, 2 * L + d)))
        args = (pts, prm["lattice_values"], prm["shift_per_level"], scales, window, E, L, g)
        got, want = pe.encode_table_grad_cuda(*args), pe.encode_table_grad_plain(*args)
        err = _level_err(got, want)
        ms = time_ms(lambda: pe.encode_table_grad_cuda(*args), reps, device)
        pms = time_ms(lambda: pe.encode_table_grad_plain(*args), plain_reps, device)
        nbytes = pts.numel() * 4 + n * 2 * L * 4 + got.numel() * 4
        b = bound_ms(nbytes, OPS_PER_POINT_LEVEL_F * n * L)
        _report(f"F:{label} N={n} d={d} K={L} (per level, relative)", err, TOL_F, ms, pms, b)
        if label == "sdf":
            timing = (ms, pms, b, (got - want).abs().max().item())
    results["F"] = dict(max_abs_err=timing[3], ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1])

    # --- G: the double backward of the SDF encoding (fg, curvature, sphere init)
    timing = None
    prm, scales, E = encoding(3, 1e-3)
    for label, n in (("sdf", M), ("curvature", min(cfg.curvature_sample_budget, M)),
                     ("sphere_init", cfg.sphere_init_points)):
        pts = tensor(rng.uniform(-0.45, 0.45, (n, 3)))
        window = torch.ones(L, device=device)
        g = tensor(rng.normal(size=(n, 2 * L + 3)))
        u = tensor(rng.normal(size=(n, 3)))
        args = (pts, prm["lattice_values"], prm["shift_per_level"], scales, window, E, L, 1e-3,
                True, g, u)
        (tk, gk), (tp, gp) = pe.encode_double_backward_cuda(*args), pe.encode_double_backward_plain(*args)
        err = max(_level_err(tk, tp), ((gk - gp).abs().max() / gp.abs().max()).item())
        ms = time_ms(lambda: pe.encode_double_backward_cuda(*args), reps, device)
        pms = time_ms(lambda: pe.encode_double_backward_plain(*args), plain_reps, device)
        uniq = torch.unique(pe.flat_slot_ids(pts, prm["lattice_values"], prm["shift_per_level"],
                                             scales, E, L)).numel()
        nbytes = (pts.numel() + u.numel() + 2 * g.numel()) * 4 + uniq * 2 * 4 + tk.numel() * 4
        b = bound_ms(nbytes, OPS_PER_POINT_LEVEL_G * n * L)
        _report(f"G:{label} N={n} K={L} (per level / relative)", err, TOL_G, ms, pms, b)
        if label == "sdf":
            timing = (ms, pms, b, max((tk - tp).abs().max().item(), (gk - gp).abs().max().item()))
    results["G"] = dict(max_abs_err=timing[3], ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1])

    # --- D': the backward of kernel D, NeuS (fg) and NeRF (bg) mode
    timing = None
    for mode, S in ((0, S_fg), (1, cfg.nr_samples_bg)):
        nr = torch.from_numpy(rng.integers(0, S + 1, R)).to(device)
        mask = prefix_mask(nr, S) if mode == 0 else torch.ones((R, S), dtype=torch.bool,
                                                               device=device)
        dirs = torch.nn.functional.normalize(tensor(rng.normal(size=(R, 3))), dim=-1)
        smp = RaySamples(origins=dirs, dirs=dirs, z=torch.zeros((R, S), device=device),
                         dt=tensor(rng.uniform(0, 0.02, (R, S))), mask=mask,
                         ray_fixed_dt=torch.zeros(R, device=device))
        rgb = tensor(rng.uniform(size=(R * S, 3)))
        if mode == 0:
            val = tensor(rng.uniform(-0.01, 0.01, (R, S)))
            grads = tensor(rng.normal(size=(R * S, 3)))
        else:
            val, grads = tensor(rng.uniform(0, 80, (R, S))), None
        cots = [tensor(rng.normal(size=shape)) for shape in ((R, S), (R, 1), (R,), (R, 3), (R, 3))]
        if mode == 1:
            cots[4] = None
        args = (mode, smp, val, grads, rgb, 2981.0, 1.0, *cots)
        got, want = vr.render_weights_bwd_cuda(*args), vr.render_weights_bwd_plain(*args)
        err = max(((a - b.reshape(a.shape)).abs().max() / b.abs().max()).item()
                  for a, b in zip(got, want) if b is not None)
        ms = time_ms(lambda: vr.render_weights_bwd_cuda(*args), reps, device)
        pms = time_ms(lambda: vr.render_weights_bwd_plain(*args), plain_reps, device)
        per_sample = (4 + 4 + 1 + 12 + 4 + 4 + 12) + (24 if mode == 0 else 0)
        nbytes = R * S * per_sample + R * (12 + 4 + 4 + 12 + 12)
        b = bound_ms(nbytes, OPS_PER_SAMPLE_DB * R * S)
        _report(f"D':{'neus' if mode == 0 else 'nerf'} R={R} S={S} (relative)", err, TOL_DB,
                ms, pms, b)
        if mode == 0:
            timing = (ms, pms, b, max((a - b_.reshape(a.shape)).abs().max().item()
                                      for a, b_ in zip(got, want) if b_ is not None))
    results["D'"] = dict(max_abs_err=timing[3], ms=timing[0], plain_ms=timing[1],
                         bound_ms=timing[2][0], bound_by=timing[2][1])

    # --- I: the occupancy refresh (probe ids and centers; the grid update)
    gcfg = cfg.grid
    n = cfg.grid_nr_random_samples
    jitter = tensor(rng.uniform(-0.5, 0.5, (n, 3)))
    upd = 2501  # an update index past the first 64 (the ids wrap the grid)
    (ck, lk), (cp, lp) = og.grid_points_cuda(gcfg, n, upd, jitter, device), \
        og.grid_points_plain(gcfg, n, upd, jitter, device)
    if not torch.equal(lk, lp):
        fail(f"kernel I: {(lk != lp).sum().item()} probe ids differ from the plain version")
    if torch.unique(lk).numel() != n:
        fail("kernel I: two probes of one update share a voxel")
    err = (ck - cp).abs().max().item()
    sdf = tensor(rng.normal(0, 0.02, n))
    grids = [og.make_occupancy_grid(gcfg, device=device) for _ in range(2)]
    og.grid_update_cuda(gcfg, grids[0], lk, sdf, 2981.0, cfg.grid_occupancy_thresh)
    og.grid_update_plain(gcfg, grids[1], lk, sdf, 2981.0, cfg.grid_occupancy_thresh)
    err = max(err, (grids[0].values - grids[1].values).abs().max().item())
    flips = int((grids[0].occupancy != grids[1].occupancy).sum())
    if flips:
        fail(f"kernel I: {flips} occupancy flags differ from the plain version")

    def run_k():
        c, lin = og.grid_points_cuda(gcfg, n, upd, jitter, device)
        og.grid_update_cuda(gcfg, grids[0], lin, sdf, 2981.0, cfg.grid_occupancy_thresh)

    def run_p():
        c, lin = og.grid_points_plain(gcfg, n, upd, jitter, device)
        og.grid_update_plain(gcfg, grids[1], lin, sdf, 2981.0, cfg.grid_occupancy_thresh)

    ms = time_ms(run_k, reps, device)
    pms = time_ms(run_p, plain_reps, device)
    nbytes = n * (12 + 4 + 12) + n * (4 + 4 + 4 + 1)
    b = bound_ms(nbytes, OPS_PER_PROBE_I * n)
    _report(f"I n={n} grid={gcfg.nr_voxels_per_dim}^3 (both entries; "
            f"{int((~grids[0].occupancy).sum())} voxels emptied)", err, TOL_I, ms, pms, b)
    results["I"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1])
    return results


def counters():
    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

    return {"A": (pe.encode_fwd_cuda,), "B": (pe.encode_point_grad_cuda,),
            "C": (og.probe_sampler_cuda,), "D": (vr.render_weights_cuda,),
            "F": (pe.encode_table_grad_cuda,), "G": (pe.encode_double_backward_cuda,),
            "D'": (vr.render_weights_bwd_cuda,),
            "I": (og.grid_points_cuda, og.grid_update_cuda),
            "J0": (og.chebyshev_field_cuda,), "J1": (st.jump_prepass_cuda,),
            "J2": (st.trace_step_cuda,), "H0": (compaction.nonzero_static_cuda,)}


TRAIN_KERNELS = ("A", "B", "C", "D", "F", "G", "D'", "I")
SPHERE_KERNELS = ("J0", "J1", "J2", "H0", "A", "B")


def reset_counts():
    for fns in counters().values():
        for fn in fns:
            fn.launches = 0


def read_counts():
    return {k: sum(fn.launches for fn in fns) for k, fns in counters().items()}


def slice_phase(device, cfg, params, grids, width, height, chunk, frames=N_FRAMES):
    """``frames`` timed render_image frames on each grid, after one warm-up
    frame (counts reset before, read after). Returns ({grid: (rgb, nrm,
    alpha)}, {grid: counts}, {grid: [ms of each frame]})."""
    import torch

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera()
    K = K * [[width / WIDTH], [height / HEIGHT], [1.0]]
    images, counts, times = {}, {}, {}
    tps.render_image(params, grids["full"], K, tf, width, height, ITER, cfg,
                     chunk=chunk, device=device)  # warm-up (cuBLAS, allocator)
    for name, grid in grids.items():
        reset_counts()
        times[name] = []
        for _ in range(frames):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = tps.render_image(params, grid, K, tf, width, height, ITER, cfg,
                                   chunk=chunk, device=device)
            torch.cuda.synchronize(device)
            times[name].append((time.perf_counter() - t0) * 1e3)
        counts[name] = read_counts()
        images[name] = out
        for t in out:
            if not torch.isfinite(t).all():
                fail(f"render on the {name} grid produced non-finite values")
        med = statistics.median(times[name])
        print(f"[slice] grid={name} {width}x{height} chunk={chunk}, {frames} frames: "
              f"median {med:.1f} ms/frame (min {min(times[name]):.1f}, "
              f"max {max(times[name]):.1f}; all {[round(t, 1) for t in times[name]]}), "
              f"{width * height / med * 1e3:.0f} rays/s at the median, "
              f"launches={counts[name]}, mean alpha={out[2].mean().item():.4f}", flush=True)
    return images, counts, times


KERNEL_SYMBOLS = {"A": "encode_fwd_kernel", "B": "encode_point_grad_kernel",
                  "C": "probe_sampler_kernel", "D": "render_weights_kernel",
                  "F": "encode_table_grad_kernel", "G": "encode_double_backward_kernel",
                  "D'": "render_weights_bwd_kernel", "I": "grid_",
                  "J0": "chebyshev_pass_kernel", "J1": "jump_prepass_kernel",
                  "J2": "trace_step_kernel", "H0": "compact_"}


def profile_phase(device, cfg, params, grid, width, height, chunk, top=12):
    """One more frame under torch.profiler: device time by kernel name, the
    share of kernels A-D, and the device's busy share of the frame's wall
    time. Prints one ``profile`` JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera()
    K = K * [[width / WIDTH], [height / HEIGHT], [1.0]]
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tps.render_image(params, grid, K, tf, width, height, ITER, cfg, chunk=chunk,
                         device=device)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3

    return _profile_summary(prof, wall_ms, "frame", top)


def _profile_summary(prof, wall_ms, what, top=12):
    """Device time by kernel name, the share of the port's kernels and the
    device's busy share of the profiled wall time; prints a ``profile``
    JSON line."""
    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # kernel records only (device_type CUDA): operator records carry the
    # device time of the kernels they launched as well
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    if total_ms <= 0:
        print(json.dumps({"profile": "not measured: the profiler recorded no device time"}))
        return None
    events.sort(key=dev_us, reverse=True)
    by_kernel = {k: sum(dev_us(e) for e in events if sym in e.key) / 1e3
                 for k, sym in KERNEL_SYMBOLS.items()}
    summary = {
        f"{what}_wall_ms_profiled": wall_ms,
        "device_busy_ms": total_ms,
        "device_idle_share": max(0.0, 1.0 - total_ms / wall_ms),
        "kernels_ms": by_kernel,
        "kernels_share_of_device": sum(by_kernel.values()) / total_ms,
        "top": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3, "count": e.count}
                for e in events[:top]],
    }
    print(json.dumps({"profile": {what: summary}}), flush=True)
    return summary


def cross_check(device, cfg, params, grid, image, width, height):
    """The card against the CPU (the plain path) on CROSS_RAYS rays, a block
    at the frame's center. Every level of the SDF is on, so its gradient
    jumps at the fine levels' lattice-cell boundaries; the card and the CPU
    may place an importance sample a float rounding apart (the proxy sdf
    comes from cuBLAS and CPU matmuls), and a ray can then see another
    normal. So:

    1. the CPU's fg samples, rendered on the card (``render_samples``), must
       give the CPU's rgb, normals and weights_sum within TOL_CROSS;
    2. the card's own whole path (``run_net``) may differ by more only on
       rays whose samples differ from the CPU's;
    3. the frame's pixels (chunk 2048) are compared and reported."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera()
    K = K * [[width / WIDTH], [height / HEIGHT], [1.0]]
    side = int(CROSS_RAYS ** 0.5)
    y0, x0 = height // 2 - side // 2, width // 2 - side // 2
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + side), torch.arange(x0, x0 + side),
                            indexing="ij")
    pix = (ys * width + xs).reshape(-1)
    origins, dirs = rays_from_frame(K, tf, width, height, device="cpu")
    o, d = origins[pix], dirs[pix]
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    params_cpu = _tree_map(cpu, params)
    grid_cpu = og.OccupancyGridState(values=cpu(grid.values), occupancy=cpu(grid.occupancy))
    ecfg = tps._eval_cfg(cfg)
    args = (ITER, 1.0, 0.8, ecfg)
    with torch.no_grad():
        ref = tps.run_net(params_cpu, grid_cpu, o, d, *args)
        whole = tps.run_net(params, grid, o.to(device), d.to(device), *args)
        s = ref[3]["samples"]
        smp = RaySamples(*(getattr(s, f).to(device) for f in
                           ("origins", "dirs", "z", "dt", "mask", "ray_fixed_dt")))
        t_exit = tps.BOUND.ray_intersection(o, d)[3].to(device)
        same = tps.render_samples(params, smp, t_exit, *args)

    names = ("rgb", "normals", "weights_sum")

    def per_ray_err(got):
        return torch.stack([(g.cpu() - r).abs().amax(dim=-1) for g, r in zip(got[:3], ref[:3])]
                           ).amax(dim=0)

    errs = {k: (g.cpu() - r).abs().max().item() for k, g, r in zip(names, same[:3], ref[:3])}
    sw = whole[3]["samples"]
    samples_differ = ((sw.mask.cpu() != s.mask).any(dim=1)
                      | ((sw.z.cpu() != s.z) & s.mask).any(dim=1))
    off = per_ray_err(whole) > TOL_CROSS
    unexplained = int((off & ~samples_differ).sum())
    z_diff = ((sw.z.cpu() - s.z).abs() * s.mask).max().item()
    pix_errs = {k: (img.reshape(-1, r.shape[-1])[pix.to(img.device)].cpu() - r).abs().max().item()
                for k, img, r in zip(names, image, ref[:3])}
    pix_off = int((torch.stack([(img.reshape(-1, r.shape[-1])[pix.to(img.device)].cpu() - r
                                 ).abs().amax(dim=-1) for img, r in zip(image, ref[:3])]
                               ).amax(dim=0) > TOL_CROSS).sum())
    summary = {
        "rays": len(pix), "tol": TOL_CROSS,
        "same_samples_max_err": errs,
        "whole_path_max_err": {k: (g.cpu() - r).abs().max().item()
                               for k, g, r in zip(names, whole[:3], ref[:3])},
        "whole_path_rays_off": int(off.sum()),
        "rays_with_other_samples": int(samples_differ.sum()),
        "rays_off_with_the_same_samples": unexplained,
        "max_sample_z_diff": z_diff,
        "frame_pixels_max_err": pix_errs, "frame_pixels_rays_off": pix_off,
        "mean_alpha": ref[2].mean().item(),
    }
    print(json.dumps({"cross_check": summary}), flush=True)
    for k, v in errs.items():
        if not v <= TOL_CROSS:
            fail(f"cross-check {k}: card vs CPU on the same samples {v:.3e} above {TOL_CROSS:.0e}")
    if unexplained:
        fail(f"cross-check: {unexplained} rays differ by more than {TOL_CROSS:.0e} "
             "although card and CPU placed the same samples")
    return summary


def _param_groups(params):
    """The parameter groups the training phase must move."""
    return {"sdf_table": [params["sdf"]["encoding"]["lattice_values"]],
            "rgb_table": [params["rgb"]["encoding"]["lattice_values"]],
            "bg_table": [params["bg"]["encoding"]["lattice_values"]],
            "sdf_mlp": [t for layer in params["sdf"]["mlp_sdf"] for t in layer.values()],
            "rgb_mlp": [t for layer in params["rgb"]["mlp"] for t in layer.values()],
            "bg_mlp": [t for key in ("mlp_feat_and_density", "mlp_rgb")
                       for layer in params["bg"][key] for t in layer.values()],
            "colorcal": list(params["colorcal"].values())}


def train_phase(device, cfg):
    """Sphere init, a saved train state, and ``train`` resumed from it (the
    slice-2 path). Returns (params, grid, reel, launch counts, summary)."""
    import torch

    from permuto_sdf_tpu_torch.datasets.synthetic import make_synthetic_reel
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import checkpoint as ckpt
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    t0 = time.perf_counter()
    reel = make_synthetic_reel(device=device)
    torch.cuda.synchronize(device)
    reel_s = time.perf_counter() - t0
    params = tps.init_params(SEED, cfg, reel.nr_images, device=device)
    optimizer = tps.make_optimizer(cfg)
    opt_state = optimizer.init(params)
    losses = []
    for it in range(4):
        params, opt_state, loss = tps.sphere_init_step(
            params, opt_state, tps.step_generators(SEED, it)[0], it, cfg, optimizer)
        losses.append(float(loss))
    print(f"[train] synthetic reel {reel.nr_images}x{reel.height}x{reel.width} in "
          f"{reel_s:.1f} s; sphere-init losses {[round(x, 4) for x in losses]}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"sphere init: the loss did not fall ({losses})")
    start = cfg.nr_iter_sphere_fit + TRAIN_FROM
    before = {k: [t.clone() for t in v] for k, v in _param_groups(params).items()}
    times, nr_samples = [], []

    def on_step(it, loss, aux, params, grid):
        torch.cuda.synchronize(device)
        times.append(time.perf_counter())
        if not math.isfinite(float(loss)):
            fail(f"train: non-finite loss at iteration {it}")
        nr_samples.append(float(aux["nr_samples"]))

    with tempfile.TemporaryDirectory() as d:
        grid = og.make_occupancy_grid(cfg.grid, device=device)
        tps._save(d, "chip_smoke", start, params, grid, opt_state=opt_state, cfg=cfg,
                  last_inv_s=float(torch.exp(torch.tensor(3.0))))
        resume = ckpt.models_dir(d, "chip_smoke", start)
        torch.cuda.synchronize(device)
        reset_counts()
        times.append(time.perf_counter())
        params, grid, hist = tps.train(reel, cfg, nr_iters=start + 1 + TRAIN_STEPS,
                                       resume_from=resume, log_every=1, callbacks=[on_step],
                                       device=device)
        counts = read_counts()
    steps_ms = [(b - a) * 1e3 for a, b in zip(times[:-1], times[1:])][WARMUP_STEPS:]
    missing = [k for k in TRAIN_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"train: the training path launched no kernel {missing}")
    after = _param_groups(params)
    for name, old in before.items():
        new = after[name]
        if not all(torch.isfinite(t).all() for t in new):
            fail(f"train: parameter group {name} is not finite")
        if all(torch.equal(a, b) for a, b in zip(old, new)):
            fail(f"train: parameter group {name} did not change")
    med = statistics.median(steps_ms)
    samples = statistics.mean(nr_samples)
    summary = {
        "steps": TRAIN_STEPS, "warmup_steps": WARMUP_STEPS, "first_iter": start + 1,
        "ms_per_step_median": med, "ms_per_step_min": min(steps_ms),
        "ms_per_step_max": max(steps_ms), "ms_per_step_all": steps_ms,
        "rays_per_s_median": cfg.nr_rays / med * 1e3,
        "valid_samples_per_step_mean": samples,
        "valid_samples_per_s_median": samples / med * 1e3,
        "launches_per_step": {k: counts[k] / TRAIN_STEPS for k in TRAIN_KERNELS},
        "sphere_init_losses": losses, "final_loss": hist[-1][1],
        "occupied_share": float(grid.occupancy.float().mean()),
    }
    print(f"[train] {TRAIN_STEPS} steps from iteration {start + 1}: median "
          f"{med:.1f} ms/step (min {min(steps_ms):.1f}, max {max(steps_ms):.1f}), "
          f"{summary['rays_per_s_median']:.0f} rays/s, "
          f"{summary['valid_samples_per_s_median']:.0f} valid samples/s, "
          f"launches/step {summary['launches_per_step']}", flush=True)
    return params, grid, reel, counts, summary


def profile_train_step(device, cfg, params, grid, reel):
    """One more training step under torch.profiler: the device's busy and
    idle share of its wall time and the kernels' device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    optimizer = tps.make_optimizer(cfg)
    opt_state = optimizer.init(params)
    it = cfg.nr_iter_sphere_fit + TRAIN_FROM + 100
    draws = tps.draw_train_step(tps.step_generators(SEED, it)[0], cfg, reel)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tps.train_step(params, opt_state, grid, reel, draws, it, cfg, optimizer)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms, "step")


def train_cross_check(device, cfg, params, grid, reel):
    """One full-width training step on the CPU (the plain path) and on the
    card, with the same draws and the CPU's fg samples: the loss within
    TOL_LOSS_CROSS and every leaf's gradient within TOL_GRAD_CROSS
    (relative L2 error); the card's gradients finite."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps
    from permuto_sdf_tpu_torch.train.optimizers import tree_leaves

    cpu = lambda t: t.detach().cpu()  # noqa: E731
    it = cfg.nr_iter_sphere_fit + TRAIN_FROM + 200
    draws = tps.draw_train_step(tps.step_generators(SEED, it)[0], cfg, reel)
    t0 = time.perf_counter()
    loss_c, aux_c, grads_c = tps.compute_loss_and_grads(
        _tree_map(cpu, params), og.OccupancyGridState(cpu(grid.values), cpu(grid.occupancy)),
        reel.to("cpu"), draws, it, cfg)
    cpu_s = time.perf_counter() - t0
    s = aux_c["samples"]
    smp = RaySamples(*(getattr(s, f).to(device) for f in
                       ("origins", "dirs", "z", "dt", "mask", "ray_fixed_dt")))
    loss_g, _, grads_g = tps.compute_loss_and_grads(params, grid, reel, draws, it, cfg,
                                                    fg_samples=smp)
    worst, largest, names = {}, {}, []

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        else:
            names.append(prefix)

    walk(params, "")
    for name, gc, gg in zip(names, tree_leaves(grads_c), tree_leaves(grads_g)):
        if gc is None and gg is None:
            continue
        if gc is None or gg is None:
            fail(f"train cross-check: {name} has a gradient on one side only")
        if not torch.isfinite(gg).all():
            fail(f"train cross-check: non-finite gradient of {name} on the card")
        diff = gg.cpu() - gc
        norm, scale = gc.norm().item(), gc.abs().max().item()
        worst[name] = diff.norm().item() / norm if norm > 0 else diff.norm().item()
        largest[name] = diff.abs().max().item() / scale if scale > 0 else diff.abs().max().item()
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    summary = {"loss_cpu": float(loss_c), "loss_card": float(loss_g),
               "loss_rel_err": loss_err, "tol_loss": TOL_LOSS_CROSS, "tol_grad": TOL_GRAD_CROSS,
               "valid_samples": int(aux_c["nr_samples"]), "cpu_step_s": cpu_s,
               "grad_rel_l2_err": worst, "grad_max_err_rel_to_max": largest}
    print(json.dumps({"train_cross_check": summary}), flush=True)
    if not loss_err <= TOL_LOSS_CROSS:
        fail(f"train cross-check: loss {float(loss_g)} vs {float(loss_c)} on the CPU")
    bad = {k: v for k, v in worst.items() if not v <= TOL_GRAD_CROSS}
    if bad:
        fail(f"train cross-check: gradients off by more than {TOL_GRAD_CROSS}: {bad}")
    return summary


# ---------------------------------------------------------------------------
# Slice 3: the interactive sphere-traced render
# ---------------------------------------------------------------------------

def camera_k(width: int, height: int):
    """The viewer's pinhole at any frame size (focal 1.1 x height, centered),
    and the camera of ``camera()``."""
    import numpy as np

    K = np.array([[height * 1.1, 0, width / 2], [0, height * 1.1, height / 2], [0, 0, 1]],
                 np.float32)
    return K, camera()[1]


def sphere_scene(device, cfg):
    """The full-width model after SPHERE_INIT_STEPS sphere-init steps (its
    SDF then approximates |p| - 0.3), its grid refreshed over every voxel by
    ``occupancy_update`` (all levels open, at the trained inv_s). Returns
    (params, grid, summary)."""
    import torch

    from permuto_sdf_tpu_torch.models.fields import sdf_apply
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    params = tps.init_params(SEED, cfg, device=device)
    optimizer = tps.make_optimizer(cfg)
    opt_state = optimizer.init(params)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    losses = []
    for it in range(SPHERE_INIT_STEPS):
        params, opt_state, loss = tps.sphere_init_step(
            params, opt_state, tps.step_generators(SEED, it)[0], it, cfg, optimizer)
        if it in (0, SPHERE_INIT_STEPS - 1):
            losses.append(float(loss))
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    grid = og.make_occupancy_grid(cfg.grid, device=device)
    updates = cfg.grid.nr_voxels // cfg.grid_nr_random_samples
    t0 = time.perf_counter()
    for k in range(updates):  # 64 consecutive updates visit every voxel once
        tps.occupancy_update(params, grid, torch.Generator().manual_seed(SEED + k),
                             ITER + k * cfg.grid_update_every, INV_S_TRAINED, cfg)
    torch.cuda.synchronize(device)
    refresh_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(SEED)
    pts = ((torch.rand((65536, 3), generator=gen) - 0.5) * 0.9).to(device)
    with torch.no_grad():
        sdf = sdf_apply(params["sdf"], pts, ITER, cfg.sdf_model)[0][:, 0]
    dev = (sdf - (pts.norm(dim=-1) - cfg.sphere_init_radius)).abs()
    summary = {"sphere_init_steps": SPHERE_INIT_STEPS, "first_loss": losses[0],
               "final_loss": losses[-1], "sphere_init_s": init_s,
               "sdf_vs_sphere_mean_abs": dev.mean().item(),
               "sdf_vs_sphere_max_abs": dev.max().item(),
               "grid_updates": updates, "grid_refresh_s": refresh_s,
               "occupied_fraction": grid.occupancy.float().mean().item()}
    print(f"[sphere scene] {SPHERE_INIT_STEPS} sphere-init steps in {init_s:.1f} s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.5f}; |sdf - (|p| - 0.3)| mean "
          f"{summary['sdf_vs_sphere_mean_abs']:.4f} max {summary['sdf_vs_sphere_max_abs']:.4f}; "
          f"grid refreshed by {updates} updates in {refresh_s:.2f} s, occupied fraction "
          f"{summary['occupied_fraction']:.5f}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"sphere scene: the sphere-init loss did not fall ({losses})")
    if not 0 < summary["occupied_fraction"] < 0.2:
        fail(f"sphere scene: the refreshed grid is not a shell ({summary['occupied_fraction']})")
    return params, grid, summary


def _jump_lookups(field, gcfg, o, d, t, allow, jumps):
    """Replays a kernel's chained jumps (J1, J2): the number of field
    lookups and the distinct voxels they read."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    lookups, voxels = 0, []
    for _ in range(jumps):
        lin, inb = og.point_to_lin_idx(gcfg, o + t[:, None] * d)
        lookups += int(allow.sum())
        voxels.append(lin[allow & inb])
        k = torch.where(inb, field[lin].to(torch.int32), 63)
        allow = allow & (k > 1)
        t = torch.where(allow, t + (k - 1).to(t.dtype) * gcfg.voxel_size, t)
    return lookups, int(torch.unique(torch.cat(voxels)).numel())


def sphere_kernel_phases(device, cfg, params, grid, reps=20, plain_reps=3):
    """Kernels J0, J1, J2 and H0 against their plain versions on the sphere
    scene, at the shapes of one 400x400 chunk of the sphere-traced render
    (R = 196,608 rows, the frame's rays padded as the render pads them).
    Kernels that update the state in place are timed from a restored copy
    of it, the restore's own time subtracted. Returns {kernel: numbers}."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    gcfg, cap = cfg.grid, st._EMPTY_DIST_CAP
    results = {}

    # --- J0: the distance field of the refreshed grid
    got = og.chebyshev_field_cuda(gcfg, grid.occupancy, cap)
    want = og.chebyshev_field_plain(gcfg, grid.occupancy, cap)
    err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
    ms = time_ms(lambda: og.chebyshev_field_cuda(gcfg, grid.occupancy, cap), reps, device)
    pms = time_ms(lambda: og.chebyshev_field_plain(gcfg, grid.occupancy, cap), plain_reps, device)
    # the occupancy read once and the uint8 field written once; three passes
    # of a linear-time method
    b = bound_ms(2 * gcfg.nr_voxels, 3 * gcfg.nr_voxels * OPS_PER_CHEBYSHEV_VOXEL_PASS)
    hist = torch.bincount(want.to(torch.int64), minlength=cap + 1)
    _report(f"J0 V={gcfg.nr_voxels_per_dim} cap={cap} (occupied {int(hist[0])}, "
            f"at the cap {int(hist[cap])})", err, 0.0, ms, pms, b)
    results["J0"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1])
    field = got

    # --- the padded state of one 400x400 chunk
    K, tf = camera_k(WIDTH, HEIGHT)
    o, d = rays_from_frame(K, tf, WIDTH, HEIGHT, device=device)
    R = st.pow2_bucket(o.shape[0], lo=256, hi=1 << 21)
    pad = R - o.shape[0]
    o = torch.cat([o, torch.tensor([[10.0, 0.0, 0.0]], device=device).expand(pad, 3)])
    d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]], device=device).expand(pad, 3)])
    _, te, _, tx, hit = tps.BOUND.ray_intersection(o, d)
    state0 = {"origins_f": st._padded(o), "dirs_f": st._padded(d), "texit_f": st._padded(tx[:, 0]),
              "t_f": st._padded(te[:, 0]), "alive_f": st._padded(hit[:, 0], False),
              "conv_f": torch.zeros(R + 1, dtype=torch.bool, device=device),
              "sdf_f": torch.zeros(R + 1, device=device)}
    work = {k: v.clone() for k, v in state0.items()}

    def restore():
        for k, v in work.items():
            v.copy_(state0[k])

    def compare(name, a, b):
        if a.dtype == torch.bool:
            if not torch.equal(a, b):
                fail(f"kernel {name}: {(a != b).sum().item()} flags differ from the plain version")
            return 0.0
        return (a - b).abs().max().item()

    restore_ms = time_ms(restore, reps, device)

    # --- J1: the jump prepass
    jumps = 16
    ks, ps = ({k: v.clone() for k, v in state0.items()} for _ in range(2))
    args = lambda s: (field, s["origins_f"], s["dirs_f"], s["texit_f"], s["t_f"], s["alive_f"])  # noqa: E731
    n_k = st.jump_prepass_cuda(*args(ks), gcfg, jumps)
    n_p = st.jump_prepass_plain(*args(ps), gcfg, jumps)
    err = max(compare("J1", ks[k], ps[k]) for k in ("t_f", "alive_f"))
    if int(n_k) != int(n_p):
        fail(f"kernel J1: alive count {int(n_k)} vs {int(n_p)}")

    def run_j1(fn):
        restore()
        fn(*args(work), gcfg, jumps)

    ms = time_ms(lambda: run_j1(st.jump_prepass_cuda), reps, device) - restore_ms
    pms = time_ms(lambda: run_j1(st.jump_prepass_plain), plain_reps, device) - restore_ms
    lookups, voxels = _jump_lookups(field, gcfg, state0["origins_f"], state0["dirs_f"],
                                    state0["t_f"], state0["alive_f"], jumps)
    b = bound_ms((R + 1) * (12 + 12 + 4 + 4 + 1 + 4 + 1) + voxels + 4, lookups * OPS_PER_LOOKUP)
    _report(f"J1 R={R} jumps={jumps} (alive {int(state0['alive_f'].sum())} -> {int(n_p)}, "
            f"{lookups} lookups of {voxels} voxels)", err, TOL_J, ms, pms, b)
    results["J1"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1])

    # --- H0: the round-0 bucket of the parked rays; below, at and above the count
    state1 = ps  # after the prepass
    mask = (state1["alive_f"] & ~state1["conv_f"])[:R].contiguous()
    count = int(mask.sum())
    bucket = st.pow2_bucket(count, lo=256, hi=R)
    for size in (count // 2, count, bucket):
        gi, gc = compaction.nonzero_static_cuda(mask, size, R)
        wi, wc = compaction.nonzero_static_plain(mask, size, R)
        if not torch.equal(gi, wi) or int(gc) != int(wc):
            fail(f"kernel H0: size {size}: {(gi != wi).sum().item()} ids differ, count "
                 f"{int(gc)} vs {int(wc)}")
    ms = time_ms(lambda: compaction.nonzero_static_cuda(mask, bucket, R), reps, device)
    pms = time_ms(lambda: compaction.nonzero_static_plain(mask, bucket, R), plain_reps, device)
    lib_ms = time_ms(lambda: torch.nonzero(mask), reps, device)
    b = bound_ms(R + 8 * bucket + 4, 2 * R)
    _report(f"H0 n={R} count={count} bucket={bucket} (library torch.nonzero {lib_ms:.4f} ms)",
            0.0, 0.0, ms, pms, b)
    results["H0"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                         library_ms=lib_ms)

    # --- J2: one iteration of round 0 (LOD 6) on that bucket, 4 chained jumps
    idx, _ = compaction.nonzero_static_plain(mask, bucket, R)
    kw = dict(dist_field=field, grid_cfg=gcfg, sdf_multiplier=0.9, sdf_converged_tresh=2e-4,
              jump_substeps=4, jump_gate=gcfg.voxel_size)
    sargs = lambda s: (s["origins_f"], s["dirs_f"], s["texit_f"], s["t_f"], s["alive_f"],  # noqa: E731
                       s["conv_f"], s["sdf_f"])
    pos, _ = st.trace_step_plain(idx, None, *sargs(state1), **kw)
    with torch.no_grad():
        s_val = tps._make_sdf_eval(cfg.sdf_model, ST_KW["lod_schedule"][0])(
            (params["sdf"], ITER), pos)
    ks, ps = ({k: v.clone() for k, v in state1.items()} for _ in range(2))
    out_k = st.trace_step_cuda(idx, s_val, *sargs(ks), **kw, counts=True)
    out_p = st.trace_step_plain(idx, s_val, *sargs(ps), **kw, counts=True)
    err = max([compare("J2", ks[k], ps[k]) for k in ("t_f", "alive_f", "conv_f", "sdf_f")]
              + [compare("J2", out_k[0], out_p[0])])
    if not torch.equal(out_k[1], out_p[1]):
        fail(f"kernel J2: counts {out_k[1].tolist()} vs {out_p[1].tolist()}")
    state0, work = state1, {k: v.clone() for k, v in state1.items()}
    restore_ms = time_ms(restore, reps, device)

    def run_j2(fn):
        restore()
        fn(idx, s_val, *sargs(work), **kw, counts=True)

    ms = time_ms(lambda: run_j2(st.trace_step_cuda), reps, device) - restore_ms
    pms = time_ms(lambda: run_j2(st.trace_step_plain), plain_reps, device) - restore_ms
    real = idx < R
    ii = idx[real]
    alive, conv = state1["alive_f"][ii], state1["conv_f"][ii]
    sv = s_val[real]
    conv = conv | ((sv.abs() < 2e-4) & alive)
    act = ~conv & alive
    lookups, voxels = _jump_lookups(field, gcfg, state1["origins_f"][ii], state1["dirs_f"][ii],
                                    state1["t_f"][ii] + sv * 0.9, act & (sv > gcfg.voxel_size), 4)
    per_ray = 8 + 4 + (12 + 12 + 4 + 4 + 1 + 1 + 4) + (4 + 1 + 1 + 4) + 12
    b = bound_ms(bucket * per_ray + voxels + 8, bucket * OPS_PER_TRACE_STEP
                 + lookups * OPS_PER_LOOKUP)
    _report(f"J2 R={R} bucket={bucket} substeps=4 (counts {out_p[1].tolist()}, {lookups} "
            f"lookups of {voxels} voxels)", err, TOL_J, ms, pms, b)
    results["J2"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1])
    return results, field


def sphere_render_phase(device, cfg, scenes):
    """Sphere-traced frames at the viewer's operating point: for each run
    (scene, width, height, frames) the field's build time apart, then the
    launch counts reset, one warm-up frame (the render builds and caches the
    field) and the timed frames (host clock ending in a synchronize), the
    counts read. Returns {run: summary}."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    out = {}
    for run, scene, width, height, frames in ST_RUNS:
        params, grid = scenes[scene]
        K, tf = camera_k(width, height)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        og.chebyshev_empty_distance(cfg.grid, grid.occupancy, st._EMPTY_DIST_CAP)
        torch.cuda.synchronize(device)
        field_ms = (time.perf_counter() - t0) * 1e3
        reset_counts()
        times, stats = [], []
        for f in range(frames + 1):
            stats = []
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            img = tps.render_image_sphere_traced_fast(params, grid, K, tf, width, height, ITER,
                                                      cfg, device=device, stats_out=stats,
                                                      **ST_KW)
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        missing = [k for k in SPHERE_KERNELS if counts[k] <= 0]
        if missing:
            fail(f"sphere-traced render {run}: no launch of kernel {missing}")
        for t in img:
            if not torch.isfinite(t).all():
                fail(f"sphere-traced render {run}: non-finite values")
        warm, timed = times[0], times[1:]
        med = statistics.median(timed)
        stats = [(s[0], int(s[1])) if s[0] == "lit" else s for s in stats]
        lit = sum(s[1] for s in stats if s[0] == "lit")
        out[run] = {"width": width, "height": height, "frames": frames,
                    "ms_per_frame_median": med, "ms_per_frame_min": min(timed),
                    "ms_per_frame_max": max(timed), "ms_per_frame_all": timed,
                    "warmup_frame_ms": warm, "field_build_ms": field_ms,
                    "rays_per_s_median": width * height / med * 1e3,
                    "launches_per_frame": {k: counts[k] / (frames + 1) for k in SPHERE_KERNELS},
                    "stats_last_frame": stats, "lit": lit,
                    "mean_alpha": img[2].mean().item(), "launches": counts}
        print(f"[sphere_traced] {run} {width}x{height}, {frames} frames: median {med:.1f} "
              f"ms/frame (min {min(timed):.1f}, max {max(timed):.1f}; all "
              f"{[round(t, 1) for t in timed]}), warm-up {warm:.1f} ms, field build "
              f"{field_ms:.2f} ms; lit {lit}; launches/frame "
              f"{ {k: round(v, 2) for k, v in out[run]['launches_per_frame'].items()} }; "
              f"rounds {stats}", flush=True)
        if lit <= 0:
            fail(f"sphere-traced render {run}: nothing lit")
    return out


def profile_sphere_frame(device, cfg, params, grid):
    """One more 400x400 sphere-traced frame under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera_k(WIDTH, HEIGHT)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tps.render_image_sphere_traced_fast(params, grid, K, tf, WIDTH, HEIGHT, ITER, cfg,
                                            device=device, **ST_KW)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms, "sphere_frame")


def _sphere_trace_rays(params, grid, o, d, cfg, field):
    """The render's trace and lit gate for one chunk of rays (the body of
    render_image_sphere_traced_fast at ST_KW) -> (final positions, lit)."""
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    ctx = (params["sdf"], ITER)
    march, refine, refine_ctx, rounds = tps._make_trace_lod_evals(
        cfg, ctx, None, ST_KW["lod_schedule"])
    pos, _, conv, alive = st.sphere_trace_adaptive(
        march, ctx, o, d, tps.BOUND, ST_KW["nr_rounds"], ST_KW["iters_per_round"],
        grid_cfg=cfg.grid, grid=grid, refine_sdf_eval=refine, refine_ctx=refine_ctx,
        nr_refine_iters=ST_KW["nr_refine_iters"], dist_field=field, round_sdf_evals=rounds,
        final_refresh=False, jump_substeps=4, prepass_jumps=16)
    return pos, tps._lit_and_state(pos, conv, alive, grid, cfg.grid, cfg)


def _strided_camera(width, height, side):
    """The camera of a side x side frame whose pixel centers are every
    stride-th pixel center of the width x height frame (centered): a strided
    subsample of the whole view, misses and silhouettes included."""
    K, tf = camera_k(width, height)
    K = K.copy()
    for axis, n in ((0, width), (1, height)):
        stride = n // side
        off = (n - stride * (side - 1) - 1) // 2
        K[axis, axis] /= stride
        K[axis, 2] = 0.5 - (off + 0.5 - K[axis, 2]) / stride
    return K, tf


def sphere_cross_check(device, cfg, params, grid, field):
    """CROSS_RAYS rays (a strided subsample of the whole 400x400 view) of
    the sphere scene rendered on the card and on the CPU (plain versions;
    the same params and grid; the CPU takes the card's distance field,
    which equals J0's plain version exactly, rather than 63 min-pool sweeps
    of the 256^3 grid on the host). The sample must hold rays that miss the
    bound, rays that die in the jump prepass and lit rays. Then:

    1. through ``render_image_sphere_traced_fast``: the lit masks agree on
       ST_CROSS_LIT_AGREE of the rays;
    2. the CPU's final positions and lit mask shaded on the card
       (``_shade_hits_compact``) give the CPU's uint8 rgb and normals within
       TOL_ST_CROSS on every lit ray;
    3. on the whole path, a ray lit in both may differ by more only where
       the card's final position differs from the CPU's, by at most
       ST_CROSS_MAX_POS_GAP, and such rays are at most
       ST_CROSS_MAX_OFF_SHARE of the rays lit in both."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    side = int(CROSS_RAYS ** 0.5)
    K, tf = _strided_camera(WIDTH, HEIGHT, side)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    params_cpu = _tree_map(cpu, params)
    grid_cpu = og.OccupancyGridState(cpu(grid.values), cpu(grid.occupancy))
    stats_c, stats_p = [], []
    card = tps.render_image_sphere_traced_fast(params, grid, K, tf, side, side, ITER, cfg,
                                               device=device, stats_out=stats_c, **ST_KW)
    t0 = time.perf_counter()
    ref = tps.render_image_sphere_traced_fast(params_cpu, grid_cpu, K, tf, side, side, ITER, cfg,
                                              device="cpu", dist_field=cpu(field),
                                              stats_out=stats_p, **ST_KW)
    cpu_s = time.perf_counter() - t0
    lit_c, lit_p = card[2].cpu()[..., 0].reshape(-1) > 0, ref[2][..., 0].reshape(-1) > 0
    both = lit_c & lit_p
    agree = (lit_c == lit_p).float().mean().item()
    err = {k: (card[i].cpu() - ref[i]).abs().amax(dim=-1).reshape(-1)
           for i, k in ((0, "rgb"), (1, "normals"))}

    o, d = rays_from_frame(K, tf, side, side, device="cpu")
    n = o.shape[0]
    _, te, _, tx, meets = tps.BOUND.ray_intersection(o, d)
    alive = st._padded(meets[:, 0], False)
    after_prepass = int(st.jump_prepass_plain(
        cpu(field), st._padded(o), st._padded(d), st._padded(tx[:, 0]), st._padded(te[:, 0]),
        alive, cfg.grid, 16))
    with torch.no_grad():
        pos_c, _ = _sphere_trace_rays(params, grid, o.to(device), d.to(device), cfg, field)
        pos_p, lit_pp = _sphere_trace_rays(params_cpu, grid_cpu, o, d, cfg, cpu(field))
        same = tps._shade_hits_compact(params, pos_p.to(device), d.to(device), lit_pp.to(device),
                                       ITER, cfg, n)
        want = tps._shade_hits_compact(params_cpu, pos_p, d, lit_pp, ITER, cfg, n)
    valid = want[0] < n
    steps = max(((a.cpu().to(torch.int32) - b.to(torch.int32)).abs()[valid].max().item()
                 if valid.any() else 0) for a, b in zip(same[1:3], want[1:3]))
    gap = (pos_c.cpu() - pos_p).abs().amax(dim=-1)
    off = both & ((err["rgb"] > TOL_ST_CROSS) | (err["normals"] > TOL_ST_CROSS))
    unexcused = off & ~((gap > 0) & (gap <= ST_CROSS_MAX_POS_GAP))
    n_meet = int(meets.sum())
    summary = {"rays": n, "stride": WIDTH // side, "miss_the_bound": n - n_meet,
               "die_in_prepass": n_meet - after_prepass,
               "lit_card": int(lit_c.sum()), "lit_cpu": int(lit_p.sum()),
               "lit_agreement": agree, "rays_lit_differently": int((lit_c != lit_p).sum()),
               "rounds_card": [list(map(int, r[1:])) for r in stats_c if r[0] != "lit"],
               "rounds_cpu": [list(map(int, r[1:])) for r in stats_p if r[0] != "lit"],
               "same_positions_max_err_uint8_steps": steps,
               "whole_path_rgb_max_err": err["rgb"][both].max().item(),
               "whole_path_normals_max_err": err["normals"][both].max().item(),
               "whole_path_rays_off": int(off.sum()),
               "rays_with_other_positions": int((gap > 0).sum()),
               "max_position_gap": gap.max().item(),
               "off_rays_position_gaps": gap[off].tolist(),
               "off_rays_unexcused": int(unexcused.sum()),
               "tol": TOL_ST_CROSS, "min_lit_agreement": ST_CROSS_LIT_AGREE,
               "max_off_share": ST_CROSS_MAX_OFF_SHARE, "max_pos_gap": ST_CROSS_MAX_POS_GAP,
               "cpu_s": cpu_s}
    print(json.dumps({"sphere_cross_check": summary}), flush=True)
    if not (summary["miss_the_bound"] and summary["die_in_prepass"] and lit_p.any()
            and not lit_p.all()):
        fail(f"sphere cross-check: the sample lacks misses, prepass deaths or lit rays "
             f"({summary})")
    if not torch.equal(lit_pp, lit_p):
        fail("sphere cross-check: the CPU's render and its trace disagree")
    if not agree >= ST_CROSS_LIT_AGREE:
        fail(f"sphere cross-check: lit masks agree on {agree:.4f} of the rays")
    if not steps / 255.0 <= TOL_ST_CROSS:
        fail(f"sphere cross-check: the CPU's positions shaded on the card differ by {steps}/255")
    if summary["off_rays_unexcused"]:
        fail(f"sphere cross-check: {summary['off_rays_unexcused']} rays differ by more than "
             f"{TOL_ST_CROSS:.4f} at a final position the same as the CPU's or more than "
             f"{ST_CROSS_MAX_POS_GAP:g} from it")
    if not summary["whole_path_rays_off"] <= ST_CROSS_MAX_OFF_SHARE * int(both.sum()):
        fail(f"sphere cross-check: {summary['whole_path_rays_off']} of {int(both.sum())} rays lit "
             f"in both differ by more than {TOL_ST_CROSS:.4f}")
    return summary


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from permuto_sdf_tpu_torch import kernels
        from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 3

    # 1. card, precision, build
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("precision: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False (float32 matmuls)", flush=True)
    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per library "
          f"{ {k: round(v, 1) for k, v in built.items()} } into {kernels.build_dir()}", flush=True)
    for name in kernels.LIBRARIES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
    device = torch.device("cuda")
    cfg = tps.PermutoSDFTrainConfig()

    # 2. kernels against their plain versions
    results = kernel_phases(device, cfg)
    results.update(train_kernel_phases(device, cfg))

    # 3. the slice: full-width render on both grids
    params = plant_plane_sdf(tps.init_params(SEED, cfg, device=device))
    grids = {"full": tps.og.make_occupancy_grid(cfg.grid, device=device),
             "shell": shell_grid(cfg.grid, device)}
    images, counts, times = slice_phase(device, cfg, params, grids, WIDTH, HEIGHT, CHUNK)
    for name, c in counts.items():
        missing = [k for k in "ABCD" if c[k] <= 0]
        if missing:
            fail(f"render on the {name} grid launched no kernel {missing}")

    # where the frame's device time goes (one extra profiled frame)
    profile_phase(device, cfg, params, grids["full"], WIDTH, HEIGHT, CHUNK)

    # 4. the card against the CPU on the same rays
    cross_check(device, cfg, params, grids["full"], images["full"], WIDTH, HEIGHT)

    # 5. the training slice: sphere init, a saved state, train resumed from it
    tparams, tgrid, reel, train_counts, train_summary = train_phase(device, cfg)
    train_summary["profile"] = profile_train_step(device, cfg, tparams, tgrid, reel)

    # 6. the card against the CPU on one training step
    train_cross_check(device, cfg, tparams, tgrid, reel)

    # 7. the sphere scene and the plane scene; J0-J2 and H0 against their plain versions
    sphere_params, sphere_grid, scene_summary = sphere_scene(device, cfg)
    st_results, field = sphere_kernel_phases(device, cfg, sphere_params, sphere_grid)
    results.update(st_results)
    scenes = {"sphere": (sphere_params, sphere_grid), "plane": (params, grids["full"])}

    # 8. sphere-traced frames at the viewer's operating point, one profiled
    st_runs = sphere_render_phase(device, cfg, scenes)
    st_profile = profile_sphere_frame(device, cfg, sphere_params, sphere_grid)

    # 9. the card against the CPU on 1024 sphere-traced rays
    st_cross = sphere_cross_check(device, cfg, sphere_params, sphere_grid, field)

    # 10. summary lines
    meta = {
        "A": ("permuto_encode_fwd", "permuto_sdf_tpu_torch/kernels/csrc/permuto_encoding.cu",
              "permuto_sdf_tpu/ops/permuto_encoding.py:504"),
        "B": ("permuto_encode_point_grad", "permuto_sdf_tpu_torch/kernels/csrc/permuto_encoding.cu",
              "permuto_sdf_tpu/models/fields.py:167"),
        "C": ("occupancy_probe_sampler", "permuto_sdf_tpu_torch/kernels/csrc/occupancy_grid.cu",
              "permuto_sdf_tpu/ops/occupancy_grid.py:226"),
        "D": ("neus_nerf_render_weights", "permuto_sdf_tpu_torch/kernels/csrc/volume_rendering.cu",
              "permuto_sdf_tpu/ops/volume_rendering.py:151"),
        "F": ("permuto_encode_table_grad", "permuto_sdf_tpu_torch/kernels/csrc/permuto_encoding.cu",
              "permuto_sdf_tpu/ops/permuto_encoding.py:475"),
        "G": ("permuto_encode_double_backward",
              "permuto_sdf_tpu_torch/kernels/csrc/permuto_encoding.cu",
              "permuto_sdf_tpu/models/fields.py:167"),
        "D'": ("neus_nerf_render_weights_bwd",
               "permuto_sdf_tpu_torch/kernels/csrc/volume_rendering.cu",
               "permuto_sdf_tpu/ops/volume_rendering.py:151"),
        "I": ("occupancy_grid_refresh", "permuto_sdf_tpu_torch/kernels/csrc/occupancy_grid.cu",
              "permuto_sdf_tpu/ops/occupancy_grid.py:179"),
        "J0": ("chebyshev_empty_distance", "permuto_sdf_tpu_torch/kernels/csrc/sphere_trace.cu",
               "permuto_sdf_tpu/ops/occupancy_grid.py:315"),
        "J1": ("sphere_trace_jump_prepass", "permuto_sdf_tpu_torch/kernels/csrc/sphere_trace.cu",
               "permuto_sdf_tpu/ops/sphere_trace.py:394"),
        "J2": ("sphere_trace_step", "permuto_sdf_tpu_torch/kernels/csrc/sphere_trace.cu",
               "permuto_sdf_tpu/ops/sphere_trace.py:337"),
        "H0": ("nonzero_static_compaction", "permuto_sdf_tpu_torch/kernels/csrc/compaction.cu",
               "permuto_sdf_tpu/ops/sphere_trace.py:328"),
    }
    entries = []
    for k, (name, source, replaces) in meta.items():
        r = results[k]
        launches = (sum(c[k] for c in counts.values()) + train_counts[k]
                    + sum(v["launches"][k] for v in st_runs.values()))
        entries.append({"name": f"{k}:{name}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    render = {}
    for k, v in times.items():
        med = statistics.median(v)
        render[k] = {"ms_per_frame_median": med, "ms_per_frame_min": min(v),
                     "ms_per_frame_max": max(v), "ms_per_frame_all": v,
                     "rays_per_s_median": WIDTH * HEIGHT / med * 1e3,
                     "launches_per_frame": {n: c / N_FRAMES for n, c in counts[k].items()
                                            if n in "ABCD"}}
    print(json.dumps({"render": render, "card": card}), flush=True)
    print(json.dumps({"train": train_summary, "card": card}), flush=True)
    print(json.dumps({"sphere_traced": {"operating_point": ST_KW, "scene": scene_summary,
                                        "runs": st_runs, "cross_check": st_cross,
                                        "profile": st_profile}, "card": card}), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
