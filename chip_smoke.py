#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``permuto_sdf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. print the card (``nvidia-smi`` name and power limit), turn TF32 off for
   matmuls and convolutions, build the kernels from ``kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card, with the
   tolerance stated, and time both (CUDA events): A-D at the shapes of one
   2048-ray chunk of the flagship eval render (A and B on uniformly random
   points and on the frame's centre chunk in ray order, 96 samples per ray
   between the bound sphere's entry and exit), F, G, D' and I at the shapes
   of the flagship training step (F and G at its fg and background counts
   on three point sets, random, ray-ordered and clustered, each with every
   level and with parity, device ms and bound for each; D' also at the
   other mode's S, at S = 70 and on masks that are not prefixes; I's two
   entries, and If, the flagship refresh in one launch: 262,144 probes of
   the 256^3 grid, the SDF on 14 of 24 levels at IF_C2F_ITER, random
   weights, against its plain version within TOL_IF, timed beside the
   unfused refresh it replaced); time the interleaved [L, C, 2] copy of one
   table that A, B and G read;
3. render 400x400 frames of the full-width flagship model (random weights
   from a seed, plus a planted plane SDF so the frame has a surface) with
   ``render_image`` on a fully occupied grid and on a sparse shell grid,
   N_FRAMES timed frames each after a warm-up (median and spread), with
   every kernel's launch count and the interleaved-table copies reset just
   before and read just after (at most one copy per hash table);
4. render 1024 of those rays again on the CPU (the plain path) and compare:
   the CPU's samples rendered on the card must agree within TOL_CROSS,
   and the card's whole path may differ by more only on rays whose
   samples differ from the CPU's;
5. train the full-width flagship model on the synthetic scene (24 views,
   200x200): 4 ``sphere_init_step`` s (the loss must fall), ``_save`` of
   the train state at iteration nr_iter_sphere_fit + TRAIN_FROM (every SDF
   level open, curvature on, the lr past warm-up), then ``train`` resumed
   from it for TRAIN_STEPS steps (3 occupancy refreshes), with the launch
   counts reset before and read after (every grid refresh one launch of
   If and none of I's entries); ms/step, rays/s, launches per step,
   at most one interleaved-table copy per hash table per step, every
   parameter group changed and finite; one more step profiled;
6. one full-width training step on the card and on the CPU with the same
   draws and the CPU's fg samples: the loss and every leaf's gradient
   within TOL_GRAD_CROSS (and the colour loss's L1 residuals of opposite
   sign on the two sides counted);
7. the sphere scene (the full-width model after SPHERE_INIT_STEPS
   ``sphere_init_step`` s, its grid refreshed over every voxel) and the
   planted-plane scene on a full grid; If on the scene's trained SDF
   against its plain version, and one ``occupancy_update`` on the card
   against the same call on the CPU (same parameters and jitter: one If
   launch, values within TOL_IF); kernels J0, J1, J2 and H0 against
   their plain versions at the shapes of one 400x400 chunk of
   ``render_image_sphere_traced_fast`` (H0 also with each second-mask mode,
   timed beside ``torch.nonzero_static``);
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
10. kernels E1 and E2 (the importance stage) against their plain versions
   on one chunk's samples (rounds at S = 64 and 80, no jitter) and one
   training batch's (jitter on), H1 and H2 (the hit-ray take and scatter,
   and H2's backward) at the training step's shapes (both also on their
   arrays based at an odd element and on rows of odd widths, H2 with
   nonzero fills; one launch a call, device ms a launch); the exact frames of
   phase 3 launch E1 and E2 twice per chunk each;
11. LOD frames (``render_image(lod=(12, 32))``, the viewer's volumetric
   mode) at 400x400 on the sphere and the plane scene, timed, against the
   exact frame of the same scene (PSNR of rgb and alpha, pixels off by
   more than 0.1), one profiled, and 1024 LOD rays on the card against the
   CPU (the CPU's selected samples rendered on the card within TOL_CROSS;
   on the whole path a ray may be off by more only where its selected set
   differs or its samples lie at most LOD_CROSS_MAX_Z_GAP from the CPU's,
   on at most LOD_CROSS_MAX_OFF_SHARE of the rays);
12. hit-ray compaction in training on the sphere scene: a late-compacted
   step against the dense step on the same draws, and an early-compacted
   step against the dense step on the same draws with the importance
   jitter zero (loss within TOL_HIT_LOSS, gradients within TOL_GRAD_CROSS), then
   TRAIN_STEPS steps of ``train`` with and without ``hit_ray_frac``
   (ms/step, apart before and after the window's rebalancer point, the
   settled fraction, H1/H2 launches per step);
13. the recommended training profile (LEVER_PROFILE: the train-time LOD,
   alternating-level table gradients, the lever gate): kernels L, D2 and
   D2' against their plain versions on one lever step's samples (the
   selection exact but for ties under rounding, counted), F and G with
   parity 0 and 1 against the same kernels without it (frozen levels
   exactly zero); TRAIN_STEPS steps of ``train`` across the AUTO gate
   beside the reference profile (the levers off before it and on after,
   L/D2/D2' once per step from it on, ms/step and launches per step on
   each side), a sphere-scene window across an explicit gate with hit-ray
   compaction, and one lever step (parity 1) card against CPU within
   TOL_LOSS_CROSS and TOL_GRAD_CROSS;
14. mesh extraction (kernel M, marching tetrahedra): M1 (triangle counts
   per tile and per 32-cube word) and M2 (the emission and its hash-table
   weld) against their plain versions on a planted 128^3 grid (exact-level
   nodes, degenerate faces) and on the sphere scene's 256^3 and 512^3
   grids (counts, keys, degenerate flags and each emission's first
   emission of its key exactly, world vertices within TOL_M_ULP; the
   welded V and F equal to the plain weld's), timed with the ranking glue
   and as a whole; kernel A and the whole SDF of one 64^3 block of the
   grid SDF (row M0);
15. the SDF-from-mesh slice: ``train_sdf_from_mesh.train`` at full width
   on the UV sphere for SDF_MESH_STEPS steps (the loss must fall), one step
   card against CPU (loss within TOL_SDF_MESH_LOSS, every leaf's gradient
   within TOL_SDF_MESH_GRAD), ``main(["--smoke", "--out_mesh", ...])``, and
   extraction at 196^3, 256^3 and 512^3 of the trained field and of the
   sphere scene (ms per mesh split into the grid SDF and M, M the median
   of MESH_M_REPS calls after the first, V and F, the
   closed-edge share, Chamfer against the ground-truth sphere mesh; V and
   F equal to the plain path's at 196^3 and 256^3); launches counted per
   step over the SDF_MESH_STEPS-step run and per mesh over each
   extraction's grid SDF and first M call (at most one interleaved-table
   copy per mesh);
16. slice 7, the plain sphere tracers: kernel C3 (the first occupied
   probe) on every ray of the 400x400 view and at one PT_CHUNK-ray chunk,
   on the sphere scene's grid and on an empty, a random sparse and a full
   one (each with its distance field, which C3 reads), a grid refresh
   between two seeds (the trainer's cached field rebuilt, the second seed
   as the plain version's), and J3 (the plain tracers' step on position
   state) at one PT_CHUNK-ray chunk against their plain versions (has and
   t_first exact; flags exact, positions within TOL_J3);
   ``render_image_sphere_traced`` (chunk PT_CHUNK, PT_TRACES traces) at
   400x400 on both scenes beside the fast tracer's ms/frame, and
   ``render_rays_sphere_traced_compacted`` on the whole sphere-scene view,
   with the launch counts read per path (J3 exactly PT_TRACES per chunk);
   1024 plain-traced rays card against CPU at the sphere-frame gates of
   phase 9;
17. slice 7, sampling without the grid and NeRF: kernels C2 (the bound
   sphere's intersection and the uniform fg samples in one launch, also on
   a batch with misses, bit for bit: TOL_C2_ULP, TOL_C2) and I2 (the
   density refresh) against their plain versions at the NeRF step's
   shapes (exact); ``train_nerf.train`` at
   ``NerfTrainConfig()`` on the synthetic reel (NERF_STEPS steps, 3 grid
   refreshes, ms/step from the difference with a NERF_SHORT-step run;
   rays/s, valid fg samples/s, launches per step), ``render_image`` of one
   view, one NeRF step card against CPU (TOL_LOSS_CROSS, TOL_GRAD_CROSS),
   ``main(["--smoke"])`` in process; and TRAIN_STEPS flagship steps with
   ``use_occupancy_grid=False`` (C2 once per step, C and I never, no
   plain bound intersection), then one step of each window under
   torch.profiler (device launches a step, device busy ms, idle share);
18. print ``render``, ``fg_sets``, ``train``, ``sphere_traced``, ``lod``,
   ``hit_ray_train``, ``levers``, ``mesh``, ``plain_traced``, ``nerf`` and
   ``kernels`` JSON lines, then as the last line
   ``{"ok": true, "device": {...}}``.

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
TF32_FLOPS = 495e12  # H100 SXM data sheet, TF32 on the tensor cores (dense)

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
# Kernel If (the refresh in one launch) vs its plain version, and a card
# refresh vs a CPU refresh: the MLP's sums in fmaf order against the
# matmuls' blocking move the sdf by float rounding (as J3f's TOL_FUSED); a
# voxel's flag may differ only where the threshold lies between the two
# values' densities, on at most max(FUSED_MAX_ROWS, FUSED_SHARE of the
# probes) voxels, and every voxel no probe visits stays as it was.
TOL_IF = 1e-5
IF_C2F_ITER = 2000  # the flagship's c2f window still closes levels here (10,000 iterations)
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
# The colour loss's L1 ties in that comparison: |gt - pred| within L1_TIE
# on both sides with opposite signs (counted by train_cross_check). When
# every sign flip is such a tie, both sides are evaluated again with the
# ground truth of the tied channels moved by L1_TIE_SHIFT toward the CPU's
# residual sign, so both take the same L1 subgradient there, and the gate
# judges that evaluation (cross_check_gate).
L1_TIE = 1e-6
L1_TIE_SHIFT = 4 * L1_TIE

# E1 and E2 vs their plain versions: the CDF's sums and products run in
# another order (E1 accumulates in double, the plain CUDA scans in float),
# which moves a drawn z by (cdf rounding) / (bracket weight) x (bracket
# length); E2's order and dt are exact.
TOL_E = 1e-5

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
# E1 per sample: the section alpha (two logistic sigmoids ~ 2 x 12, the
# mid-point, slope and clamps ~ 15), the transmittance, weight, sum,
# normalization and CDF ~ 8; per drawn sample: the binary search over S
# (~ 3 per step, 7 steps) and the interpolation and snap ~ 14.
OPS_PER_SAMPLE_E1 = 47
OPS_PER_DRAW_E1 = 35
# E2 per output slot, beyond a merge's log2(S) comparisons: the slot's dt ~ 4.
OPS_PER_SLOT_E2 = 4
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
# The LOD render's card-vs-CPU check (slice 4) on the same terms: a ray may be
# off by more than TOL_CROSS on the whole path only where its selected set
# differs from the CPU's, or where its samples' z differ from the CPU's by at
# most LOD_CROSS_MAX_Z_GAP (the importance stage's CDF sums in another order);
# at most LOD_CROSS_MAX_OFF_SHARE of the rays.
LOD_CROSS_MAX_OFF_SHARE = 0.01
LOD_CROSS_MAX_Z_GAP = 1e-6


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


def _dev_us(e):
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else getattr(e, "self_cuda_time_total", 0)


def _kernel_events(prof, kernel):
    """The profiler's kernel records (device_type CUDA) of ``kernel``'s
    symbols (KERNEL_SYMBOLS)."""
    sym = KERNEL_SYMBOLS[kernel]
    sym = sym if isinstance(sym, tuple) else (sym,)
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and any(x in e.key for x in sym)]


def device_ms(fn, kernel: str, device, reps: int = 10, per_launch: bool = False,
              launches: int = 1):
    """The card's ms per call of ``fn`` in ``kernel``'s own symbols
    (torch.profiler over ``reps`` calls after one warm-up call; launches of
    other kernels in ``fn`` are left out), or with ``per_launch`` per
    ``launches`` launches of the kernel's symbols among the records the
    profiler delivered (for a function of ``launches`` launches a call, a
    record the profiler drops then biases nothing); None if three profiled
    runs recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    for _ in range(3):  # the profiler now and then delivers no device records: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        events = _kernel_events(prof, kernel)
        us = sum(_dev_us(e) for e in events)
        if us > 0:
            calls = sum(e.count for e in events) / launches if per_launch else reps
            return us / 1e3 / calls
    return None


def device_ms_all(fn, device, reps: int = 10):
    """(the card's ms per call of ``fn`` in all its device activities,
    kernels, memsets and copies; their number a call): a library call's,
    whose kernels have no symbols of the port; (None, None) if three
    profiled runs recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA") and _dev_us(e) > 0]
        us = sum(_dev_us(e) for e in events)
        if us > 0:
            return us / 1e3 / reps, sum(e.count for e in events) / reps
    return None, None


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


def centre_chunk_rays(device):
    """The CHUNK rays through the frame's centre and their entry and exit
    of the bound sphere: (origins, dirs, t_entry, t_exit)."""
    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere

    K_cam, tf = camera()
    origins, dirs = rays_from_frame(K_cam, tf, WIDTH, HEIGHT, device=device)
    mid = (origins.shape[0] // 2 // CHUNK) * CHUNK
    o, dr = origins[mid:mid + CHUNK].contiguous(), dirs[mid:mid + CHUNK].contiguous()
    _, te, _, tx, _ = Sphere().ray_intersection(o, dr)
    return o, dr, te, tx


def ray_ordered_points(device, per_ray: int):
    """``per_ray`` points along each centre-chunk ray at the midpoints of
    equal steps between the bound sphere's entry and exit, in ray order
    (ray major, as the eval render's chunk lays its samples out)."""
    import torch

    o, dr, te, tx = centre_chunk_rays(device)
    te, tx = te.reshape(-1, 1), tx.reshape(-1, 1)
    frac = (torch.arange(per_ray, device=device, dtype=torch.float32) + 0.5) / per_ray
    t = te + frac[None, :] * (tx - te).clamp_min(0.0)
    return (o[:, None, :] + t[..., None] * dr[:, None, :]).reshape(-1, 3).contiguous()


FG_CLUSTER_SIDE = 0.01


def fg_point_sets(device, n: int, d: int, per_ray: int, seed: int) -> dict:
    """The point sets kernels F and G are held and timed on, n points of d
    dimensions each: "random", uniform in [-0.45, 0.45]^d; "rays", n //
    per_ray rays through random pixels of ``camera()`` that hit the bound
    sphere, ray major as a training step lays out its samples (d = 3:
    per_ray points at the midpoints of equal steps between the sphere's
    entry and exit, the fg samples; d = 4: the background's per_ray NeRF++
    samples beyond the exit, ``compute_samples_bg``); "clustered", uniform
    in a cube of side FG_CLUSTER_SIDE, where every level coarser than the
    cube gives all points the same few slots (the worst contention)."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
    from permuto_sdf_tpu_torch.ops.ray_sampler import compute_samples_bg

    rng = np.random.default_rng(seed)
    bound = Sphere()
    origins, dirs = rays_from_frame(*camera(), WIDTH, HEIGHT, device=device)
    hits = torch.nonzero(bound.ray_intersection(origins, dirs)[4].reshape(-1)).reshape(-1)
    pick = hits[torch.from_numpy(rng.choice(hits.numel(), n // per_ray, replace=False)).to(
        device)]
    o, dr = origins[pick], dirs[pick]
    _, te, _, tx, _ = bound.ray_intersection(o, dr)
    if d == 3:
        frac = (torch.arange(per_ray, device=device, dtype=torch.float32) + 0.5) / per_ray
        t = te + frac[None, :] * (tx - te)
        rays = o[:, None, :] + t[..., None] * dr[:, None, :]
    else:
        rays = compute_samples_bg(o, dr, tx, per_ray, bound.radius, bound.center).pos_4d
    corner = rng.uniform(-0.4, 0.4 - FG_CLUSTER_SIDE, d)
    sets = {"random": rng.uniform(-0.45, 0.45, (n, d)), "rays": rays.reshape(n, d),
            "clustered": corner + rng.uniform(0.0, FG_CLUSTER_SIDE, (n, d))}
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float32) if isinstance(v, np.ndarray)
                               else v, device=device).contiguous() for k, v in sets.items()}


def grid_block_points(device, res: int = None):
    """The first 64^3 block of ``sdf_grid``'s points on a res^3 grid over
    [-0.5, 0.5]^3, in grid order (row M0)."""
    import numpy as np
    import torch

    res = MESH_SCENE_RES if res is None else res
    axis = torch.from_numpy(np.linspace(-0.5, 0.5, res, dtype=np.float32)).to(device)[:64]
    return torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)


def encoding_tables(params) -> int:
    """The number of distinct hash tables (``lattice_values``) in a
    parameter tree: the interleaved copies a table state may cost."""
    found = set()

    def walk(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == "lattice_values":
                    found.add(v.data_ptr())
                else:
                    walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)

    walk(params)
    return len(found)


def probe_sampler_cases(device, cfg) -> dict:
    """Kernel C's inputs on the paths that launch it, as wrapper arguments:
    the exact frame's centre chunk (R = CHUNK, no jitter) on the full and
    the shell grid ("full", "shell"); the flagship step's batch (nr_rays
    rays through random pixels of the view, jittered starts) on the shell
    grid ("step_jitter"); the NeRF step's batch on a shell of its 64^3 grid
    ("nerf64")."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
    from permuto_sdf_tpu_torch.train import train_nerf as tn

    P = 512
    o, dr, te, tx = centre_chunk_rays(device)
    shell = shell_grid(cfg.grid, device).occupancy
    exact = (cfg.min_dist_between_samples, cfg.max_nr_samples_per_ray, P)
    cases = {"full": (cfg.grid, og.make_occupancy_grid(cfg.grid, device=device).occupancy,
                      o, dr, te, tx) + exact,
             "shell": (cfg.grid, shell, o, dr, te, tx) + exact}
    K, tf = camera()
    fo, fd = rays_from_frame(K, tf, WIDTH, HEIGHT, device=device)
    gen = torch.Generator().manual_seed(SEED + 11)
    ncfg = tn.NerfTrainConfig()
    for label, run_cfg, occ in (("step_jitter", cfg, shell),
                                ("nerf64", ncfg, shell_grid(ncfg.grid, device).occupancy)):
        pick = torch.randperm(fo.shape[0], generator=gen)[:run_cfg.nr_rays].to(device)
        ro, rd = fo[pick].contiguous(), fd[pick].contiguous()
        _, rte, _, rtx, _ = Sphere().ray_intersection(ro, rd)
        start = torch.rand((run_cfg.nr_rays, 1), generator=gen).to(device)
        cases[label] = (run_cfg.grid, occ, ro, rd, rte, rtx, run_cfg.min_dist_between_samples,
                        run_cfg.max_nr_samples_per_ray, P, start)
    return cases


def probe_sampler_work(cargs, mask):
    """(bytes, operations) of kernel C on ``cargs`` with the plain version's
    ``mask``: the rays (and starts) read once, each distinct voxel the probes
    touch read once, z, dt, mask and ray_fixed_dt written once."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    gcfg, _, o, dr, te, tx, _, S, P = cargs[:9]
    R = o.shape[0]
    frac = (torch.arange(P, device=o.device, dtype=torch.float32) + 0.5) / P
    ts = te.reshape(-1, 1) + frac[None, :] * (tx - te).reshape(-1, 1)
    lin, _ = og.point_to_lin_idx(gcfg, (o[:, None, :] + ts[..., None] * dr[:, None, :]
                                        ).reshape(-1, 3))
    probed = torch.unique(lin).numel()
    nbytes = R * (8 + (len(cargs) > 9)) * 4 + probed + R * S * 9 + R * 4
    return nbytes, probe_sampler_ops(te, tx, mask, P)


def probe_sampler_ops(t_entry, t_exit, mask, P: int) -> int:
    """Float operations of kernel C's function for these rays: per probe of
    a ray that meets the bound (t_exit > t_entry; the others have nothing
    to probe) 23: probe fraction 2, t 3, point 6, three voxel indices 4
    each; per such ray 8: seg_len 2, occupied length 2, sample count 2,
    dt 2; per valid sample 11 + 3 per step of searchsorted's binary search
    over the P counts (the kernel starts from arc / seg_len and needs
    fewer): arc 2, each step's count * seg_len and compare 3, cum_before 2,
    into 3, t 4. Invalid sample slots only store zeros."""
    steps = math.ceil(math.log2(P + 1))
    hit = int((t_exit > t_entry).sum())
    return hit * (23 * P + 8) + int(mask.sum()) * (11 + 3 * steps)


# What each kernel's gated error measures (printed as ``err_kind`` beside
# ``max_err`` in the ``kernels`` line; ``max_abs_err`` there is always the
# largest absolute difference of the timed case): "abs" the largest absolute
# difference; "rel" that over the output's largest |plain value|; "rel_level"
# that per level of a [L, 2, C] table gradient, G's feature cotangent "rel";
# "rel_floor1" elementwise |diff| / max(|plain|, 1); "rel_elem" elementwise
# |diff| / |plain|; "ulp" float32 units in
# the last place.
ERR_KIND = {"A": "abs", "B": "rel", "C": "abs", "D": "abs", "F": "rel_level",
            "G": "rel_level", "D'": "rel", "I": "abs", "J0": "abs", "J1": "abs", "J2": "abs",
            "H0": "abs", "E1": "abs", "E2": "abs", "H1": "abs", "H2": "abs",
            "L": "rel_floor1", "D2": "abs", "D2'": "rel", "M1": "abs", "M2": "ulp",
            "C3": "ulp", "J3": "abs", "C2": "abs", "I2": "abs", "J3f": "abs", "J2f": "abs",
            "If": "abs", "I2f": "rel_elem"}
GATED = {}  # kernel -> (largest gated error over its checks, tolerance)


def _report(name, err, tol, ms, plain_ms, bound):
    print(f"[kernel {name}] max_err={err:.3e} tol={tol:.1e} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound[0]:.3g} ({bound[1]}; bytes side "
          f"{bound[2]:.3g} ms, operations side {bound[3]:.3g} ms)", flush=True)
    _gate(name, err, tol)


def _gate(name, err, tol):
    """Fail if a kernel's error is above its tolerance; keep its worst."""
    if not err <= tol:
        fail(f"kernel {name}: error {err:.3e} above tolerance {tol:.1e}")
    key = name.split()[0].split(":")[0]
    prev = GATED.get(key, (0.0, tol))
    GATED[key] = (max(prev[0], err), max(prev[1], tol))


def kernel_phases(device, cfg, reps=20, plain_reps=3):
    """Each kernel against its plain version on one chunk's shapes.
    Returns {kernel: dict of numbers}."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr
    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask

    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(SEED)
    L = cfg.nr_levels
    S_fg = cfg.max_nr_samples_per_ray + 2 * cfg.nr_samples_imp_sampling
    R = CHUNK
    results = {}

    def rand_points(n, d):
        return torch.from_numpy(rng.uniform(-0.45, 0.45, (n, d)).astype(np.float32)).to(device)

    # --- A: encode forward (SDF/RGB d=3 full, proxy K=12, background d=4 on
    # uniformly random points; the SDF's d=3 full on the centre chunk's
    # samples in ray order)
    errs, timing, b_cases = [], None, []
    for label, d, n, K, scaling in (
            ("d3_full", 3, R * S_fg, L, 1e-3),
            ("d3_K12", 3, R * cfg.max_nr_samples_per_ray, cfg.imp_sampling_max_levels, 1e-3),
            ("d4_bg", 4, R * cfg.nr_samples_bg, L, 1.0),
            ("d3_rays", 3, R * S_fg, L, 1e-3)):
        spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=cfg.capacity, nr_levels=L,
                                      concat_points_scaling=scaling)
        prm = pe.init_encoding_params(gen, spec, device)
        pts = ray_ordered_points(device, S_fg) if label == "d3_rays" else rand_points(n, d)
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
        _report(f"A:{label} N={pts.shape[0]} K={K}", err, TOL_A, ms, pms, b)
        if label == "d3_full":
            dms = device_ms(lambda: pe.encode_fwd_cuda(*args), "A", device)
            timing = (ms, pms, b)
            # the port's interleaved [L, C, 2] copy A, B and G read, once per
            # table state: the cache is emptied before each call, so each
            # call copies
            tbl = prm["lattice_values"]

            def fresh_copy():
                pe._INTERLEAVED.clear()
                return pe.interleaved_table(tbl)

            copy_ms = time_ms(fresh_copy, reps, device)
            cb = bound_ms(2 * tbl.numel() * 4, 0)
            results["interleave_copy"] = dict(ms=copy_ms, bound_ms=cb[0],
                                              mib=tbl.numel() * 4 / 2 ** 20)
            print(f"[interleave copy] one table [{L}, 2, {cfg.capacity}] -> [L, C, 2] "
                  f"({tbl.numel() * 4 / 2 ** 20:.0f} MiB): {copy_ms:.4f} ms (bound "
                  f"{cb[0]:.3g}, bytes)", flush=True)
        if label in ("d3_full", "d3_rays"):
            b_cases.append((label, args, uniq))
    results["A"] = dict(max_abs_err=max(errs), ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1], device_ms=dms)

    # --- B: point gradient of the SDF encoding (d=3, full width) on the
    # random and the ray-ordered points
    errs, timing = [], None
    for label, args, uniq in b_cases:
        pts = args[0]
        g = torch.from_numpy(rng.normal(size=(pts.shape[0], 2 * L + 3)).astype(np.float32)).to(device)
        got = pe.encode_point_grad_cuda(*args, g)
        want = pe.encode_point_grad_plain(*args, g)
        err = ((got - want).abs().max() / want.abs().max()).item()
        ms = time_ms(lambda: pe.encode_point_grad_cuda(*args, g), reps, device)
        pms = time_ms(lambda: pe.encode_point_grad_plain(*args, g), plain_reps, device)
        nbytes = pts.numel() * 4 + g.numel() * 4 + uniq * 2 * 4 + got.numel() * 4
        b = bound_ms(nbytes, OPS_PER_POINT_LEVEL_B * pts.shape[0] * L)
        _report(f"B:{label} N={pts.shape[0]} (relative)", err, TOL_B, ms, pms, b)
        errs.append((got - want).abs().max().item())
        if label == "d3_full":
            dms = device_ms(lambda: pe.encode_point_grad_cuda(*args, g), "B", device)
            timing = (ms, pms, b)
    results["B"] = dict(max_abs_err=max(errs), ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1], device_ms=dms)

    # --- C: probe sampler on the inputs of the paths that launch it
    errs, timing = [], None
    for label, cargs in probe_sampler_cases(device, cfg).items():
        got = og.probe_sampler_cuda(*cargs)
        want = og.probe_sampler_plain(*cargs)
        if not torch.equal(got[2], want[2]):
            fail(f"kernel C:{label}: sample masks differ in "
                 f"{(got[2] != want[2]).sum().item()} slots")
        err = max((got[i] - want[i]).abs().max().item() for i in (0, 1, 3))
        errs.append(err)
        ms = time_ms(lambda: og.probe_sampler_cuda(*cargs), reps, device)
        pms = time_ms(lambda: og.probe_sampler_plain(*cargs), plain_reps, device)
        b = bound_ms(*probe_sampler_work(cargs, want[2]))
        _report(f"C:{label} R={cargs[2].shape[0]} V={cargs[0].nr_voxels_per_dim} "
                f"valid={int(want[2].sum())}", err, TOL_C, ms, pms, b)
        if label == "full":
            dms = device_ms(lambda: og.probe_sampler_cuda(*cargs), "C", device)
            timing = (ms, pms, b)
    results["C"] = dict(max_abs_err=max(errs), ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1], device_ms=dms)

    # --- D: NeuS mode (fg, S=96) and NeRF mode (bg, S=32)
    o, dr, _, _ = centre_chunk_rays(device)
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
            dms = device_ms(run_k, "D", device)
            timing = (ms, pms, b)
    results["D"] = dict(max_abs_err=max(errs), ms=timing[0], plain_ms=timing[1],
                        bound_ms=timing[2][0], bound_by=timing[2][1], device_ms=dms)
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


def _fg_case(name, label, base, g, u, levels, uniq, reps, plain_reps, device,
             with_device_ms=True):
    """Kernel F or G on one point set against its plain version: the table
    gradient per level within TOL_F / TOL_G of the level's largest |value|
    (G's feature cotangent relative to its largest |value|), the levels
    outside ``levels`` exactly zero; CUDA-event ms, device ms, the bound
    (bytes: the points, the cotangents, G's distinct table slots and the
    dense [L, 2, C] output; operations: OPS_PER_POINT_LEVEL_F / _G per
    point and level, halved with parity as the lever phase counts them)."""
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

    pts = base[0]
    n, d = pts.shape
    L = base[6]
    phase, period = levels
    if name == "F":
        def run():
            return pe.encode_table_grad_cuda(*base, g, levels)

        def plain():
            return pe.encode_table_grad_plain(*base, g, levels)
    else:
        def run():
            return pe.encode_double_backward_cuda(*base, 1e-3 if d == 3 else 1.0, True, g, u,
                                                  levels)

        def plain():
            return pe.encode_double_backward_plain(*base, 1e-3 if d == 3 else 1.0, True, g, u,
                                                   levels)
    got, want = run(), plain()
    tk, tp = (got, want) if name == "F" else (got[0], want[0])
    frozen = [lv for lv in range(tk.shape[0]) if lv >= L or (period > 1 and lv % period != phase)]
    if frozen and (tk[frozen].abs().max().item() != 0.0 or tp[frozen].abs().max().item() != 0.0):
        fail(f"kernel {name} levels {levels}: a level without gradient is not zero")
    err = _level_err(tk, tp)
    abs_err = (tk - tp).abs().max().item()
    if name == "G":
        err = max(err, ((got[1] - want[1]).abs().max() / want[1].abs().max()).item())
        abs_err = max(abs_err, (got[1] - want[1]).abs().max().item())
    ms = time_ms(run, reps, device)
    pms = time_ms(plain, plain_reps, device)
    share = 2 if period > 1 else 1
    if name == "F":
        nbytes = pts.numel() * 4 + n * 2 * L * 4 + tk.numel() * 4
        b = bound_ms(nbytes, OPS_PER_POINT_LEVEL_F * n * L // share)
    else:
        nbytes = (pts.numel() + u.numel() + 2 * g.numel()) * 4 + uniq * 2 * 4 + tk.numel() * 4
        b = bound_ms(nbytes, OPS_PER_POINT_LEVEL_G * n * L // share)
    dms = device_ms(run, name, device, reps=max(reps // 2, 1)) if with_device_ms else None
    _report(f"{name}:{label} N={n} d={d} K={L} levels={levels} (per level / relative; device "
            f"ms {'not measured' if dms is None else f'{dms:.4f}'})", err, TOL_F if name == "F"
            else TOL_G, ms, pms, b)
    return dict(max_abs_err=abs_err, max_err=err, ms=ms, plain_ms=pms, bound_ms=b[0],
                bound_by=b[1], device_ms=dms, n=n)


def train_kernel_phases(device, cfg, reps=20, plain_reps=3):
    """Kernels F, G, D' and I against their plain versions at the shapes of
    the flagship training step. Returns {kernel: dict of numbers}."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

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

    # --- F and G on the three point sets (FG_SETS) at the step's fg (d = 3,
    # the SDF encoding) and background (d = 4) sample counts, every level
    # and alternating levels (phase 1 of period 2)
    fg = {}
    for d, n, per_ray, scaling in ((3, M, S_fg, 1e-3),
                                   (4, R * cfg.nr_samples_bg, cfg.nr_samples_bg, 1.0)):
        prm, scales, E = encoding(d, scaling)
        window = torch.ones(L, device=device)
        g = tensor(rng.normal(size=(n, 2 * L + d)))
        u = tensor(rng.normal(size=(n, d)))
        for set_name, pts in fg_point_sets(device, n, d, per_ray, SEED + 7).items():
            base = (pts, prm["lattice_values"], prm["shift_per_level"], scales, window, E, L)
            uniq = torch.unique(pe.flat_slot_ids(pts, prm["lattice_values"],
                                                 prm["shift_per_level"], scales, E, L)).numel()
            for levels in ((0, 1), (1, 2)):
                label = f"d{d}_{set_name}" + ("_parity" if levels[1] > 1 else "")
                for name in ("F", "G"):
                    row = label == "d3_random"
                    fg.setdefault(name, {})[label] = _fg_case(
                        name, label, base, g, u, levels, uniq,
                        reps if row else max(reps // 2, 1), plain_reps if row else 1, device)
    for name in ("F", "G"):
        r = fg[name]["d3_random"]  # the row: the step's fg count on random points
        results[name] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                             bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                             device_ms=r["device_ms"])
    results["fg_sets"] = fg

    # --- F and G at the step's other encodes' counts (random points)
    prm, scales, E = encoding(3, 1e-3)
    for name, label, n in (("F", "sphere_init", cfg.sphere_init_points),
                           ("F", "offsurface", 1024),
                           ("G", "curvature", min(cfg.curvature_sample_budget, M)),
                           ("G", "sphere_init", cfg.sphere_init_points)):
        pts = tensor(rng.uniform(-0.45, 0.45, (n, 3)))
        base = (pts, prm["lattice_values"], prm["shift_per_level"], scales,
                torch.ones(L, device=device), E, L)
        g = tensor(rng.normal(size=(n, 2 * L + 3)))
        u = tensor(rng.normal(size=(n, 3)))
        uniq = torch.unique(pe.flat_slot_ids(pts, prm["lattice_values"], prm["shift_per_level"],
                                             scales, E, L)).numel()
        _fg_case(name, label, base, g, u, (0, 1), uniq, reps, plain_reps, device,
                 with_device_ms=False)

    # --- D': the backward of kernel D
    results["D'"] = weights_bwd_phase(device, cfg, reps, plain_reps)

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
    dms = device_ms(run_k, "I", device, per_launch=True, launches=2)
    results["I"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                        device_ms=dms)

    # --- If: the refresh in one launch, random weights at a c2f-active iteration
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    params = tps.init_params(SEED, cfg, device=device)
    params["sdf"]["encoding"]["lattice_values"].mul_(1e3)  # a trained table's magnitude
    results["If"] = refresh_case(device, cfg, params["sdf"], IF_C2F_ITER, "random_c2f", reps,
                                 plain_reps)
    return results


def _random_grid(gcfg, device, seed):
    """A grid of random values and flags: a refresh's writes to voxels no
    probe visits would show."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    gen = torch.Generator().manual_seed(seed)
    return og.OccupancyGridState(
        values=torch.randn(gcfg.nr_voxels, generator=gen).to(device),
        occupancy=(torch.rand(gcfg.nr_voxels, generator=gen) < 0.5).to(device))


def _refresh_compare(label, gcfg, got, want, base, lin, inv_s, thresh):
    """A refreshed grid against another (kernel If or I2f against its plain
    version, or the card against the CPU), both from ``base``: the probed
    voxels' values and flags (a flag may differ only where the threshold
    lies between the two values' densities, on at most max(FUSED_MAX_ROWS,
    FUSED_SHARE of the probes) voxels), every other voxel unchanged. The
    density of a value is the logistic density at ``inv_s`` of an SDF (If),
    or the value itself for ``inv_s`` None (I2f, whose summary also gives
    the largest relative gap and the voxels filled and emptied) -> (the
    largest value gap, summary)."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    probed = torch.zeros(gcfg.nr_voxels, dtype=torch.bool, device=base.values.device)
    probed[lin.long().to(probed.device)] = True
    for name, g in (("the kernel", got), ("the plain version", want)):
        if not (torch.equal(g.values[~probed], base.values[~probed])
                and torch.equal(g.occupancy[~probed], base.occupancy[~probed])):
            fail(f"{label}: {name} changed a voxel no probe visits")
    vk, vp = got.values[probed], want.values[probed]
    if not (torch.isfinite(vk).all() and torch.isfinite(vp).all()):
        fail(f"{label}: non-finite values")
    if inv_s is None:
        dk, dp = vk, vp
    else:
        x = lambda v: torch.clamp(v.abs() - gcfg.half_diagonal, 0.0, 1e10)  # noqa: E731
        dk = og._logistic_density(x(vk), torch.tensor(inv_s))
        dp = og._logistic_density(x(vp), torch.tensor(inv_s))
    differ = got.occupancy[probed] != want.occupancy[probed]
    between = (torch.minimum(dk, dp) <= thresh) & (thresh <= torch.maximum(dk, dp))
    n = int(probed.sum())
    summary = {"probes": n, "flags_differ": int(differ.sum()),
               "flags_differ_outside_the_tie": int((differ & ~between).sum()),
               "occupied": int(want.occupancy[probed].sum()),
               "max_value_gap": (vk - vp).abs().max().item()}
    if inv_s is None:
        was = base.occupancy[probed]
        summary.update(max_rel_gap=((vk - vp).abs() / vp.abs().clamp_min(1e-30)).max().item(),
                       filled=int((want.occupancy[probed] & ~was).sum()),
                       emptied=int((~want.occupancy[probed] & was).sum()))
    limit = max(FUSED_MAX_ROWS, FUSED_SHARE * n)
    if summary["flags_differ_outside_the_tie"] or summary["flags_differ"] > limit:
        fail(f"{label}: {summary} (flags may differ only at the threshold, on at most "
             f"{limit:g} voxels)")
    return summary["max_value_gap"], summary


def _table_sectors(enc, spec, centers, K) -> int:
    """The distinct 32-byte sectors of the interleaved table that the
    points' K coarsest levels gather (4 slots of 8 bytes a sector)."""
    import torch

    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

    scales, E, _ = pe.encoding_constants(spec, None, centers.device)
    sectors = [torch.zeros((0,), dtype=torch.int64, device=centers.device)]
    for part in centers.split(32768):
        ids = pe.flat_slot_ids(part, enc["lattice_values"], enc["shift_per_level"], scales, E, K)
        sectors.append((ids // 4).unique())
    return int(torch.cat(sectors).unique().numel())


def refresh_bound(params_sdf, sdf_cfg, K, lin, centers):
    """The least time of kernel If over this refresh's work: the bytes of
    the jitter, the distinct 32-byte table sectors the probes' K levels
    gather, the staged weights and the 32-byte sectors of the scattered
    value and flag stores; the operations of the evaluations (K levels of
    lattice math, the MLP and its GELUs) and of the probes' ids, centers and
    densities -> (bound_ms(...), work)."""
    table_sectors = _table_sectors(params_sdf["encoding"], sdf_cfg.encoding, centers, K)
    lin = lin.long()
    store_sectors = int((lin // 8).unique().numel() + (lin // 32).unique().numel())
    n, n_in = int(lin.numel()), 2 * K + 3
    mlp_ops = 2 * (n_in * 32 + 2 * 32 * 32 + 32) + 3 * 32 * OPS_PER_GELU
    per_probe = K * OPS_PER_POINT_LEVEL_A + mlp_ops + OPS_PER_PROBE_I
    nbytes = (12 * n + 32 * table_sectors + 4 * (n_in * 32 + 2 * 32 * 32 + 4 * 32 + 1)
              + 32 * store_sectors)
    work = {"probes": n, "table_sectors": table_sectors, "store_sectors": store_sectors,
            "ops_per_probe": per_probe}
    return bound_ms(nbytes, n * per_probe), work


def refresh_case(device, cfg, params_sdf, it, label, reps=20, plain_reps=3):
    """Kernel If at the flagship refresh (grid_nr_random_samples probes of
    the grid, the SDF on grid_update_max_levels levels at iteration ``it``)
    against its plain version on the card, from a random grid, then timed
    beside the plain version and the unfused refresh it replaced (entry 1,
    ``sdf_apply``'s kernel A and matmuls, entry 2: CUDA-event ms, device
    busy ms and launches a call). Returns the kernel row's numbers."""
    import torch

    from permuto_sdf_tpu_torch.models.fields import SDFEval
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    gcfg, n, K = cfg.grid, cfg.grid_nr_random_samples, cfg.grid_update_max_levels
    upd = 2501  # an update index past the first 64 (the ids wrap the grid)
    jitter = (torch.rand((n, 3), generator=torch.Generator().manual_seed(SEED + 3)) - 0.5).to(
        device)
    args = (SDFEval(cfg.sdf_model, K), (params_sdf, it), n, upd, jitter, INV_S_TRAINED,
            cfg.grid_occupancy_thresh)
    base = _random_grid(gcfg, device, SEED + 4)
    grids = [og.OccupancyGridState(values=base.values.clone(), occupancy=base.occupancy.clone())
             for _ in range(3)]
    og.grid_refresh_cuda(gcfg, grids[0], *args)
    og.grid_refresh_plain(gcfg, grids[1], *args)
    centers, lin = og.grid_points_plain(gcfg, n, upd, jitter, device)
    err, summary = _refresh_compare(f"kernel If ({label})", gcfg, grids[0], grids[1], base, lin,
                                    INV_S_TRAINED, cfg.grid_occupancy_thresh)

    def run_k():
        og.grid_refresh_cuda(gcfg, grids[0], *args)

    def unfused():
        og._refresh_through(og.grid_points_cuda, og.grid_update_cuda, gcfg, grids[2], *args)

    ms = time_ms(run_k, reps, device)
    pms = time_ms(lambda: og.grid_refresh_plain(gcfg, grids[1], *args), plain_reps, device)
    b, work = refresh_bound(params_sdf, cfg.sdf_model, K, lin, centers)
    _report(f"If:{label} n={n} grid={gcfg.nr_voxels_per_dim}^3 K={K} of {cfg.nr_levels} "
            f"it={it} (flags {summary}; library ms: none)", err, TOL_IF, ms, pms, b)
    dms = device_ms(run_k, "If", device, per_launch=True)
    ums = time_ms(unfused, reps, device)
    ubusy, ulaunches = device_ms_all(unfused, device)
    print(f"[kernel If:{label}] device ms a launch {dms}; the unfused refresh it replaced: "
          f"ms={ums:.4f}, device busy ms {ubusy}, {ulaunches} device launches a call",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                device_ms=dms, library_ms=None, unfused_ms=ums, unfused_device_busy_ms=ubusy,
                unfused_device_launches=ulaunches, work=work, compare=summary)


def refresh_cross_check(device, cfg, params):
    """One flagship ``occupancy_update`` on the card against the same call
    on the CPU, with the same parameters and jitter, from the same random
    grid: the card's call launches If once and neither entry of I; the
    grids agree as ``_refresh_compare`` says, within TOL_IF."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    n = cfg.grid_nr_random_samples
    jitter = torch.rand((n, 3), generator=torch.Generator().manual_seed(SEED + 13)) - 0.5
    it = ITER + 5 * cfg.grid_update_every + 3
    base = _random_grid(cfg.grid, torch.device("cpu"), SEED + 14)
    card = og.OccupancyGridState(values=base.values.to(device), occupancy=base.occupancy.to(device))
    cpu = og.OccupancyGridState(values=base.values.clone(), occupancy=base.occupancy.clone())
    cpu_params = _tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                           params)
    before = (og.grid_refresh_cuda.launches, og.grid_points_cuda.launches,
              og.grid_update_cuda.launches)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tps.occupancy_update(params, card, jitter, it, INV_S_TRAINED, cfg)
    torch.cuda.synchronize(device)
    card_ms = (time.perf_counter() - t0) * 1e3
    after = (og.grid_refresh_cuda.launches, og.grid_points_cuda.launches,
             og.grid_update_cuda.launches)
    if after != (before[0] + 1, before[1], before[2]):
        fail(f"refresh card vs CPU: launches If, I entry 1, I entry 2 {before} -> {after}, "
             f"expected one of If alone")
    t0 = time.perf_counter()
    tps.occupancy_update(cpu_params, cpu, jitter, it, INV_S_TRAINED, cfg)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    _, lin = og.grid_points_plain(cfg.grid, n, it // cfg.grid_update_every)
    got = og.OccupancyGridState(values=card.values.cpu(), occupancy=card.occupancy.cpu())
    err, summary = _refresh_compare("refresh card vs CPU", cfg.grid, got, cpu, base, lin,
                                    INV_S_TRAINED, cfg.grid_occupancy_thresh)
    if not err <= TOL_IF:
        fail(f"refresh card vs CPU: values {err:.3e} apart, above {TOL_IF:.1e}")
    out = {"max_value_gap": err, "tol": TOL_IF, "card_ms": card_ms, "cpu_ms": cpu_ms, **summary}
    print(f"[refresh card vs CPU] occupancy_update at iteration {it}: {out}", flush=True)
    return out


def density_refresh_bound(params_model, fcfg, lin, centers):
    """The least time of kernel I2f over this refresh's work: the bytes of
    the jitter, the distinct 32-byte table sectors of all L levels that the
    probes gather, the weights, the 32-byte sectors of the old values'
    reads and of the scattered value and flag stores; the operations at
    their type's peak: the three 64-wide layers' products on the tensor
    cores (three TF32 products for each float32 one, the 3xTF32 split) over
    TF32_FLOPS, and over F32_FLOPS the rest (L levels of lattice math,
    column 0 of the last layer, the GELUs, the softplus, the probes' ids,
    centers and updates); the two kinds run on separate units, so the
    operations side is the larger of their times -> ((least ms, which side
    bounds it, ms of the bytes side, ms of the operations side), work)."""
    L, H = fcfg.nr_levels, 64
    table_sectors = _table_sectors(params_model["encoding"], fcfg.encoding, centers, L)
    lin = lin.long()
    value_sectors = int((lin // 8).unique().numel())
    flag_sectors = int((lin // 32).unique().numel())
    n, n_in = int(lin.numel()), 2 * L + 3
    layer_ops = 2 * (n_in * H + 2 * H * H)  # float32 products of the three 64-wide layers
    simt_ops = (L * OPS_PER_POINT_LEVEL_A + 2 * H + 3 * H * OPS_PER_GELU + OPS_PER_SOFTPLUS
                + OPS_PER_PROBE_I + OPS_PER_PROBE_I2)
    nbytes = (12 * n + 32 * table_sectors + 4 * (n_in * H + 2 * H * H + 4 * H + 1)
              + 32 * (2 * value_sectors + flag_sectors))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n * 3 * layer_ops / TF32_FLOPS, n * simt_ops / F32_FLOPS) * 1e3
    work = {"probes": n, "table_sectors": table_sectors, "value_sectors": value_sectors,
            "flag_sectors": flag_sectors, "tensor_core_ops_per_probe": 3 * layer_ops,
            "simt_ops_per_probe": simt_ops,
            # every operation at the float32 rate, as a SIMT evaluation would do them
            "ops_side_at_f32_ms": n * (layer_ops + simt_ops) / F32_FLOPS * 1e3}
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_bytes,
            t_ops), work


def refresh_density_params(params_model):
    """A copy of a NerfHash model's parameters for the refresh cases: the
    table scaled by I2F_TABLE_SCALE (a trained table's magnitude) and the
    density's bias b3[0] moved by I2F_BIAS_SHIFT, so that the densities of
    a refresh straddle the threshold and voxels both fill and empty."""
    p = _tree_map(_clone, params_model)
    p["encoding"]["lattice_values"].mul_(I2F_TABLE_SCALE)
    p["mlp_feat_and_density"][-1]["b"][0] += I2F_BIAS_SHIFT
    return p


def density_refresh_case(device, ncfg, params_model, it, label, reps=20, plain_reps=3):
    """Kernel I2f at NeRF's refresh (grid_nr_random_samples probes of the
    grid, the density on all levels at iteration ``it``) against its plain
    version on the card, from a random grid, then timed beside the plain
    version and the unfused refresh it replaced (entry 1, ``nerf_hash_density``'s
    kernel A and matmuls, I2: CUDA-event ms, device busy ms and launches a
    call). Returns the kernel row's numbers."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    gcfg, n, thresh = ncfg.grid, ncfg.grid_nr_random_samples, ncfg.grid_occupancy_thresh
    fcfg = ncfg.fg_model
    upd = it // ncfg.grid_update_every
    jitter = (torch.rand((n, 3), generator=torch.Generator().manual_seed(SEED + 5)) - 0.5).to(
        device)
    args = (fcfg, params_model, it, n, upd, jitter, ncfg.grid_decay, thresh)
    gen = torch.Generator().manual_seed(SEED + 6)
    base = og.OccupancyGridState(
        values=(torch.rand(gcfg.nr_voxels, generator=gen) * 4 * thresh).to(device),
        occupancy=(torch.rand(gcfg.nr_voxels, generator=gen) < 0.5).to(device))
    grids = [og.OccupancyGridState(values=base.values.clone(), occupancy=base.occupancy.clone())
             for _ in range(3)]
    launches = og.density_refresh_cuda.launches
    og.density_refresh_cuda(gcfg, grids[0], *args)
    if og.density_refresh_cuda.launches != launches + 1:
        fail("kernel I2f: not one launch a call")
    og.density_refresh_plain(gcfg, grids[1], *args)
    centers, lin = og.grid_points_plain(gcfg, n, upd, jitter, device)
    _, summary = _refresh_compare(f"kernel I2f ({label})", gcfg, grids[0], grids[1], base, lin,
                                  None, thresh)
    rel = summary["max_rel_gap"]
    if not (summary["filled"] and summary["emptied"]):
        fail(f"kernel I2f ({label}): no voxel filled or none emptied ({summary})")

    def run_k():
        og.density_refresh_cuda(gcfg, grids[0], *args)

    def unfused():
        og._density_refresh_through(og.grid_points_cuda, og.density_update_cuda, gcfg, grids[2],
                                    *args)

    ms = time_ms(run_k, reps, device)
    pms = time_ms(lambda: og.density_refresh_plain(gcfg, grids[1], *args), plain_reps, device)
    b, work = density_refresh_bound(params_model, fcfg, lin, centers)
    _report(f"I2f:{label} n={n} grid={gcfg.nr_voxels_per_dim}^3 L={fcfg.nr_levels} it={it} "
            f"(flags {summary}; library ms: none)", rel, TOL_I2F, ms, pms, b)
    dms = device_ms(run_k, "I2f", device, per_launch=True)
    ums = time_ms(unfused, reps, device)
    ubusy, ulaunches = device_ms_all(unfused, device)
    print(f"[kernel I2f:{label}] device ms a launch {dms}; the unfused refresh it replaced: "
          f"ms={ums:.4f}, device busy ms {ubusy}, {ulaunches} device launches a call",
          flush=True)
    return dict(max_abs_err=summary["max_value_gap"], max_rel_err=rel, ms=ms, plain_ms=pms,
                bound_ms=b[0], bound_by=b[1], device_ms=dms, library_ms=None, unfused_ms=ums,
                unfused_device_busy_ms=ubusy, unfused_device_launches=ulaunches, work=work,
                compare=summary)


def density_refresh_cross_check(device, ncfg, params):
    """One NeRF ``occupancy_update`` on the card against the same call on
    the CPU, with the same parameters and jitter, from the same random
    grid: the card's call launches I2f once and neither entry 1, A nor I2;
    the grids agree as ``_refresh_compare`` says, within TOL_I2F."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.train import train_nerf as tn

    n, thresh = ncfg.grid_nr_random_samples, ncfg.grid_occupancy_thresh
    jitter = torch.rand((n, 3), generator=torch.Generator().manual_seed(SEED + 15)) - 0.5
    it = 5 * ncfg.grid_update_every
    gen = torch.Generator().manual_seed(SEED + 16)
    base = og.OccupancyGridState(
        values=torch.rand(ncfg.grid.nr_voxels, generator=gen) * 4 * thresh,
        occupancy=torch.rand(ncfg.grid.nr_voxels, generator=gen) < 0.5)
    card = og.OccupancyGridState(values=base.values.to(device), occupancy=base.occupancy.to(device))
    cpu = og.OccupancyGridState(values=base.values.clone(), occupancy=base.occupancy.clone())
    cpu_params = _tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                           params)
    def counted():
        return (og.density_refresh_cuda.launches, og.grid_points_cuda.launches,
                pe.encode_fwd_cuda.launches, og.density_update_cuda.launches)

    before = counted()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tn.occupancy_update(params, card, jitter, it, ncfg)
    torch.cuda.synchronize(device)
    card_ms = (time.perf_counter() - t0) * 1e3
    after = counted()
    if after != (before[0] + 1,) + before[1:]:
        fail(f"nerf refresh card vs CPU: launches I2f, I entry 1, A, I2 {before} -> {after}, "
             f"expected one of I2f alone")
    t0 = time.perf_counter()
    tn.occupancy_update(cpu_params, cpu, jitter, it, ncfg)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    _, lin = og.grid_points_plain(ncfg.grid, n, it // ncfg.grid_update_every)
    got = og.OccupancyGridState(values=card.values.cpu(), occupancy=card.occupancy.cpu())
    _, summary = _refresh_compare("nerf refresh card vs CPU", ncfg.grid, got, cpu, base, lin,
                                  None, thresh)
    if not summary["max_rel_gap"] <= TOL_I2F:
        fail(f"nerf refresh card vs CPU: values {summary['max_rel_gap']:.3e} apart (relative), "
             f"above {TOL_I2F:.1e}")
    out = {"tol": TOL_I2F, "card_ms": card_ms, "cpu_ms": cpu_ms, **summary}
    print(f"[nerf refresh card vs CPU] occupancy_update at iteration {it}: {out}", flush=True)
    return out


def counters():
    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import ray_sampler as rs
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

    return {"A": (pe.encode_fwd_cuda,), "B": (pe.encode_point_grad_cuda,),
            "C": (og.probe_sampler_cuda,), "D": (vr.render_weights_cuda,),
            "F": (pe.encode_table_grad_cuda,), "G": (pe.encode_double_backward_cuda,),
            "D'": (vr.render_weights_bwd_cuda,),
            "I": (og.grid_points_cuda, og.grid_update_cuda),
            "J0": (og.chebyshev_field_cuda,), "J1": (st.jump_prepass_cuda,),
            "J2": (st.trace_step_cuda,), "H0": (compaction.nonzero_static_cuda,),
            "E1": (isp.importance_round_cuda,), "E2": (isp.merge_samples_cuda,),
            "H1": (compaction.take_rows_cuda,), "H2": (compaction.scatter_rows_cuda,),
            "L": (vr.train_lod_select_cuda,), "D2": (vr.neus_render_mixed_cuda,),
            "D2'": (vr.neus_render_mixed_bwd_cuda,), "M1": (mc.mt_count_cuda,),
            "M2": (mc.mt_emit_cuda,), "C3": (og.first_occupied_cuda,),
            "J3": (st.trace_step_pos_cuda,),
            "C2": (rs.samples_fg_sphere_cuda,),
            "I2": (og.density_update_cuda,), "J3f": (st.trace_loop_pos_cuda,),
            "J2f": (st.trace_round_cuda,), "If": (og.grid_refresh_cuda,),
            "I2f": (og.density_refresh_cuda,)}


RENDER_KERNELS = ("A", "B", "C", "D", "E1", "E2")
TRAIN_KERNELS = ("A", "B", "C", "D", "E1", "E2", "F", "G", "D'", "If")
SPHERE_KERNELS = ("J0", "J1", "J2f", "H0", "A", "B")


def reset_counts():
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

    for fns in counters().values():
        for fn in fns:
            fn.launches = 0
    pe.interleaved_table.copies = 0


def read_counts():
    """Launches per kernel, and under "copies" the interleaved [L, C, 2]
    table copies that A, B and G read (at most one per table state)."""
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

    counts = {k: sum(fn.launches for fn in fns) for k, fns in counters().items()}
    counts["copies"] = pe.interleaved_table.copies
    return counts


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
                  "D'": "render_weights_bwd_kernel",
                  "I": ("grid_points_kernel", "grid_update_kernel"), "If": "grid_refresh_kernel",
                  "J0": "chebyshev_pass_kernel",
                  "J1": ("jump_prepass_kernel", "jump_prepass_list_kernel"),
                  "J2": "trace_step_kernel", "H0": "compact_",
                  "E1": "importance_round_kernel", "E2": "merge_samples_kernel",
                  "H1": "take_rows_kernel", "H2": "scatter_rows_kernel",
                  "L": "train_lod_select_kernel", "D2": "render_mixed_kernel",
                  "D2'": "render_mixed_bwd_kernel", "M1": "mt_count_kernel",
                  "M2": "mt_emit_kernel", "C3": "first_occupied_kernel",
                  "J3": "trace_step_pos_kernel",
                  "C2": "samples_fg_kernel",
                  "I2": "density_update_kernel", "J3f": "trace_loop_pos_kernel",
                  "J2f": "trace_round_kernel", "I2f": "density_refresh_kernel"}


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
    """Device time and launches by kernel name, the share of the port's
    kernels and the device's busy share of the profiled wall time; prints a
    ``profile`` JSON line."""
    # kernel records only (device_type CUDA): operator records carry the
    # device time of the kernels they launched as well
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and _dev_us(e) > 0]
    total_ms = sum(_dev_us(e) for e in events) / 1e3
    if total_ms <= 0:
        print(json.dumps({"profile": "not measured: the profiler recorded no device time"}))
        return None
    events.sort(key=_dev_us, reverse=True)
    mine = {k: _kernel_events(prof, k) for k in KERNEL_SYMBOLS}
    by_kernel = {k: sum(_dev_us(e) for e in ev) / 1e3 for k, ev in mine.items()}
    launches = {k: sum(e.count for e in ev) for k, ev in mine.items()}
    summary = {
        f"{what}_wall_ms_profiled": wall_ms,
        "device_busy_ms": total_ms,
        "device_idle_share": max(0.0, 1.0 - total_ms / wall_ms),
        "kernels_ms": by_kernel,
        "kernels_launches": launches,
        "kernels_us_per_launch": {k: by_kernel[k] / n * 1e3 for k, n in launches.items() if n},
        "kernels_share_of_device": sum(by_kernel.values()) / total_ms,
        "top": [{"name": e.key[:80], "device_ms": _dev_us(e) / 1e3, "count": e.count}
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
    times, nr_samples, iters = [], [], []

    def on_step(it, loss, aux, params, grid):
        torch.cuda.synchronize(device)
        times.append(time.perf_counter())
        iters.append(it)
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
    # every grid refresh is one launch of If, and neither entry of I
    refreshes = sum(1 for it in iters if it % cfg.grid_update_every == 0)
    if counts["If"] != refreshes or counts["I"] != 0:
        fail(f"train: {refreshes} grid refreshes launched If {counts['If']} and I "
             f"{counts['I']} times, expected {refreshes} and 0")
    # the importance stage of the reference profile: E1, then E2 in form c
    if not counts["E1"] == counts["E2"] == len(times) - 1:
        fail(f"train: E1/E2 launches {counts['E1']}/{counts['E2']} in {len(times) - 1} steps, "
             f"expected one each a step")
    _check_copies("train", counts, params, len(times) - 1)
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
        "grid_refreshes": refreshes,
        "interleave_copies_per_step": counts["copies"] / TRAIN_STEPS,
        "sphere_init_losses": losses, "final_loss": hist[-1][1],
        "occupied_share": float(grid.occupancy.float().mean()),
    }
    print(f"[train] {TRAIN_STEPS} steps from iteration {start + 1}: median "
          f"{med:.1f} ms/step (min {min(steps_ms):.1f}, max {max(steps_ms):.1f}), "
          f"{summary['rays_per_s_median']:.0f} rays/s, "
          f"{summary['valid_samples_per_s_median']:.0f} valid samples/s, "
          f"launches/step {summary['launches_per_step']}", flush=True)
    return params, grid, reel, counts, summary


def _check_copies(label, counts, params, steps):
    """A training window's interleaved-table copies: each step's update
    changes every table once, so at most one copy per table per step, plus
    one per table for the state the window starts from."""
    allowed = encoding_tables(params) * (steps + 1)
    if not counts["copies"] <= allowed:
        fail(f"{label}: {counts['copies']} interleaved-table copies in {steps} steps "
             f"(at most {allowed})")


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


def _cross_summary(label, ev):
    """The numbers of one card-vs-CPU evaluation (see cross_check_gate) ->
    (summary, L1 sign flips [R, 3], the flips within the tie); fails on a
    gradient on one side only or a non-finite card gradient."""
    import torch

    res_c, res_g = ev["res_cpu"], ev["res_card"]
    flips = (torch.sign(res_c) != torch.sign(res_g)) & ev["hit_cpu"]
    ties = flips & (res_c.abs() <= L1_TIE) & (res_g.abs() <= L1_TIE)
    worst, largest = {}, {}
    for name, (gc, gg) in ev["grads"].items():
        if gc is None and gg is None:
            continue
        if gc is None or gg is None:
            fail(f"{label}: {name} has a gradient on one side only")
        if not torch.isfinite(gg).all():
            fail(f"{label}: non-finite gradient of {name} on the card")
        diff = gg.cpu() - gc
        norm, scale = gc.norm().item(), gc.abs().max().item()
        worst[name] = diff.norm().item() / norm if norm > 0 else diff.norm().item()
        largest[name] = diff.abs().max().item() / scale if scale > 0 else diff.abs().max().item()
    loss_c, loss_g = ev["loss_cpu"], ev["loss_card"]
    summary = {"loss_cpu": loss_c, "loss_card": loss_g,
               "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
               "tol_loss": TOL_LOSS_CROSS, "tol_grad": TOL_GRAD_CROSS,
               **ev.get("extra", {}),
               "l1_sign_flips": int(flips.sum()), "l1_sign_flips_within_tie": int(ties.sum()),
               "l1_flip_max_abs_residual": (max(res_c.abs()[flips].max().item(),
                                                res_g.abs()[flips].max().item())
                                            if flips.any() else 0.0),
               "ray_hit_flips": int((ev["hit_cpu"] != ev["hit_card"]).sum()),
               "grad_rel_l2_err": worst, "grad_max_err_rel_to_max": largest}
    return summary, flips, ties


def cross_check_gate(label, evaluate, gate=True):
    """The card-vs-CPU gate of one training step. ``evaluate(gt_shift)``
    runs the step on both sides, with ``gt_shift`` [R, 3] added to the
    colour loss's ground truth on both (None: unchanged), and returns a dict
    of ``loss_cpu``, ``loss_card`` (floats), ``grads`` ({leaf name: (cpu
    gradient, card gradient)}), ``res_cpu``, ``res_card`` (gt - pred [R, 3]
    of the colour loss), ``hit_cpu``, ``hit_card`` ([R, 1] bool: the rays
    the colour loss counts) and ``extra`` (numbers to print).

    The colour loss is L1, whose subgradient is the residual's sign: a
    channel whose residual sits within L1_TIE of 0 on both sides can take
    opposite signs by rounding alone, and one such ±1 among a step's
    channels moves the colour path's gradients by a few per cent. When
    every sign flip of the first evaluation is such a tie, both sides are
    evaluated again with the tied channels' ground truth moved by
    L1_TIE_SHIFT toward the CPU's residual sign (the same subgradient on
    both sides; the loss moves by ~L1_TIE_SHIFT a channel), and that second
    evaluation is gated; otherwise the first is. The gate: the loss within
    TOL_LOSS_CROSS relative and every leaf's gradient within TOL_GRAD_CROSS
    relative L2; the card's gradients finite in each evaluation. Prints
    each evaluation's numbers on a line of its own; returns the first's,
    with the second's under ``tie_aligned`` (None when there was none)."""
    import torch

    ev = evaluate(None)
    first, flips, ties = _cross_summary(label, ev)
    print(json.dumps({label: first}), flush=True)
    judged = first
    first["tie_aligned"] = None
    if flips.any() and torch.equal(flips, ties):
        toward = torch.where(ev["res_cpu"] >= 0, L1_TIE_SHIFT, -L1_TIE_SHIFT)
        shift = torch.where(ties, toward, 0.0)
        second, _, _ = _cross_summary(label, evaluate(shift))
        print(json.dumps({f"{label}_tie_aligned": second}), flush=True)
        judged = first["tie_aligned"] = second
    if not gate:
        return first
    if not judged["loss_rel_err"] <= TOL_LOSS_CROSS:
        fail(f"{label}: loss {judged['loss_card']} vs {judged['loss_cpu']} on the CPU")
    bad = {k: v for k, v in judged["grad_rel_l2_err"].items() if not v <= TOL_GRAD_CROSS}
    if bad:
        fail(f"{label}: gradients off by more than {TOL_GRAD_CROSS}: {bad}")
    return first


def train_cross_check(device, cfg, params, grid, reel, it=None, label="train_cross_check",
                      gate=True):
    """One full-width training step on the CPU (the plain path) and on the
    card, with the same draws and the CPU's fg samples (with the carried
    sdf the train-time LOD ranks), gated by :func:`cross_check_gate`: the
    loss within TOL_LOSS_CROSS and every leaf's gradient within
    TOL_GRAD_CROSS (relative L2 error); the card's gradients finite. The
    colour loss's L1 sign flips (within L1_TIE on both sides: a tie under
    rounding) and the rays that hit the bound sphere on one side only
    (``ray_hit_flips``) are counted, so a failing check shows whether either
    came with it."""
    from permuto_sdf_tpu_torch.datasets import tensor_reel
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps
    from permuto_sdf_tpu_torch.train.optimizers import tree_leaves

    cpu = lambda t: t.detach().cpu()  # noqa: E731
    if it is None:
        it = cfg.nr_iter_sphere_fit + TRAIN_FROM + 200
    draws = tps.draw_train_step(tps.step_generators(SEED, it)[0], cfg, reel)
    reel_c = reel.to("cpu")
    names = []

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
    gt = tensor_reel.random_rays_from_reel(reel_c, cfg.nr_rays,
                                           indices=draws.to("cpu").ray_indices,
                                           apply_mask=cfg.with_mask)[2]
    smp = None  # the CPU's fg samples, which the card's step renders

    def evaluate(gt_shift):
        nonlocal smp
        preds = []  # (colour, ray hits) of the CPU's and the card's run_net
        run_net, rays = tps.run_net, tps.random_rays_from_reel

        def recording_run_net(*args, **kw):
            out = run_net(*args, **kw)
            preds.append((out[0].detach().cpu(), out[3]["does_intersect"].detach().cpu()))
            return out

        def shifted_rays(*args, **kw):
            out = rays(*args, **kw)
            if gt_shift is None:
                return out
            return out[:2] + (out[2] + gt_shift.to(out[2].device),) + out[3:]

        tps.run_net, tps.random_rays_from_reel = recording_run_net, shifted_rays
        try:
            t0 = time.perf_counter()
            loss_c, aux_c, grads_c = tps.compute_loss_and_grads(
                _tree_map(cpu, params),
                og.OccupancyGridState(cpu(grid.values), cpu(grid.occupancy)),
                reel_c, draws, it, cfg)
            cpu_s = time.perf_counter() - t0
            if smp is None:
                s = aux_c["samples"]
                smp = RaySamples(*(getattr(s, f).to(device) for f in
                                   ("origins", "dirs", "z", "dt", "mask", "ray_fixed_dt")),
                                 sdf=s.sdf.to(device) if s.sdf is not None else None)
            loss_g, _, grads_g = tps.compute_loss_and_grads(params, grid, reel, draws, it, cfg,
                                                            fg_samples=smp)
        finally:
            tps.run_net, tps.random_rays_from_reel = run_net, rays
        (pred_c, hit), (pred_g, hit_g) = preds
        g = gt if gt_shift is None else gt + gt_shift
        return {"loss_cpu": float(loss_c), "loss_card": float(loss_g),
                "grads": dict(zip(names, zip(tree_leaves(grads_c), tree_leaves(grads_g)))),
                "res_cpu": g - pred_c, "res_card": g - pred_g, "hit_cpu": hit,
                "hit_card": hit_g,
                "extra": {"valid_samples": int(aux_c["nr_samples"]), "cpu_step_s": cpu_s}}

    return cross_check_gate(label, evaluate, gate)


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


def chebyshev_grids(device, gcfg, scene_occupancy) -> dict:
    """Kernel J0's grids: the scene's refreshed occupancy ("scene"), an
    all-empty grid (the old scan-until-best kernel's worst case), a random
    sparse one (0.2% occupied, from SEED) and a full one."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 13)
    nv = gcfg.nr_voxels
    return {"scene": scene_occupancy,
            "empty": torch.zeros(nv, dtype=torch.bool, device=device),
            "sparse": (torch.rand(nv, generator=gen) < 0.002).to(device),
            "full": torch.ones(nv, dtype=torch.bool, device=device)}


def _jump_lookups(field, gcfg, o, d, t, allow, jumps):
    """Replays a kernel's chained jumps (J1, J2): the field lookups (inside
    the grid only: outside it a kernel reads nothing and jumps the cap),
    the distinct voxels they read, and each row's count of them."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    per_row, voxels = torch.zeros_like(t, dtype=torch.int64), []
    for _ in range(jumps):
        lin, inb = og.point_to_lin_idx(gcfg, o + t[:, None] * d)
        per_row += (allow & inb).to(torch.int64)
        voxels.append(lin[allow & inb])
        k = torch.where(inb, field[lin.clamp(0, field.numel() - 1)].to(torch.int32), 63)
        allow = allow & (k > 1)
        t = torch.where(allow, t + (k - 1).to(t.dtype) * gcfg.voxel_size, t)
    return int(per_row.sum()), int(torch.unique(torch.cat(voxels)).numel()), per_row


def weights_bwd_phase(device, cfg, reps=20, plain_reps=3):
    """Kernel D' (the backward of kernel D) against its plain version at the
    flagship step's R: NeuS (fg) and NeRF (bg) mode at the step's S (fg 96,
    bg 32), each mode at the other S, at S = 70 (rows not 16-byte aligned:
    the 4-byte stores), and on random masks that are not prefixes. Returns
    the numbers of NeuS mode at S = 96."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops import volume_rendering as vr
    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask

    rng = np.random.default_rng(SEED + 2)
    R, S_fg = cfg.nr_rays, cfg.samples_per_ray

    def tensor(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    timing, d_rows = None, {}
    for mode, S, masks in ((0, S_fg, "prefix"), (1, cfg.nr_samples_bg, "ones"),
                           (0, cfg.nr_samples_bg, "prefix"), (1, S_fg, "ones"),
                           (0, 70, "prefix"), (1, 70, "ones"), (0, S_fg, "random"),
                           (1, cfg.nr_samples_bg, "random")):
        nr = torch.from_numpy(rng.integers(0, S + 1, R)).to(device)
        if masks == "prefix":
            mask = prefix_mask(nr, S)
        elif masks == "ones":
            mask = torch.ones((R, S), dtype=torch.bool, device=device)
        else:
            mask = torch.from_numpy(rng.uniform(size=(R, S)) < 0.6).to(device)
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
        launches = vr.render_weights_bwd_cuda.launches
        got, want = vr.render_weights_bwd_cuda(*args), vr.render_weights_bwd_plain(*args)
        if vr.render_weights_bwd_cuda.launches != launches + 1:
            fail("kernel D': a wrapper call did not count one launch")
        err = max(((a - b.reshape(a.shape)).abs().max() / b.abs().max()).item()
                  for a, b in zip(got, want) if b is not None)
        label = f"D':{'neus' if mode == 0 else 'nerf'} R={R} S={S} {masks}"
        if masks == "random" or S == 70:
            print(f"[kernel {label} (relative)] max_err={err:.3e} tol={TOL_DB:.1e}", flush=True)
            _gate(label, err, TOL_DB)
            continue
        ms = time_ms(lambda: vr.render_weights_bwd_cuda(*args), reps, device)
        pms = time_ms(lambda: vr.render_weights_bwd_plain(*args), plain_reps, device)
        per_sample = (4 + 4 + 1 + 12 + 4 + 4 + 12) + (24 if mode == 0 else 0)
        nbytes = R * S * per_sample + R * (12 + 4 + 4 + 12 + 12)
        b = bound_ms(nbytes, OPS_PER_SAMPLE_DB * R * S)
        _report(f"{label} (relative)", err, TOL_DB, ms, pms, b)
        dms = device_ms(lambda: vr.render_weights_bwd_cuda(*args), "D'", device, per_launch=True,
                        launches=1)
        d_rows[label] = dict(ms=ms, plain_ms=pms, bound_ms=b[0], device_ms=dms)
        if (mode, S) == (0, S_fg):
            timing = (ms, pms, b, dms, max((a - b_.reshape(a.shape)).abs().max().item()
                                           for a, b_ in zip(got, want) if b_ is not None))
    print(f"[D' cases] {json.dumps(d_rows)}", flush=True)
    return dict(max_abs_err=timing[4], ms=timing[0], plain_ms=timing[1], bound_ms=timing[2][0],
                bound_by=timing[2][1], device_ms=timing[3])


def compaction_phase(device, alive, conv, reps=20, plain_reps=3):
    """Kernel H0 against its plain version on the tracer's round-0 masks
    (the rays ``alive`` after the prepass, ``conv`` [R] bool): alive & ~conv
    formed first and fused into the kernel's loads, below, at and above the
    count; each mode on ``alive`` and a random second mask; then timed
    beside ``torch.nonzero_static``. Returns H0's numbers."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops import sphere_trace as st

    alive, conv = alive.contiguous(), conv.contiguous()
    R = alive.shape[0]
    mask = (alive & ~conv).contiguous()
    count = int(mask.sum())
    bucket = st.pow2_bucket(count, lo=256, hi=R)
    other = torch.from_numpy(np.random.default_rng(SEED + 17).uniform(size=R) < 0.5).to(device)
    cases = [("alive&~conv", mask, {}),
             ("alive&~conv fused", alive, dict(other=conv, negate_other=True)),
             ("alive&other", alive, dict(other=other)),
             ("alive&~other", alive, dict(other=other, negate_other=True))]
    for label, m, kw in cases:
        c = int(compaction.nonzero_static_plain(m, 0, R, **kw)[1])
        for size in (c // 2, c, st.pow2_bucket(max(c, 1), lo=256, hi=R)):
            launches = compaction.nonzero_static_cuda.launches
            gi, gc = compaction.nonzero_static_cuda(m, size, R, **kw)
            wi, wc = compaction.nonzero_static_plain(m, size, R, **kw)
            if compaction.nonzero_static_cuda.launches != launches + 1:
                fail("kernel H0: a wrapper call did not count one launch")
            if not torch.equal(gi, wi) or int(gc) != int(wc):
                fail(f"kernel H0 ({label}): size {size}: {(gi != wi).sum().item()} ids differ, "
                     f"count {int(gc)} vs {int(wc)}")
    fused = dict(other=conv, negate_other=True)
    ms = time_ms(lambda: compaction.nonzero_static_cuda(mask, bucket, R), reps, device)
    pms = time_ms(lambda: compaction.nonzero_static_plain(mask, bucket, R), plain_reps, device)
    fused_ms = time_ms(lambda: compaction.nonzero_static_cuda(alive, bucket, R, **fused), reps,
                       device)
    lib = lambda: torch.nonzero_static(mask, size=bucket, fill_value=R)  # noqa: E731
    if not torch.equal(lib().reshape(-1), compaction.nonzero_static_plain(mask, bucket, R)[0]):
        fail("torch.nonzero_static differs from H0's plain version")
    lib_ms = time_ms(lib, reps, device)
    lib_dms, lib_launches = device_ms_all(lib, device)
    b = bound_ms(R + 8 * bucket + 4, 2 * R)
    _report(f"H0 n={R} count={count} bucket={bucket} (fused alive & ~conv {fused_ms:.4f} ms; "
            f"library torch.nonzero_static {lib_ms:.4f} ms, device {lib_dms} ms in "
            f"{lib_launches} launches a call)", 0.0, 0.0, ms, pms, b)
    # per call: H0 is two launches
    dms = device_ms(lambda: compaction.nonzero_static_cuda(mask, bucket, R), "H0", device,
                    per_launch=True, launches=2)
    fused_dms = device_ms(lambda: compaction.nonzero_static_cuda(alive, bucket, R, **fused), "H0",
                          device, per_launch=True, launches=2)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                library_ms=lib_ms, library_device_ms=lib_dms, library_launches=lib_launches,
                device_ms=dms, fused_ms=fused_ms, fused_device_ms=fused_dms)


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

    # --- J0: the distance field of the refreshed grid (the timed row), and
    # of an empty, a random sparse and a full grid, at caps 15 and cap
    field = None
    for label, occ in chebyshev_grids(device, gcfg, grid.occupancy).items():
        for c in (15, cap):
            got = og.chebyshev_field_cuda(gcfg, occ, c)
            want = og.chebyshev_field_plain(gcfg, occ, c)
            err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
            ms = time_ms(lambda: og.chebyshev_field_cuda(gcfg, occ, c), reps, device)
            pms = time_ms(lambda: og.chebyshev_field_plain(gcfg, occ, c), plain_reps, device)
            # the occupancy read once and the uint8 field written once; three
            # passes of a linear-time method
            b = bound_ms(2 * gcfg.nr_voxels, 3 * gcfg.nr_voxels * OPS_PER_CHEBYSHEV_VOXEL_PASS)
            hist = torch.bincount(want.to(torch.int64), minlength=c + 1)
            _report(f"J0:{label} V={gcfg.nr_voxels_per_dim} cap={c} (occupied {int(hist[0])}, "
                    f"at the cap {int(hist[c])})", err, 0.0, ms, pms, b)
            if label == "scene" and c == cap:
                dms = device_ms(lambda: og.chebyshev_field_cuda(gcfg, occ, c), "J0", device)
                results["J0"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0],
                                     bound_by=b[1], device_ms=dms)
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

    # --- J1: the jump prepass, and round 0's list written in the same launch
    jumps = 16
    ks, ps = ({k: v.clone() for k, v in state0.items()} for _ in range(2))
    args = lambda s: (field, s["origins_f"], s["dirs_f"], s["texit_f"], s["t_f"], s["alive_f"])  # noqa: E731
    n_k, idx_k = st.jump_prepass_cuda(*args(ks), gcfg, jumps)
    n_p, idx_p = st.jump_prepass_plain(*args(ps), gcfg, jumps)
    err = max(compare("J1", ks[k], ps[k]) for k in ("t_f", "alive_f"))
    if int(n_k) != int(n_p):
        fail(f"kernel J1: alive count {int(n_k)} vs {int(n_p)}")
    count = int(n_p)
    for size in (count // 2, count, st.pow2_bucket(count, lo=256, hi=R), R):
        want, _ = compaction.nonzero_static_plain(ps["alive_f"][:R], size, R)
        if not torch.equal(idx_k[:size], want):
            fail(f"kernel J1: round 0's list at bucket {size}: "
                 f"{(idx_k[:size] != want).sum().item()} ids differ from nonzero_static")

    def run_j1(fn, s=work, jumps=jumps):
        restore()
        fn(field, s["origins_f"], s["dirs_f"], s["texit_f"], s["t_f"], s["alive_f"], gcfg, jumps)

    ms = time_ms(lambda: run_j1(st.jump_prepass_cuda), reps, device) - restore_ms
    pms = time_ms(lambda: run_j1(st.jump_prepass_plain), plain_reps, device) - restore_ms
    lookups, voxels, per_row = _jump_lookups(field, gcfg, state0["origins_f"], state0["dirs_f"],
                                             state0["t_f"], state0["alive_f"], jumps)
    # the state read, t and the flags written, the list (8 B a row below R)
    # and the count; the field's distinct voxels
    b = bound_ms((R + 1) * (12 + 12 + 4 + 4 + 1 + 4 + 1) + 8 * R + voxels + 4,
                 lookups * OPS_PER_LOOKUP)
    # per call of J1's two launches
    dms = device_ms(lambda: run_j1(st.jump_prepass_cuda), "J1", device, per_launch=True,
                    launches=2)
    # the chain floor: the longest chain of one ray, times one chained
    # lookup's latency measured on that ray alone (its device ms at 16
    # jumps less at 0, over its chain; the field in L2 from the runs before)
    ray = int(per_row.argmax())
    chain = int(per_row[ray])
    one = {k: torch.cat([v[ray:ray + 1], v[-1:]]) for k, v in state0.items()}
    one_work = {k: v.clone() for k, v in one.items()}

    def run_one(j):
        for k, v in one_work.items():
            v.copy_(one[k])
        st.jump_prepass_cuda(field, one_work["origins_f"], one_work["dirs_f"],
                             one_work["texit_f"], one_work["t_f"], one_work["alive_f"], gcfg, j)

    one_ms = [device_ms(lambda j=j: run_one(j), "J1", device, reps=50, per_launch=True,
                        launches=2) for j in (jumps, 0)]
    lookup_us = ((one_ms[0] - one_ms[1]) * 1e3 / chain
                 if chain > 0 and None not in one_ms else None)
    chain_ms = chain * lookup_us / 1e3 if lookup_us is not None else None
    _report(f"J1 R={R} jumps={jumps} (alive {int(state0['alive_f'].sum())} -> {count}, "
            f"{lookups} lookups inside the grid of {voxels} voxels; longest chain {chain} "
            f"lookups x {lookup_us} us a chained lookup = {chain_ms} ms)", err, TOL_J, ms, pms, b)
    results["J1"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                         device_ms=dms, longest_chain=chain, chained_lookup_us=lookup_us,
                         chain_floor_ms=chain_ms)

    # --- H0: the round-0 bucket of the parked rays
    state1 = ps  # after the prepass
    results["H0"] = compaction_phase(device, state1["alive_f"][:R], state1["conv_f"][:R], reps,
                                     plain_reps)
    mask = (state1["alive_f"] & ~state1["conv_f"])[:R].contiguous()
    bucket = st.pow2_bucket(int(mask.sum()), lo=256, hi=R)

    # --- J2: one iteration of round 0 (LOD 6) on that bucket, 4 chained jumps
    idx, _ = compaction.nonzero_static_plain(mask, bucket, R)
    kw = dict(dist_field=field, grid_cfg=gcfg, sdf_multiplier=0.9, sdf_converged_tresh=2e-4,
              jump_substeps=4, jump_gate=gcfg.voxel_size)
    sargs = lambda s: (s["origins_f"], s["dirs_f"], s["texit_f"], s["t_f"], s["alive_f"],  # noqa: E731
                       s["conv_f"], s["sdf_f"])
    pos, _ = st.trace_step_plain(idx, None, *sargs(state1), **kw)
    with torch.no_grad():
        s_val = tps.SDFEval(cfg.sdf_model, ST_KW["lod_schedule"][0])(
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
    lookups, voxels, _ = _jump_lookups(field, gcfg, state1["origins_f"][ii],
                                       state1["dirs_f"][ii], state1["t_f"][ii] + sv * 0.9,
                                       act & (sv > gcfg.voxel_size), 4)
    per_ray = 8 + 4 + (12 + 12 + 4 + 4 + 1 + 1 + 4) + (4 + 1 + 1 + 4) + 12
    b = bound_ms(bucket * per_ray + voxels + 8, bucket * OPS_PER_TRACE_STEP
                 + lookups * OPS_PER_LOOKUP)
    _report(f"J2 R={R} bucket={bucket} substeps=4 (counts {out_p[1].tolist()}, {lookups} "
            f"lookups of {voxels} voxels)", err, TOL_J, ms, pms, b)
    dms = device_ms(lambda: run_j2(st.trace_step_cuda), "J2", device)
    results["J2"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                         device_ms=dms)
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
        times, stats, stages = [], [], 0
        for f in range(frames + 1):
            stats = []
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            img = tps.render_image_sphere_traced_fast(params, grid, K, tf, width, height, ITER,
                                                      cfg, device=device, stats_out=stats,
                                                      **ST_KW)
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
            stages += sum(1 for s in stats if s[0] != "lit")
        counts = read_counts()
        missing = [k for k in SPHERE_KERNELS if counts[k] <= 0]
        if missing:
            fail(f"sphere-traced render {run}: no launch of kernel {missing}")
        # J1 once a chunk (it lists round 0's bucket too), J2f once a round
        # and once for the refine, the unfused J2 never, and A only in the
        # shading (two encodes a chunk), B once a chunk
        chunks = sum(1 for s in stats if s[0] == "lit") * (frames + 1)
        want = {"J1": chunks, "J2f": stages, "J2": 0, "A": 2 * chunks, "B": chunks}
        if any(counts[k] != v for k, v in want.items()):
            fail(f"sphere-traced render {run}: launches {({k: counts[k] for k in want})}, "
                 f"expected {want}")
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


def profile_sphere_frame(device, cfg, params, grid, first=False):
    """One more 400x400 sphere-traced frame under torch.profiler; with
    ``first``, the first frame after a grid refresh (the distance field
    cache emptied, so the frame builds the field with J0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera_k(WIDTH, HEIGHT)
    if first:
        tps._DIST_FIELD_CACHE.clear()
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
        alive, cfg.grid, 16)[0])
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


# ---------------------------------------------------------------------------
# Slice 4: the importance stage (E1, E2), the hit-ray take and scatter (H1,
# H2), the LOD volumetric frame and the hit-ray training step
# ---------------------------------------------------------------------------

def importance_kernel_phases(device, cfg, params, grid, frame_profile=None, reps=20,
                             plain_reps=3):
    """Kernels E1 and E2 against their plain versions on the samples of one
    chunk of the exact frame (R = CHUNK rays through the frame's center,
    kernel C's uniform samples, the proxy sdf on the imp_sampling_max_levels
    coarsest levels, no jitter) and of the training step (the first nr_rays
    of them, jitter on): E1's round 1 (S = 64); E2 in its three forms on
    round 1's samples and draws (64 + 16 with sdf): (a) the merge, (b) the
    merge and round 2, (c) the merge, round 2 and the draws merged in; (a)
    again on (b)'s merged set and draws with their sdf (80 + 16, the
    train-time LOD's last merge); and the three forms on an unsorted batch
    (the draws in reverse order), which takes E2's count branch. The merged
    sets of (a) and (b) must equal the plain merge bit for bit (z, dt, mask,
    sdf); the draws of (b) and z and dt of (c) are within TOL_E, their masks
    exact. Prints the share of the chunk's rays whose two sets are both
    ascending (E2's merge branch) and, from ``frame_profile`` (the exact
    frame's ``_profile_summary``), the device µs per launch beside the
    timings. Returns {kernel: numbers} timed at the chunk's shapes (E2 in
    each form; its row is form c, the one the exact frame launches)."""
    import dataclasses

    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K_cam, tf = camera()
    origins, dirs = rays_from_frame(K_cam, tf, WIDTH, HEIGHT, device=device)
    mid = (origins.shape[0] // 2 // CHUNK) * CHUNK
    n = cfg.nr_samples_imp_sampling
    rng = np.random.default_rng(SEED + 4)
    results, timing = {}, {}

    def proxy_sdf(smp):
        with torch.no_grad():
            return tps._masked_sdf_value(params["sdf"], smp.flat_positions(), smp.flat_mask(),
                                         ITER, cfg.sdf_model, None,
                                         max_levels=cfg.imp_sampling_max_levels
                                         ).reshape(smp.mask.shape)

    def ascending(smp):
        key = torch.where(smp.mask, smp.z, torch.full_like(smp.z, float("inf")))
        return (key[:, 1:] >= key[:, :-1]).all(dim=1)

    errs = {"E1": [0.0, 0], "E2": [0.0, 0]}
    fields = lambda r: {f: getattr(r, f) for f in ("z", "dt", "mask", "sdf")}  # noqa: E731

    def check(name, what, got, want, exact=("mask",), close=("z",)):
        for f in exact:
            a, b = got[f], want[f]
            if a is None and b is None:
                continue
            if a is None or b is None or not torch.equal(a, b):
                bad = "one side has none" if a is None or b is None else (
                    f"differs in {int((a != b).sum())} slots")
                fail(f"kernel {name} ({what}): {f} {bad}")
        for f in close:
            d = (got[f] - want[f]).abs()
            errs[name][0] = max(errs[name][0], d.max().item())
            errs[name][1] += int((d > 1e-6).sum())
            if not d.max().item() <= TOL_E:
                fail(f"kernel {name} ({what}): {f} off by {d.max().item():.3e} > {TOL_E:.0e}")

    for label, R, jittered in (("chunk", CHUNK, False), ("train", cfg.nr_rays, True)):
        o, d = origins[mid:mid + R].contiguous(), dirs[mid:mid + R].contiguous()
        _, te, _, tx, _ = tps.BOUND.ray_intersection(o, d)
        smp = og.compute_samples_in_occupied_regions(cfg.grid, grid, o, d, te, tx,
                                                     cfg.min_dist_between_samples,
                                                     cfg.max_nr_samples_per_ray)
        mov = 1.0 / (n + 1) / 2.0
        jit = [torch.from_numpy(rng.uniform(-mov, mov, (R, n)).astype(np.float32)).to(device)
               if jittered else None for _ in range(2)]
        sdf = proxy_sdf(smp)
        smp = smp.with_sdf(sdf)
        # round 1 (E1), then E2's three forms on its draws as the path gives
        # them (ascending) and reversed (the count branch)
        a1 = (smp, sdf, n, jit[0], 1.0)
        zk, mk = isp.importance_round_cuda(*a1)
        zp, mp = isp.importance_round_plain(*a1)
        check("E1", f"{label} round 1 S={smp.max_samples}", {"z": zk, "mask": mk},
              {"z": zp, "mask": mp})
        imp = isp.importance_round(smp, sdf, n, jit[0], 1.0)
        imp = imp.with_sdf(proxy_sdf(imp))
        share = (ascending(smp) & ascending(imp)).float().mean().item()
        print(f"[kernel E2] {label}: share of the rays whose two sets are both ascending (the "
              f"merge branch): {share:.6f}", flush=True)
        if label == "chunk":
            branch_share = share
        rev = dataclasses.replace(imp, z=imp.z.flip(1), sdf=imp.sdf.flip(1))
        if label == "chunk" and (ascending(smp) & ascending(rev)).all():
            fail("kernel E2: the reversed draws are still ascending on every ray")
        for order, b in (("ascending", imp), ("reversed", rev)):
            m_args = (smp, b, tx)
            what = f"{label} {order} S={smp.max_samples}+{n}"
            gp = vr.combine_uniform_samples_with_imp(*m_args)
            check("E2", f"{what} (a) with sdf", fields(isp.merge_samples_cuda(*m_args)),
                  fields(gp), exact=("z", "dt", "mask", "sdf"), close=())
            b_args = m_args + (n, jit[1])
            mk_, dk_ = isp.merge_samples_cuda(*b_args)
            mp_, dp_ = isp.merge_samples_plain(*b_args)
            check("E2", f"{what} (b) merged", fields(mk_), fields(mp_),
                  exact=("z", "dt", "mask", "sdf"), close=())
            check("E2", f"{what} (b) draws", {"z": dk_.z, "mask": dk_.mask},
                  {"z": dp_.z, "mask": dp_.mask})
            check("E2", f"{what} (c)", fields(isp.merge_samples_cuda(*b_args, merge_draws=True)),
                  fields(isp.merge_samples_plain(*b_args, merge_draws=True)),
                  exact=("mask", "sdf"), close=("z", "dt"))
            if order == "ascending":
                # the train-time LOD's last merge: (b)'s set and draws with sdf
                m2 = (mk_, dk_.with_sdf(proxy_sdf(dk_)), tx)
                check("E2", f"{label} (a) S={mk_.max_samples}+{n} with sdf",
                      fields(isp.merge_samples_cuda(*m2)),
                      fields(vr.combine_uniform_samples_with_imp(*m2)),
                      exact=("z", "dt", "mask", "sdf"), close=())
                c_args, a_args = b_args, m_args
                inf = float("inf")
                sort_keys = torch.cat([torch.where(mk_.mask, mk_.z, inf),
                                       torch.where(dk_.mask, dk_.z, inf)], dim=1)
        valid = int(smp.mask.sum())
        print(f"[kernel E] {label}: R={R} n={n} jitter={jittered} valid uniform samples "
              f"{valid}; E1 max z err {errs['E1'][0]:.3e} ({errs['E1'][1]} above 1e-6), "
              f"E2 max z/dt err {errs['E2'][0]:.3e} ({errs['E2'][1]} above 1e-6); E2's merged "
              f"sets equal the plain merge", flush=True)
        if label != "chunk":
            continue
        S = smp.max_samples
        S2 = S + n
        timing["E1"] = (time_ms(lambda: isp.importance_round_cuda(*a1), reps, device),
                        time_ms(lambda: isp.importance_round_plain(*a1), plain_reps, device),
                        bound_ms(R * S * (4 + 4 + 4 + 1) + R * 4 + R * n * (4 + 1),
                                 R * S * OPS_PER_SAMPLE_E1 + R * n * OPS_PER_DRAW_E1),
                        device_ms(lambda: isp.importance_round_cuda(*a1), "E1", device))
        # each form's own bytes: its inputs once, its outputs once
        read = R * S2 * (4 + 1 + 4) + R * 8
        merge_ops = R * S2 * (math.ceil(math.log2(S2)) + OPS_PER_SLOT_E2)
        draw_ops = R * S2 * OPS_PER_SAMPLE_E1 + R * n * OPS_PER_DRAW_E1
        T = S2 + n
        forms = {"a": (lambda: isp.merge_samples_cuda(*a_args),
                       lambda: vr.combine_uniform_samples_with_imp(*a_args),
                       bound_ms(read + R * S2 * (4 + 4 + 1 + 4), merge_ops)),
                 "b": (lambda: isp.merge_samples_cuda(*c_args),
                       lambda: isp.merge_samples_plain(*c_args),
                       bound_ms(read + R * S2 * (4 + 4 + 1 + 4) + R * n * (4 + 1),
                                merge_ops + draw_ops)),
                 "c": (lambda: isp.merge_samples_cuda(*c_args, merge_draws=True),
                       lambda: isp.merge_samples_plain(*c_args, merge_draws=True),
                       bound_ms(read + R * T * (4 + 4 + 1), merge_ops + draw_ops
                                + R * T * (math.ceil(math.log2(T)) + OPS_PER_SLOT_E2)))}
        for form, (run_k, run_p, b) in forms.items():
            timing["E2" + form] = (time_ms(run_k, reps, device),
                                   time_ms(run_p, plain_reps, device), b,
                                   device_ms(run_k, "E2", device))
        sort_ms = time_ms(lambda: torch.sort(sort_keys, dim=1, stable=True), reps, device)
        sort_shape = list(sort_keys.shape)
    prof = {}
    if frame_profile is not None:
        for k in ("E1", "E2"):
            nl = frame_profile["kernels_launches"].get(k, 0)
            prof[k] = frame_profile["kernels_ms"][k] / nl * 1e3 if nl else None
    for name, what in (("E1", "round 1, S=64"), ("E2:a", "merge 64+16 with sdf"),
                       ("E2:b", "merge 64+16, round 2"),
                       ("E2:c", "merge 64+16, round 2, merge 80+16")):
        ms, pms, b, dms = timing[name.replace(":", "")]
        kernel = name[:2]
        dev_us = prof.get(kernel)
        _report(f"{name} R={CHUNK} ({what}; device "
                f"{dms * 1e3 if dms is not None else float('nan'):.2f} us a call here, "
                f"{dev_us if dev_us is not None else float('nan'):.2f} a launch in the exact "
                f"frame's profile)", errs[kernel][0], TOL_E, ms, pms, b)
        results[name] = dict(max_abs_err=errs[kernel][0], ms=ms, plain_ms=pms, bound_ms=b[0],
                             bound_by=b[1], device_ms=dms, count_above_1e6=errs[kernel][1],
                             frame_profile_us_per_launch=dev_us)
    print(f"[kernel E2] torch.sort(keys, stable=True) at {sort_shape}: "
          f"{sort_ms:.4f} ms (the cost of the order alone)", flush=True)
    forms = {f: results.pop("E2:" + f) for f in "abc"}
    results["E2"] = dict(forms["c"], forms=forms, sort_ms=sort_ms,
                         merge_branch_share=branch_share)
    return results


def importance_sharp_phase(device, cfg, params, grid):
    """Kernel E1, and E2's round 2 (form b, which shares E1's draw), against
    their plain versions where the weights are sharp: the sphere scene
    (SPHERE_INIT_STEPS steps towards a sphere's SDF, its refreshed grid) at
    one CHUNK-ray chunk through the exact frame's center and at the
    training step's rays (jitter on), the samples and proxy sdf as the path
    gives them. z within TOL_E, masks exact. Prints the largest error, the
    draws off by more than 1e-6, and how sharp the weights are: the median
    over the rays with weight of the largest normalized weight."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K_cam, tf = camera()
    origins, dirs = rays_from_frame(K_cam, tf, WIDTH, HEIGHT, device=device)
    mid = (origins.shape[0] // 2 // CHUNK) * CHUNK
    n = cfg.nr_samples_imp_sampling
    rng = np.random.default_rng(SEED + 5)
    out = {}

    def proxy_sdf(smp):
        with torch.no_grad():
            return tps._masked_sdf_value(params["sdf"], smp.flat_positions(), smp.flat_mask(),
                                         ITER, cfg.sdf_model, None,
                                         max_levels=cfg.imp_sampling_max_levels
                                         ).reshape(smp.mask.shape)

    for label, R, jittered in (("chunk", CHUNK, False), ("train", cfg.nr_rays, True)):
        o, d = origins[mid:mid + R].contiguous(), dirs[mid:mid + R].contiguous()
        _, te, _, tx, _ = tps.BOUND.ray_intersection(o, d)
        smp = og.compute_samples_in_occupied_regions(cfg.grid, grid, o, d, te, tx,
                                                     cfg.min_dist_between_samples,
                                                     cfg.max_nr_samples_per_ray)
        sdf = proxy_sdf(smp)
        smp = smp.with_sdf(sdf)
        mov = 1.0 / (n + 1) / 2.0
        jit = [torch.from_numpy(rng.uniform(-mov, mov, (R, n)).astype(np.float32)).to(device)
               if jittered else None for _ in range(2)]
        zk, mk = isp.importance_round_cuda(smp, sdf, n, jit[0])
        zp, mp = isp.importance_round_plain(smp, sdf, n, jit[0])
        imp = isp.importance_round(smp, sdf, n, jit[0])
        imp = imp.with_sdf(proxy_sdf(imp))
        _, dk = isp.merge_samples_cuda(smp, imp, tx, n, jit[1])
        _, dp = isp.merge_samples_plain(smp, imp, tx, n, jit[1])
        cdf = isp._weights_cdf(smp, sdf, 1.0)
        w_max = (cdf[:, 1:] - cdf[:, :-1]).amax(dim=1)
        sharp = float(w_max[w_max > 0].median()) if bool((w_max > 0).any()) else 0.0
        res = {}
        for name, (a, am), (b, bm) in (("E1", (zk, mk), (zp, mp)),
                                       ("E2b", (dk.z, dk.mask), (dp.z, dp.mask))):
            if not torch.equal(am, bm):
                fail(f"kernel {name} on the sphere scene ({label}): masks differ in "
                     f"{int((am != bm).sum())} slots")
            err = (a - b).abs()
            res[name] = {"max_abs_err": err.max().item(), "above_1e-6": int((err > 1e-6).sum())}
            if not res[name]["max_abs_err"] <= TOL_E:
                fail(f"kernel {name} on the sphere scene ({label}): z off by "
                     f"{res[name]['max_abs_err']:.3e} > {TOL_E:.0e}")
        res["median_max_weight"] = sharp
        out[label] = res
        print(f"[kernel E1:sharp] sphere scene {label} R={R} S={smp.max_samples} n={n}: median "
              f"largest weight {sharp:.4f}; E1 z err {res['E1']['max_abs_err']:.3e} "
              f"({res['E1']['above_1e-6']} above 1e-6), E2 round 2 z err "
              f"{res['E2b']['max_abs_err']:.3e} ({res['E2b']['above_1e-6']} above 1e-6); "
              f"TOL_E {TOL_E:.0e}", flush=True)
    return out


def hit_ray_kernel_phases(device, cfg, reps=20, plain_reps=3):
    """Kernels H1 and H2 (and H2's backward) against their plain versions at
    the training step's shapes: nr_rays rays of S = max_nr_samples_per_ray
    uniform samples, half of them hit, into the bucket of hit_ray_frac 0.5
    (early compaction's arrays: origins, dirs, z, dt, mask, ray_fixed_dt,
    t_exit, image ids), and the four per-ray results back. Exact."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    rng = np.random.default_rng(SEED + 5)
    R, S = cfg.nr_rays, cfg.max_nr_samples_per_ray
    B = tps._hit_ray_budget(R, 0.5)
    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    nr = torch.from_numpy(rng.integers(0, S + 1, R) * (rng.uniform(size=R) < 0.5)).to(device)
    mask = torch.arange(S, device=device)[None, :] < nr[:, None]
    arrays = [f32(R, 3), f32(R, 3), f32(R, S), f32(R, S), mask, f32(R), f32(R, 1),
              torch.from_numpy(rng.integers(0, 24, R)).to(device)]
    hits = int(mask.any(dim=1).sum())
    idx, _ = compaction.nonzero_static(mask.any(dim=1).contiguous(), B, R)
    got, want = compaction.take_rows_cuda(arrays, idx), compaction.take_rows_plain(arrays, idx)
    for k, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            fail(f"kernel H1: array {k} differs from the plain version")
    xs = [f32(B, 3), f32(B, 3), f32(B, 1), f32(B)]
    fills = (0.0, 0.0, 0.0, 1.0)
    for a, b in zip(compaction.scatter_rows_cuda(xs, idx, R, fills),
                    compaction.scatter_rows_plain(xs, idx, R, fills)):
        if not torch.equal(a, b):
            fail("kernel H2: a scattered array differs from the plain version")
    leaves = [x.clone().requires_grad_(True) for x in xs]
    cots = [f32(R, 3), f32(R, 3), f32(R, 1), f32(R)]
    torch.autograd.backward(compaction.scatter_rows(leaves, idx, R, fills), cots)
    for leaf, c in zip(leaves, cots):
        if not torch.equal(leaf.grad, compaction.take_rows_plain([c], idx)[0]):
            fail("kernel H2's backward (H1 on the cotangents) differs from the plain gather")
    row_in = sum(a[0].numel() * a.element_size() for a in arrays)
    t1 = (time_ms(lambda: compaction.take_rows_cuda(arrays, idx), reps, device),
          time_ms(lambda: compaction.take_rows_plain(arrays, idx), plain_reps, device),
          bound_ms(B * 8 + hits * row_in + B * row_in, 0))
    row_out = (3 + 3 + 1 + 1) * 4
    t2 = (time_ms(lambda: compaction.scatter_rows_cuda(xs, idx, R, fills), reps, device),
          time_ms(lambda: compaction.scatter_rows_plain(xs, idx, R, fills), plain_reps, device),
          bound_ms(B * 8 + B * row_out + R * row_out, 0))
    _report(f"H1 R={R} S={S} bucket={B} hits={hits} (8 arrays)", 0.0, 0.0, *t1)
    _report(f"H2 R={R} bucket={B} (4 arrays; backward = H1, exact)", 0.0, 0.0, *t2)

    # H1 on narrower chunks: the same arrays based at an odd element (4- and
    # 1-byte chunks), and rows of odd widths (3-byte bool rows, 3 floats,
    # int64 pairs); bit for bit, one launch a call, device ms a launch
    def at_odd(a):
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=device)
        flat[1:] = a.reshape(-1)
        return flat[1:].view(a.shape)

    cases = {"step": arrays, "odd_base": [at_odd(a) for a in arrays],
             "odd_width": [mask[:, :3].contiguous(), at_odd(mask[:, :3].contiguous()),
                           f32(R, 3), at_odd(f32(R, 3)),
                           torch.from_numpy(rng.integers(0, 2 ** 40, (R, 2))).to(device)]}
    h1_cases = {}
    for label, arrs in cases.items():
        launches = compaction.take_rows_cuda.launches
        got = compaction.take_rows_cuda(arrs, idx)
        if compaction.take_rows_cuda.launches != launches + 1:
            fail(f"kernel H1 ({label}): not one launch a call")
        for k, (a, b) in enumerate(zip(got, compaction.take_rows_plain(arrs, idx))):
            if not torch.equal(a, b):
                fail(f"kernel H1 ({label}): array {k} differs from the plain version")
        fn = lambda arrs=arrs: compaction.take_rows_cuda(arrs, idx)  # noqa: E731
        rb = sum(a[0].numel() * a.element_size() for a in arrs)
        h1_cases[label] = {
            "ms": time_ms(fn, reps, device), "device_ms": device_ms(fn, "H1", device,
                                                                    per_launch=True),
            "chunk_bytes": [compaction._row_arrays(arrs, got).chunk[k]
                            for k in range(len(arrs))],
            "bound_ms": bound_ms(B * 8 + int((idx < R).sum()) * rb + B * rb, 0)[0]}
    print(f"[kernel H1] cases (bit for bit, one launch each): {json.dumps(h1_cases)}",
          flush=True)

    # H2 on the same chunk widths: the step's bucket arrays, the same based
    # at an odd element, and bucket rows of odd widths, with nonzero fills
    # on the float arrays; bit for bit, one launch a call, device ms a launch
    h2_sets = {"step": (xs, fills), "odd_base": ([at_odd(x) for x in xs], fills),
               "odd_width": ([(torch.from_numpy(rng.uniform(size=(B, 3)) < 0.5)).to(device),
                              at_odd(torch.from_numpy(rng.uniform(size=(B, 3)) < 0.5).to(device)),
                              f32(B, 3), at_odd(f32(B, 3)),
                              torch.from_numpy(rng.integers(0, 2 ** 40, (B, 2))).to(device)],
                             (0.0, 0.0, 0.5, -2.0, 0.0))}
    h2_cases = {}
    for label, (arrs, fl) in h2_sets.items():
        launches = compaction.scatter_rows_cuda.launches
        got = compaction.scatter_rows_cuda(arrs, idx, R, fl)
        if compaction.scatter_rows_cuda.launches != launches + 1:
            fail(f"kernel H2 ({label}): not one launch a call")
        for k, (a, b) in enumerate(zip(got, compaction.scatter_rows_plain(arrs, idx, R, fl))):
            if not torch.equal(a, b):
                fail(f"kernel H2 ({label}): array {k} differs from the plain version")
        fn = lambda arrs=arrs, fl=fl: compaction.scatter_rows_cuda(arrs, idx, R, fl)  # noqa: E731
        rb = sum(a[0].numel() * a.element_size() for a in arrs)
        h2_cases[label] = {
            "ms": time_ms(fn, reps, device), "device_ms": device_ms(fn, "H2", device,
                                                                    per_launch=True),
            "chunk_bytes": [compaction._row_arrays(arrs, got).chunk[k]
                            for k in range(len(arrs))],
            "bound_ms": bound_ms(B * 8 + int((idx < R).sum()) * rb + R * rb, 0)[0]}
    print(f"[kernel H2] cases (bit for bit, one launch each): {json.dumps(h2_cases)}",
          flush=True)
    return {"H1": dict(max_abs_err=0.0, ms=t1[0], plain_ms=t1[1], bound_ms=t1[2][0],
                       bound_by=t1[2][1], device_ms=h1_cases["step"]["device_ms"],
                       cases=h1_cases),
            "H2": dict(max_abs_err=0.0, ms=t2[0], plain_ms=t2[1], bound_ms=t2[2][0],
                       bound_by=t2[2][1], device_ms=h2_cases["step"]["device_ms"],
                       cases=h2_cases)}


LOD = (12, 32)  # the interactive viewer's volumetric mode (interactive.py:127-134)
LOD_TRAIN_FROM = TRAIN_FROM + 30  # the resumed window holds iteration % 50 == 0
TOL_HIT_LOSS = 1e-6  # the compacted step's loss vs the dense step's (sums in another order)


def _psnr(a, b) -> float:
    mse = ((a - b) ** 2).mean().item()
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


def lod_render_phase(device, cfg, scenes, exact, frames=N_FRAMES):
    """``render_image(lod=LOD)`` frames at WIDTH x HEIGHT on each scene (the
    camera of the exact frames): one warm-up frame, then the launch counts
    reset and ``frames`` timed frames (host clock ending in a synchronize),
    the counts read; then each LOD frame against the exact frame of the
    same scene rendered in this call (``exact``): the PSNR of rgb and alpha
    and the share of pixels off by more than 0.1. Returns {scene: summary}."""
    import torch

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera()
    out = {}
    for name, (params, grid) in scenes.items():
        tps.render_image(params, grid, K, tf, WIDTH, HEIGHT, ITER, cfg, chunk=CHUNK,
                         device=device, lod=LOD)
        reset_counts()
        times = []
        for _ in range(frames):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            img = tps.render_image(params, grid, K, tf, WIDTH, HEIGHT, ITER, cfg, chunk=CHUNK,
                                   device=device, lod=LOD)
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        missing = [k for k in RENDER_KERNELS if counts[k] <= 0]
        if missing:
            fail(f"LOD render on the {name} scene launched no kernel {missing}")
        # stage 1's importance stage: E1 and one E2 (form c) per chunk
        expected = -(-WIDTH * HEIGHT // CHUNK) * frames
        if not counts["E1"] == counts["E2"] == expected:
            fail(f"LOD render on the {name} scene: E1/E2 launches {counts['E1']}/"
                 f"{counts['E2']}, expected {expected} each")
        for t in img:
            if not torch.isfinite(t).all():
                fail(f"LOD render on the {name} scene produced non-finite values")
        ref = exact[name]
        off = torch.maximum((img[0] - ref[0]).abs().amax(dim=-1),
                            (img[2] - ref[2]).abs()[..., 0]) > 0.1
        med = statistics.median(times)
        out[name] = {"lod": list(LOD), "ms_per_frame_median": med, "ms_per_frame_min": min(times),
                     "ms_per_frame_max": max(times), "ms_per_frame_all": times,
                     "rays_per_s_median": WIDTH * HEIGHT / med * 1e3,
                     "launches_per_frame": {k: counts[k] / frames for k in RENDER_KERNELS},
                     "psnr_rgb_vs_exact": _psnr(img[0], ref[0]),
                     "psnr_alpha_vs_exact": _psnr(img[2], ref[2]),
                     "share_pixels_off_by_0.1": off.float().mean().item(),
                     "mean_alpha": img[2].mean().item(), "mean_alpha_exact": ref[2].mean().item(),
                     "launches": counts}
        print(f"[lod] scene={name} {WIDTH}x{HEIGHT} lod={LOD}, {frames} frames: median {med:.1f} "
              f"ms/frame (min {min(times):.1f}, max {max(times):.1f}); vs exact: PSNR rgb "
              f"{out[name]['psnr_rgb_vs_exact']:.2f} dB, alpha "
              f"{out[name]['psnr_alpha_vs_exact']:.2f} dB, pixels off by > 0.1: "
              f"{out[name]['share_pixels_off_by_0.1']:.5f}; launches/frame "
              f"{out[name]['launches_per_frame']}", flush=True)
    return out


def profile_lod_frame(device, cfg, params, grid):
    """One more LOD frame under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tps.render_image(params, grid, K, tf, WIDTH, HEIGHT, ITER, cfg, chunk=CHUNK,
                         device=device, lod=LOD)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms, "lod_frame")


def lod_cross_check(device, cfg, params, grid):
    """CROSS_RAYS rays (a block at the frame's center) of the LOD render on
    the card and on the CPU (plain versions): the CPU's selected samples
    rendered on the card (``_lod_fine_render``) must give the CPU's rgb,
    normals and weights_sum within TOL_CROSS. The whole path on the card
    runs ``render_rays_eval_lod`` with the cfg the timed frames pass; a ray
    may be off by more only where its selected set differs from the CPU's
    (a top-k tie) or its samples' z differ from the CPU's by at most
    LOD_CROSS_MAX_Z_GAP (a sample a rounding apart across a fine lattice
    face), on at most LOD_CROSS_MAX_OFF_SHARE of the rays; the script prints
    how many those are and the largest z gap it excused."""
    import dataclasses

    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera()
    side = int(CROSS_RAYS ** 0.5)
    y0, x0 = HEIGHT // 2 - side // 2, WIDTH // 2 - side // 2
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + side), torch.arange(x0, x0 + side),
                            indexing="ij")
    pix = (ys * WIDTH + xs).reshape(-1)
    origins, dirs = rays_from_frame(K, tf, WIDTH, HEIGHT, device="cpu")
    o, d = origins[pix], dirs[pix]
    cpu = lambda t: t.detach().cpu()  # noqa: E731

    def to_card(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return dataclasses.replace(v, **{f.name: getattr(v, f.name).to(device)
                                         for f in dataclasses.fields(v)
                                         if getattr(v, f.name) is not None})

    params_cpu = _tree_map(cpu, params)
    grid_cpu = og.OccupancyGridState(values=cpu(grid.values), occupancy=cpu(grid.occupancy))
    ecfg = tps._eval_cfg(cfg)
    args = (ITER, 1.0, 0.8, ecfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        mid_p = tps._lod_coarse_select(params_cpu, grid_cpu, o, d, *args, *LOD)
        ref = tps._lod_fine_render(params_cpu, mid_p, o, d, *args)
        cpu_s = time.perf_counter() - t0
        mid_moved = {k: to_card(v) for k, v in mid_p.items()}
        same = tps._lod_fine_render(params, mid_moved, o.to(device), d.to(device), *args)
        mid_c = tps._lod_coarse_select(params, grid, o.to(device), d.to(device), *args, *LOD)
        whole = tps.render_rays_eval_lod(params, grid, o.to(device), d.to(device), ITER, 1.0,
                                         0.8, cfg, *LOD)
    names = ("rgb", "normals", "weights_sum")
    errs = {k: (g.cpu() - r).abs().max().item() for k, g, r in zip(names, same, ref)}
    sp, sc = mid_p["samples"], mid_c["samples"]
    zc, mc = sc.z.cpu(), sc.mask.cpu()
    # per ray: the largest |z card - z CPU| over its samples, inf where the masks differ
    z_gap = torch.where(mc & sp.mask, (zc - sp.z).abs(), torch.zeros_like(zc))
    z_gap = torch.where(mc != sp.mask, torch.full_like(z_gap, math.inf), z_gap).amax(dim=1)
    sel_p = torch.sort(mid_p["ik"], dim=1).values
    sel_c = torch.sort(mid_c["ik"].cpu(), dim=1).values
    selection_differs = (sel_p != sel_c).any(dim=1)
    excused = selection_differs | ((z_gap > 0) & (z_gap <= LOD_CROSS_MAX_Z_GAP))
    off = torch.stack([(g.cpu() - r).abs().amax(dim=-1) for g, r in zip(whole, ref)]
                      ).amax(dim=0) > TOL_CROSS
    unexcused = off & ~excused
    gaps_off = z_gap[off & ~selection_differs]
    gaps_excused = z_gap[off & excused & ~selection_differs]
    summary = {"rays": len(pix), "tol": TOL_CROSS, "lod": list(LOD),
               "max_z_gap": LOD_CROSS_MAX_Z_GAP, "max_off_share": LOD_CROSS_MAX_OFF_SHARE,
               "same_selection_max_err": errs,
               "whole_path_max_err": {k: (g.cpu() - r).abs().max().item()
                                      for k, g, r in zip(names, whole, ref)},
               "whole_path_rays_off": int(off.sum()),
               "rays_off_with_another_selection": int((off & selection_differs).sum()),
               "rays_off_excused_by_z_gap": int((off & excused & ~selection_differs).sum()),
               "largest_z_gap_excused": gaps_excused.max().item() if len(gaps_excused) else 0.0,
               "z_gaps_of_rays_off_same_selection": gaps_off.tolist(),
               "rays_off_unexcused": int(unexcused.sum()),
               "rays_with_other_samples": int((z_gap > 0).sum()),
               "rays_by_z_gap": {"0": int((z_gap == 0).sum()),
                                 "<=1e-7": int(((z_gap > 0) & (z_gap <= 1e-7)).sum()),
                                 "<=1e-6": int(((z_gap > 1e-7) & (z_gap <= 1e-6)).sum()),
                                 "<=1e-5": int(((z_gap > 1e-6) & (z_gap <= 1e-5)).sum()),
                                 ">1e-5": int((z_gap > 1e-5).sum())},
               "largest_finite_z_gap": z_gap[torch.isfinite(z_gap)].max().item(),
               "rays_with_another_selection": int(selection_differs.sum()),
               "mean_alpha": ref[2].mean().item(), "cpu_s": cpu_s}
    print(json.dumps({"lod_cross_check": summary}), flush=True)
    for k, v in errs.items():
        if not v <= TOL_CROSS:
            fail(f"LOD cross-check {k}: card vs CPU on the same selection {v:.3e} above "
                 f"{TOL_CROSS:.0e}")
    if unexcused.any():
        fail(f"LOD cross-check: {int(unexcused.sum())} rays differ by more than "
             f"{TOL_CROSS:.0e} although card and CPU selected the same samples, placed no "
             f"more than {LOD_CROSS_MAX_Z_GAP:g} apart or exactly alike")
    if off.float().mean().item() > LOD_CROSS_MAX_OFF_SHARE:
        fail(f"LOD cross-check: {int(off.sum())} of {len(pix)} rays differ by more than "
             f"{TOL_CROSS:.0e} (at most {LOD_CROSS_MAX_OFF_SHARE:.0%} may)")
    return summary


def hit_ray_train_phase(device, cfg, params, grid, reel):
    """Hit-ray compaction in training, on the sphere scene (params and its
    shell grid, which many rays miss) and the synthetic reel:

    1. one dense step; its hit fraction;
    2. a late-compaction step (``hit_ray_compact_early=False``) whose bucket
       holds every hit ray, on the dense step's draws, and an
       early-compaction step (the default) on the same draws with the
       importance jitter zero (its shape follows the bucket) beside a dense
       step with it zero: each loss within TOL_HIT_LOSS relative of its dense
       step's and every leaf's gradient within TOL_GRAD_CROSS (relative L2:
       F adds in atomic order). All without the curvature term, whose random
       tangents pair with the i-th evaluated sample, which the compaction
       renumbers (JAX's own exactness test turns it off too);
    3. TRAIN_STEPS steps of ``train`` resumed at LOD_TRAIN_FROM (a window
       that holds a rebalancer point, iteration % 50 == 0) with
       ``hit_ray_frac = _hit_frac_bucket(measured, 1.0)`` (early
       compaction; where that rung is 1.0, compaction off, the smallest
       rung that holds the batch's hits), beside the same window without
       compaction: ms/step over the whole window and apart before and after
       the rebalancer point (which may switch the compaction off), the
       settled fraction, H1/H2 launches per step. Returns a summary."""
    import dataclasses

    import torch

    from permuto_sdf_tpu_torch.models.fields import init_colorcal
    from permuto_sdf_tpu_torch.train import checkpoint as ckpt
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps
    from permuto_sdf_tpu_torch.train.optimizers import tree_leaves

    params = {**params, "colorcal": init_colorcal(reel.nr_images, device)}  # one per view
    it = cfg.nr_iter_sphere_fit + LOD_TRAIN_FROM
    cfg_nc = dataclasses.replace(cfg, enable_curvature=False)
    draws = tps.draw_train_step(tps.step_generators(SEED, it)[0], cfg_nc, reel)
    loss_d, aux_d, grads_d = tps.compute_loss_and_grads(params, grid, reel, draws, it, cfg_nc)
    hits = int(aux_d["nr_hit_rays"])
    hit_frac = hits / cfg.nr_rays
    ladder_frac = frac = tps._hit_frac_bucket(hit_frac, 1.0)
    if not frac < 1.0:
        # the ladder wants 1.3x headroom; take the smallest rung that holds
        # this batch's hits (the rebalancer may then move it back up)
        rungs = [f for f in tps._HIT_FRAC_LADDER
                 if f < 1.0 and tps._hit_ray_budget(cfg.nr_rays, f) >= hits]
        if not rungs:
            fail(f"hit-ray phase: hit fraction {hit_frac:.3f} leaves no room for compaction")
        frac = rungs[0]
    if tps._hit_ray_budget(cfg.nr_rays, frac) < hits:
        fail("hit-ray phase: the bucket does not hold every hit ray")

    def against_dense(mode, step_draws, dense):
        """A compacted step of ``mode`` on ``step_draws`` against the dense
        step ``dense`` = (loss, grads) -> (loss rel err, worst leaf rel L2)."""
        mode_cfg = dataclasses.replace(cfg_nc, hit_ray_frac=frac,
                                       hit_ray_compact_early=mode == "early")
        loss_c, _, grads_c = tps.compute_loss_and_grads(params, grid, reel, step_draws, it,
                                                        mode_cfg)
        loss_err = abs(float(loss_c) - float(dense[0])) / abs(float(dense[0]))
        grad_err = {}
        for k, (a, b) in enumerate(zip(tree_leaves(grads_c), tree_leaves(dense[1]))):
            if a is None or b is None:
                if (a is None) != (b is None):
                    fail(f"hit-ray phase ({mode}): leaf {k} has a gradient on one path only")
                continue
            norm = b.norm().item()
            grad_err[k] = (a - b).norm().item() / norm if norm > 0 else (a - b).norm().item()
        worst = max(grad_err.values())
        print(f"[hit rays] {mode}-compacted step vs dense: loss {float(loss_c):.7f} vs "
              f"{float(dense[0]):.7f} (rel {loss_err:.2e}), worst leaf gradient rel L2 "
              f"{worst:.2e}", flush=True)
        if not loss_err <= TOL_HIT_LOSS:
            fail(f"hit-ray phase: {mode}-compacted loss off by {loss_err:.2e} relative")
        if not worst <= TOL_GRAD_CROSS:
            fail(f"hit-ray phase: an {mode}-compacted gradient is off by {worst:.2e} (rel L2)")
        return loss_err, worst

    print(f"[hit rays] dense step: {hits} of {cfg.nr_rays} rays hit ({hit_frac:.3f}); bucket "
          f"fraction {frac} ({tps._hit_ray_budget(cfg.nr_rays, frac)} rays; the ladder's rung "
          f"for this fraction: {ladder_frac})", flush=True)
    gates = {"late": against_dense("late", draws, (loss_d, grads_d))}

    def zero_jitter(rays):
        n = cfg.nr_samples_imp_sampling
        return dataclasses.replace(draws, imp_jitter=(torch.zeros(rays, n), torch.zeros(rays, n)))

    loss_dn, _, grads_dn = tps.compute_loss_and_grads(params, grid, reel,
                                                      zero_jitter(cfg.nr_rays), it, cfg_nc)
    gates["early"] = against_dense("early", zero_jitter(tps._hit_ray_budget(cfg.nr_rays, frac)),
                                   (loss_dn, grads_dn))

    runs = {}
    optimizer = tps.make_optimizer(cfg)
    hit_cfg = dataclasses.replace(cfg, hit_ray_frac=frac)
    rebalance_it = (it + 1 + 49) // 50 * 50  # the window's rebalancer point
    for label, run_cfg in (("dense", cfg), ("hit_rays", hit_cfg), ("dense_again", cfg)):
        times, fracs, rays, iters = [], [], [], []

        def on_step(i, loss, aux, params_, grid_):
            torch.cuda.synchronize(device)
            times.append(time.perf_counter())
            if not math.isfinite(float(loss)):
                fail(f"hit-ray train ({label}): non-finite loss at iteration {i}")
            fracs.append(aux.get("hit_ray_frac"))
            rays.append(aux.get("nr_rays"))
            iters.append(i)

        with tempfile.TemporaryDirectory() as d:
            g = tps.og.OccupancyGridState(values=grid.values.clone(),
                                          occupancy=grid.occupancy.clone())
            tps._save(d, "chip_smoke", it, params, g, opt_state=optimizer.init(params),
                      cfg=run_cfg, last_inv_s=INV_S_TRAINED)
            torch.cuda.synchronize(device)
            reset_counts()
            times.append(time.perf_counter())
            tps.train(reel, run_cfg, nr_iters=it + 1 + TRAIN_STEPS,
                      resume_from=ckpt.models_dir(d, "chip_smoke", it), log_every=1,
                      callbacks=[on_step], device=device)
            counts = read_counts()
        _check_copies(f"hit-ray train ({label})", counts, params, len(times) - 1)
        steps = [(b - a) * 1e3 for a, b in zip(times[:-1], times[1:])][WARMUP_STEPS:]
        med = statistics.median(steps)
        # the steps up to the rebalancer point ran at the starting fraction
        # and ray count; after it both may differ
        parts = {}
        for part, keep in (("before", lambda i: i <= rebalance_it),
                           ("after", lambda i: i > rebalance_it)):
            sel = [(t, f, r) for t, f, r, i in zip(steps, fracs[WARMUP_STEPS:],
                                                   rays[WARMUP_STEPS:], iters[WARMUP_STEPS:])
                   if keep(i)]
            if sel:
                parts[part] = {"steps": len(sel),
                               "ms_per_step_median": statistics.median(t for t, _, _ in sel),
                               "ms_per_step_min": min(t for t, _, _ in sel),
                               "ms_per_step_max": max(t for t, _, _ in sel),
                               "hit_ray_fracs": sorted({f for _, f, _ in sel}, key=str),
                               "nr_rays": sorted({r for _, _, r in sel})}
        runs[label] = {"first_iter": it + 1, "steps": TRAIN_STEPS, "warmup_steps": WARMUP_STEPS,
                       "ms_per_step_median": med, "ms_per_step_min": min(steps),
                       "ms_per_step_max": max(steps), "ms_per_step_all": steps,
                       "rebalance_iter": rebalance_it, "by_rebalance": parts,
                       "hit_ray_frac_per_step": fracs, "nr_rays_per_step": rays,
                       "launches_per_step": {k: counts[k] / TRAIN_STEPS
                                             for k in TRAIN_KERNELS + ("H0", "H1", "H2")},
                       "launches": counts}
        split = "; ".join(f"{k} the rebalancer point {rebalance_it}: {v['steps']} steps, median "
                          f"{v['ms_per_step_median']:.1f} ms/step at hit_ray_frac "
                          f"{v['hit_ray_fracs']}, nr_rays {v['nr_rays']}"
                          for k, v in parts.items())
        print(f"[hit rays] train {label}: {TRAIN_STEPS} steps from {it + 1}: median {med:.1f} "
              f"ms/step (min {min(steps):.1f}, max {max(steps):.1f}); {split}; H1/H2 per step "
              f"{counts['H1'] / TRAIN_STEPS:.2f}/{counts['H2'] / TRAIN_STEPS:.2f}", flush=True)
    if not (runs["hit_rays"]["launches"]["H1"] > 0 and runs["hit_rays"]["launches"]["H2"] > 0):
        fail("hit-ray train: kernels H1/H2 were not launched")
    return {"hit_fraction": hit_frac, "hits": hits, "nr_rays": cfg.nr_rays,
            "bucket_frac": frac, "ladder_frac": ladder_frac,
            "late_vs_dense_loss_rel_err": gates["late"][0],
            "late_vs_dense_worst_grad_rel_l2": gates["late"][1],
            "early_vs_dense_no_imp_jitter_loss_rel_err": gates["early"][0],
            "early_vs_dense_no_imp_jitter_worst_grad_rel_l2": gates["early"][1],
            "tol_loss": TOL_HIT_LOSS,
            "tol_grad": TOL_GRAD_CROSS, "settled_hit_ray_frac": runs["hit_rays"][
                "hit_ray_frac_per_step"][-1], "runs": runs}


# ---------------------------------------------------------------------------
# Slice 5: the recommended training profile (train-time LOD, alternating-level
# table gradients, the lever gate)
# ---------------------------------------------------------------------------

# bench.py:115-131, the JAX package's recommended training profile
LEVER_PROFILE = dict(train_lod_top_k=24, train_lod_rand_extra=8, table_grad_alternate=True,
                     hit_ray_frac=1.0)
LEVER_GATE_LEAD = 12  # steps of the lever window before the AUTO gate
LEVER_EXPLICIT_LEAD = 6  # steps before the explicit gate of the sphere-scene window
TOL_L_COS = 1e-6  # cos_fd: the same float operations, relative to max(|cos|, 1)
# Kernel L's ranking weights come from a warp-scan product, the plain
# version's from torch.cumprod on the card (another association): a ray's
# top-K may differ only by slots whose weights agree to this relative
# tolerance (a tie under rounding); its extras must then agree exactly
# whenever its top-K sets do.
TOL_L_TIE = 1e-6
# L's function per slot: the fd cos (2), the NeuS alpha (~45, as D) and the
# scan (~3); per slot and selection (the top-K, then the extras), a linear-time
# selection's ~4 compares and moves (not the kernel's own O(S^2) rank count).
OPS_PER_SAMPLE_L = 50
OPS_PER_SLOT_SELECT = 4
OPS_PER_FINE_ROW_D2 = 12  # the cos dot product and the weighted sums
OPS_PER_FINE_ROW_D2B = 20  # the cos dot product, the cotangent terms and outputs


def _lever_cfg(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **dict(LEVER_PROFILE, **kw))


def lever_kernel_phases(device, cfg, params, grid, reel, reps=20, plain_reps=3):
    """Kernels L, D2 and D2' against their plain versions on one step of the
    recommended profile past its gate (the trained params and grid, the
    step's draws: R = nr_rays, S = 96, K + E = 24 + 8; the fine set's sdf,
    gradient and rgb from the full-width fields, random cotangents), and F
    and G with alternating-level table gradients (phase 0 and 1 of period
    2) at the fine set's size against the same kernels without parity:
    frozen levels exactly zero, active ones within TOL_F / TOL_G per level.
    Returns ({kernel: numbers}, {"F": ..., "G": ...} of the parity runs)."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import random_rays_from_reel
    from permuto_sdf_tpu_torch.models.fields import rgb_apply, sdf_with_gradient
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    lcfg = _lever_cfg(cfg, table_grad_alternate=False)
    it = cfg.nr_iter_sphere_fit + cfg.forced_variance_finish_iter + 100
    ita = it - cfg.nr_iter_sphere_fit
    draws = tps.draw_train_step(tps.step_generators(SEED, it)[0], lcfg, reel).to(device)
    o, d, _, _, _ = random_rays_from_reel(reel, lcfg.nr_rays, indices=draws.ray_indices)
    with torch.no_grad():
        smp = tps._create_fg_samples(params, grid, o, d, ita, lcfg, draws)[0]
    R, S = smp.mask.shape
    K, E = tps._train_lod(lcfg)
    car = tps._map_range_f32(ita, 0.0, cfg.forced_variance_finish_iter, 0.0, 1.0)
    inv_s = vr.variance_inv_s(params["variance"], tps._map_range_f32(
        ita, 0.0, cfg.forced_variance_finish_iter, 0.3, cfg.forced_variance_finish))
    results = {}

    # --- L: fd cos, ranking weights, the top-K and the random extras
    args = (smp, smp.sdf, inv_s, car, draws.lod_scores, K, E)
    cos_k, sel_k = vr.train_lod_select_cuda(*args)
    cos_p, sel_p = vr.train_lod_select_plain(*args)
    cos_err = ((cos_k - cos_p).abs() / cos_p.abs().clamp(min=1.0)).max().item()
    if not cos_err <= TOL_L_COS:
        fail(f"kernel L: cos_fd off by {cos_err:.3e} relative")
    w = vr.neus_compute_weights_from_cos(smp, smp.sdf, cos_p, inv_s, car)[0]
    rank = torch.where(smp.mask, w, torch.full_like(w, -1.0))
    top_k = rank.gather(1, sel_k[:, :K]).sort(dim=1, descending=True).values
    top_p = rank.gather(1, sel_p[:, :K])
    diff = (sel_k != sel_p).any(dim=1)
    tie = diff & torch.isclose(top_k, top_p, rtol=TOL_L_TIE, atol=0.0).all(dim=1)
    same_top = (sel_k[:, :K].sort(dim=1).values == sel_p[:, :K].sort(dim=1).values).all(dim=1)
    bad = (diff & ~tie) | (same_top & (sel_k[:, K:] != sel_p[:, K:]).any(dim=1))
    if bad.any():
        fail(f"kernel L: the selection differs from the plain version on {int(bad.sum())} rays "
             f"beyond ties under rounding")
    n_tie = int(tie.sum())
    # sel at 4 B an entry: the function's slot ids fit int32 (JAX's top_k)
    nb = R * S * (4 + 4 + 1 + 4) + R * S * 4 + R * (K + E) * 4
    ops = R * S * (OPS_PER_SAMPLE_L + OPS_PER_SLOT_SELECT * (2 if E else 1))
    b = bound_ms(nb, ops)
    ms = time_ms(lambda: vr.train_lod_select_cuda(*args), reps, device)
    pms = time_ms(lambda: vr.train_lod_select_plain(*args), plain_reps, device)
    _report(f"L R={R} S={S} K={K} E={E} ({int(smp.mask.sum())} valid samples; sel exact on "
            f"{R - int(diff.sum())} rays, a tie under rounding on {n_tie}; cos_fd relative)",
            cos_err, TOL_L_COS, ms, pms, b)
    dms = device_ms(lambda: vr.train_lod_select_cuda(*args), "L", device,
                    per_launch=True)
    results["L"] = dict(max_abs_err=(cos_k - cos_p).abs().max().item(), ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                        sel_rays_exact=R - int(diff.sum()), sel_rays_tied=n_tie, device_ms=dms)

    # --- D2 and D2': the mixed chain on the fine set's full-width fields, and
    # on the same rays with a planted surface (carried and fine sdf uniform in
    # +-0.01, as D''s check: every alpha away from its clip)
    fine = (torch.arange(R, device=device)[:, None] * S + sel_p).reshape(-1)
    pos_c, dirs_c = smp.flat_positions()[fine], smp.flat_dirs()[fine]
    with torch.no_grad():
        sdf_c, grads_c, geom_c = sdf_with_gradient(params["sdf"], pos_c, ita, lcfg.sdf_model)
        rgb_c = rgb_apply(params["rgb"], pos_c, dirs_c, grads_c, geom_c, ita, lcfg.rgb_model)
    KE = K + E
    rng = np.random.default_rng(SEED + 6)
    margs = (smp, smp.sdf, cos_p, sel_p, sdf_c, grads_c, rgb_c, inv_s, car)
    planted = torch.from_numpy(rng.uniform(-0.01, 0.01, (R, S)).astype(np.float32)).to(device)
    cos_q, sel_q = vr.train_lod_select_plain(smp, planted, inv_s, car, draws.lod_scores, K, E)
    fine_q = (torch.arange(R, device=device)[:, None] * S + sel_q).reshape(-1)
    margs_q = (smp, planted, cos_q, sel_q, planted.reshape(-1)[fine_q][:, None], grads_c, rgb_c,
               inv_s, car)
    err = 0.0
    for a_ in (margs, margs_q):
        got, want = vr.neus_render_mixed_cuda(*a_), vr.neus_render_mixed_plain(*a_)
        err = max([err] + [(a - b_.reshape(a.shape)).abs().max().item()
                           for a, b_ in zip(got, want)])
    nb_in = R * S * (4 + 4 + 4 + 1) + R * KE * (4 + 4 + 12 + 12) + R * 12
    nb = nb_in + R * S * 4 + R * (4 + 4 + 12 + 12)
    b = bound_ms(nb, R * S * OPS_PER_SAMPLE_D + R * KE * OPS_PER_FINE_ROW_D2)
    ms = time_ms(lambda: vr.neus_render_mixed_cuda(*margs), reps, device)
    pms = time_ms(lambda: vr.neus_render_mixed_plain(*margs), plain_reps, device)
    _report(f"D2 R={R} S={S} K+E={KE} (mixed chain; the step's sdf and a planted one)", err,
            TOL_D, ms, pms, b)
    dms = device_ms(lambda: vr.neus_render_mixed_cuda(*margs), "D2", device,
                    per_launch=True)
    results["D2"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                         device_ms=dms)
    cots = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
            for shape in ((R, S), (R, 1), (R,), (R, 3), (R, 3))]
    err = abs_err = 0.0
    for a_ in (margs, margs_q):
        got = vr.neus_render_mixed_bwd_cuda(*a_, *cots)
        want = vr.neus_render_mixed_bwd_plain(*a_, *cots)
        for a, b_ in zip(got, want):
            diff = (a - b_.reshape(a.shape)).abs().max().item()
            scale = b_.abs().max().item()
            err = max(err, diff / scale if scale > 0 else diff)
            abs_err = max(abs_err, diff)
    nb = nb_in + R * S * 4 + R * (4 + 4 + 12 + 12) + R * KE * (4 + 12 + 12)
    b = bound_ms(nb, R * S * OPS_PER_SAMPLE_DB + R * KE * OPS_PER_FINE_ROW_D2B)
    ms = time_ms(lambda: vr.neus_render_mixed_bwd_cuda(*margs, *cots), reps, device)
    pms = time_ms(lambda: vr.neus_render_mixed_bwd_plain(*margs, *cots), plain_reps, device)
    _report(f"D2' R={R} S={S} K+E={KE} (relative; the step's sdf and a planted one)", err,
            TOL_DB, ms, pms, b)
    dms = device_ms(lambda: vr.neus_render_mixed_bwd_cuda(*margs, *cots), "D2'", device,
                    per_launch=True)
    results["D2'"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=pms, bound_ms=b[0],
                          bound_by=b[1], device_ms=dms)

    # --- F and G with alternating-level table gradients at the fine set's size
    L = cfg.nr_levels
    n = R * KE
    spec = pe.PermutoEncodingSpec(pos_dim=3, capacity=cfg.capacity, nr_levels=L,
                                  concat_points_scaling=1e-3)
    gen = torch.Generator().manual_seed(SEED + 6)
    prm = pe.init_encoding_params(gen, spec, device)
    prm["lattice_values"] *= 1e3
    scales, E_mat, _ = pe.encoding_constants(spec, None, device)
    pts = torch.from_numpy(rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(n, 2 * L + 3)).astype(np.float32)).to(device)
    u = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(device)
    window = torch.ones(L, device=device)
    base = (pts, prm["lattice_values"], prm["shift_per_level"], scales, window, E_mat, L)
    parity = {}
    for name, tol in (("F", TOL_F), ("G", TOL_G)):
        def run(lv, name=name, fns=(pe.encode_table_grad_cuda, pe.encode_double_backward_cuda)):
            if name == "F":
                return fns[0](*base, g, lv)
            return fns[1](*base, 1e-3, True, g, u, lv)[0]

        def plain(lv, name=name):
            return run(lv, name, (pe.encode_table_grad_plain, pe.encode_double_backward_plain))

        full = run((0, 1))
        err = 0.0
        for phase in (0, 1):
            got, want = run((phase, 2)), plain((phase, 2))
            frozen = [lv for lv in range(L) if lv % 2 != phase]
            active = [lv for lv in range(L) if lv % 2 == phase]
            if got[frozen].abs().max().item() != 0.0 or want[frozen].abs().max().item() != 0.0:
                fail(f"kernel {name} with parity {phase}: a frozen level's gradient is not zero")
            err = max(err, _level_err(got[active], full[active]),
                      _level_err(got[active], want[active]))
        ms_p = time_ms(lambda: run((0, 2)), reps, device)
        ms_f = time_ms(lambda: run((0, 1)), reps, device)
        pms = time_ms(lambda: plain((0, 2)), plain_reps, device)
        per_level = OPS_PER_POINT_LEVEL_F if name == "F" else OPS_PER_POINT_LEVEL_G
        nb = n * 12 + n * (2 * L + 3) * 4 + (n * 12 if name == "G" else 0) + full.numel() * 4
        b = bound_ms(nb, per_level * n * L // 2)
        _report(f"{name} parity N={n} K={L} period 2 (per level, relative; every level: "
                f"{ms_f:.4f} ms)", err, tol, ms_p, pms, b)
        parity[name] = dict(max_err_per_level=err, ms=ms_p, ms_every_level=ms_f, plain_ms=pms,
                            bound_ms=b[0], bound_by=b[1], n=n)
    return results, parity


def _train_window(device, label, run_cfg, params, grid, reel, start, steps):
    """``train`` resumed at ``start`` for ``steps`` steps with the launch
    counts reset before and read after, and read after every step too.
    Returns (params, the run's summary)."""
    import torch

    from permuto_sdf_tpu_torch.train import checkpoint as ckpt
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    before = {k: [t.clone() for t in v] for k, v in _param_groups(params).items()}
    times, per_step = [], []
    last = {}

    def on_step(i, loss, aux, params_, grid_):
        torch.cuda.synchronize(device)
        times.append(time.perf_counter())
        if not math.isfinite(float(loss)):
            fail(f"train window ({label}): non-finite loss at iteration {i}")
        now = read_counts()
        per_step.append({"it": i, "nr_samples": float(aux["nr_samples"]),
                         "lod": aux.get("train_lod_top_k"),
                         "parity": aux.get("table_grad_parity"),
                         "hit_ray_frac": aux.get("hit_ray_frac"),
                         "launches": {k: now[k] - last.get(k, 0) for k in now}})
        last.update(now)

    optimizer = tps.make_optimizer(run_cfg)
    with tempfile.TemporaryDirectory() as dd:
        g = tps.og.OccupancyGridState(values=grid.values.clone(), occupancy=grid.occupancy.clone())
        tps._save(dd, "chip_smoke", start, params, g, opt_state=optimizer.init(params),
                  cfg=run_cfg, last_inv_s=INV_S_TRAINED)
        torch.cuda.synchronize(device)
        reset_counts()
        times.append(time.perf_counter())
        new_params, _, _ = tps.train(reel, run_cfg, nr_iters=start + 1 + steps,
                                     resume_from=ckpt.models_dir(dd, "chip_smoke", start),
                                     log_every=1, callbacks=[on_step], device=device)
        counts = read_counts()
    for name, old in before.items():
        new = _param_groups(new_params)[name]
        if not all(torch.isfinite(t).all() for t in new):
            fail(f"train window ({label}): parameter group {name} is not finite")
        if all(torch.equal(a, b) for a, b in zip(old, new)):
            fail(f"train window ({label}): parameter group {name} did not change")
    ms = [(b - a) * 1e3 for a, b in zip(times[:-1], times[1:])]
    _check_copies(f"train window ({label})", counts, new_params, len(ms))
    for rec, t in zip(per_step, ms):
        rec["ms"] = t
    return new_params, {"first_iter": start + 1, "steps": steps, "per_step": per_step,
                        "launches": counts}


LEVER_WINDOW_KERNELS = ("A", "B", "D", "D'", "E1", "E2", "F", "G", "L", "D2", "D2'", "H1",
                        "H2")


def _check_importance_launches(label, run):
    """Each step of a ``_train_window`` run: the importance stage is E1 and
    one E2 (form c), or with the train-time LOD, which carries the second
    round's sdf, E1 and two E2 (forms b and a)."""
    for rec in run["per_step"]:
        got = (rec["launches"]["E1"], rec["launches"]["E2"])
        want = (1, 2 if rec["lod"] is not None else 1)
        if got != want:
            fail(f"train window ({label}): iteration {rec['it']} launched E1/E2 {got}, "
                 f"expected {want}")


def _split_at(run, gate_it, kernels_=LEVER_WINDOW_KERNELS):
    """ms/step and launches/step of a window before and after ``gate_it``
    (the first WARMUP_STEPS steps of the window left out of the times)."""
    out = {}
    for part, keep in (("before", lambda i: i < gate_it), ("after", lambda i: i >= gate_it)):
        recs = [r for r in run["per_step"] if keep(r["it"])]
        if not recs:
            continue
        timed = [r["ms"] for r in recs[WARMUP_STEPS if part == "before" else 0:]] or [
            r["ms"] for r in recs]
        out[part] = {"steps": len(recs), "ms_per_step_median": statistics.median(timed),
                     "ms_per_step_min": min(timed), "ms_per_step_max": max(timed),
                     "launches_per_step": {k: sum(r["launches"][k] for r in recs) / len(recs)
                                           for k in kernels_}}
    return out


def lever_train_phase(device, cfg, params, grid, reel, sphere_params, sphere_grid, hit_frac):
    """The recommended profile through ``train``:

    1. on the training scene (the params and grid of the training phase),
       LEVER_PROFILE with the AUTO gate (forced_variance_finish_iter), resumed
       LEVER_GATE_LEAD steps before the gate for TRAIN_STEPS steps, beside
       the reference profile (no levers) over the same iterations, before and
       after it: ms/step and launches per step; the levers off before the
       gate and on after it (the step cfg's LOD and parity it % 2); L, D2
       and D2' once per step from the gate on and never before;
    2. on the sphere scene (a shell grid that about half the rays miss) with
       an explicit ``lever_start_iter`` LEVER_EXPLICIT_LEAD steps into the
       window and hit-ray compaction at ``hit_frac``: the levers switch on at
       the explicit gate, and L, D2, D2', H1 and H2 launch.
    Every loss finite and every parameter group moved. Returns a summary."""
    import dataclasses

    from permuto_sdf_tpu_torch.models.fields import init_colorcal

    gate_it = cfg.nr_iter_sphere_fit + cfg.forced_variance_finish_iter
    start = gate_it - LEVER_GATE_LEAD - 1
    lever_cfg = _lever_cfg(cfg)
    runs = {}
    for label, run_cfg in (("reference", cfg), ("levers", lever_cfg), ("reference_again", cfg)):
        _, run = _train_window(device, label, run_cfg, params, grid, reel, start, TRAIN_STEPS)
        _check_importance_launches(label, run)
        run["by_gate"] = _split_at(run, gate_it)
        runs[label] = run
        parts = "; ".join(f"{k} the gate: {v['steps']} steps, median {v['ms_per_step_median']:.1f}"
                          f" ms/step, launches/step {v['launches_per_step']}"
                          for k, v in run["by_gate"].items())
        print(f"[levers] {label}: {TRAIN_STEPS} steps from {start + 1} (AUTO gate at {gate_it}): "
              f"{parts}", flush=True)
    for rec in runs["levers"]["per_step"]:
        on = rec["it"] >= gate_it
        want = (LEVER_PROFILE["train_lod_top_k"], rec["it"] % cfg.table_grad_period) if on else (
            None, None)
        if (rec["lod"], rec["parity"]) != want:
            fail(f"lever train: iteration {rec['it']} ran LOD {rec['lod']} parity "
                 f"{rec['parity']}, expected {want}")
        per = [rec["launches"][k] for k in ("L", "D2", "D2'")]
        if per != ([1, 1, 1] if on else [0, 0, 0]):
            fail(f"lever train: iteration {rec['it']} launched L/D2/D2' {per}")
    for label in ("reference", "reference_again"):
        if any(runs[label]["launches"][k] for k in ("L", "D2", "D2'")):
            fail(f"lever train: the {label} run launched a lever kernel")

    # the sphere scene: an explicit gate and hit-ray compaction
    sp = {**sphere_params, "colorcal": init_colorcal(reel.nr_images, device)}
    start_s = cfg.nr_iter_sphere_fit + LOD_TRAIN_FROM
    explicit = LOD_TRAIN_FROM + 1 + LEVER_EXPLICIT_LEAD
    hit_cfg = _lever_cfg(cfg, hit_ray_frac=hit_frac, lever_start_iter=explicit)
    _, run = _train_window(device, "levers_hit_rays", hit_cfg, sp, sphere_grid, reel, start_s,
                           TRAIN_STEPS)
    _check_importance_launches("levers_hit_rays", run)
    gate_s = cfg.nr_iter_sphere_fit + explicit
    run["by_gate"] = _split_at(run, gate_s)
    run["gate_iter"], run["hit_ray_frac_start"] = gate_s, hit_frac
    runs["levers_hit_rays"] = run
    for rec in run["per_step"]:
        if (rec["lod"] is not None) != (rec["it"] >= gate_s):
            fail(f"lever train (hit rays): iteration {rec['it']} ran LOD {rec['lod']} with the "
                 f"gate at {gate_s}")
    missing = [k for k in ("L", "D2", "D2'", "H1", "H2") if run["launches"][k] <= 0]
    if missing:
        fail(f"lever train (hit rays): kernels {missing} were not launched")
    fracs = sorted({str(r["hit_ray_frac"]) for r in run["per_step"]})
    print(f"[levers] sphere scene, explicit gate at {gate_s}, hit_ray_frac from {hit_frac} "
          f"({fracs}): " + "; ".join(
              f"{k}: {v['steps']} steps, median {v['ms_per_step_median']:.1f} ms/step, "
              f"launches/step {v['launches_per_step']}" for k, v in run["by_gate"].items()),
          flush=True)
    for r in runs.values():
        r["per_step"] = [dict(rr, launches={k: rr["launches"][k] for k in LEVER_WINDOW_KERNELS})
                         for rr in r["per_step"]]
    return {"gate_iter": gate_it, "profile": LEVER_PROFILE, "runs": runs}


# ---------------------------------------------------------------------------
# Slice 6: mesh extraction (kernel M) and the SDF-from-mesh trainer
# ---------------------------------------------------------------------------

MESH_PLANTED_RES = 128  # the planted grid of the kernel phase
MESH_SCENE_RES = 256  # the sphere scene's grid of the kernel phase (its numbers in `kernels`)
MESH_SCENE_LARGE_RES = 512  # ... and a larger one (no plain timing)
MESH_RES = (196, 256, 512)  # extraction resolutions of the slice (196: main's --mc_res)
MESH_PLAIN_RES = (196, 256)  # V and F held against the plain path on the same grid
MESH_M_REPS = 3  # timed calls of M on each extraction's grid, after the first
TOL_M_ULP = 1  # M2's world vertices: fmaf on both sides, so 0 expected; keys and faces exact
SDF_MESH_STEPS = 300  # full-width train_sdf_from_mesh steps
SDF_MESH_SHORT_STEPS = 50  # a shorter run with the same set-up, for ms/step
SDF_MESH_TRAIN_KERNELS = ("A", "B", "F", "G")
TOL_SDF_MESH_LOSS = 1e-5  # one step card vs CPU: the loss (float32 means over 33,000 points)
TOL_SDF_MESH_GRAD = 1e-3  # ... and every leaf's gradient, relative L2
CHAMFER_SAMPLES = 200_000
# operations of kernel M, counted from its body: M1 compares a cube's 8
# corners (8), looks its count up by those bits (1) and adds it into its
# word (1); M2 interpolates an emitted vertex (ids 6, w 4, 3 axes of 4
# each), forms its key (3 axes: widen, scale, round, narrow) and inserts
# it into the weld table (a hash of 3 products and 3 mixes, ~4 probe
# compares)
OPS_PER_CUBE_M1 = 10
OPS_PER_VERTEX_M2 = 22
OPS_PER_KEY_M2 = 12
OPS_PER_INSERT_M2 = 16


def planted_mesh_grid(n, seed=SEED):
    """[n, n, n] float32: a sphere union a grid-aligned plane whose layer
    n // 3 holds exactly the level (0), every value within 1/64 of it
    snapped onto it, eight isolated interior nodes at exactly the level
    (their faces are all degenerate), and eight nodes at -1e-13 beside a
    node at the level (the 1e-12 denominator floor)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h = np.float32(1.0 / (n - 1))
    idx = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    c = np.float32(n - 1) * np.float32([0.55, 0.5, 0.45])
    s = (np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
         - np.float32(0.3 * (n - 1))) * h
    plane = (y - np.float32(n // 3)) * np.float32(1.0 / 16)
    v = np.minimum(s, plane).astype(np.float32)
    v[np.abs(v) < np.float32(1.0 / 64)] = 0.0
    inner = np.argwhere(v < -0.05)
    for i, j, k in inner[rng.choice(len(inner), size=min(8, len(inner)), replace=False)]:
        v[i, j, k] = 0.0
    zeros = np.argwhere(v == 0.0)
    for i, j, k in zeros[rng.choice(len(zeros), size=8, replace=False)]:
        if i + 1 < n:
            v[i + 1, j, k] = np.float32(-1e-13)
    return v


def _ulps(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    import torch

    if a.numel() == 0:
        return 0
    return int((a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64))
               .abs().max())


def _closed_edge_share(F) -> float:
    """Share of the mesh's undirected edges that exactly two faces share."""
    import torch

    if F.shape[0] == 0:
        return float("nan")
    e = torch.cat([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]]).sort(dim=1).values
    _, counts = torch.unique(e, dim=0, return_counts=True)
    return float((counts == 2).float().mean())


def _active_cubes(grid, slab=32) -> int:
    """The cubes with a corner below the level 0 and a corner not below it."""
    import torch

    nx, ny, nz = grid.shape
    n = 0
    for x0 in range(0, nx - 1, slab):
        x1 = min(x0 + slab, nx - 1)
        below = torch.stack([grid[x0 + dx:x1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz] < 0
                             for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
        n += int((below.any(0) & ~below.all(0)).sum())
    return n


def _m2_bound(grid, word_tris, tile_tris, active, T, V, F):
    """M2's bound by the work the function needs: it reads every tile's
    total, the active tiles' offsets and word counts and the active cubes'
    corners, writes a degenerate flag per triangle and the welded mesh (V x
    12 + F x 24 bytes), and touches one table sector (32 bytes) per
    distinct key, V of them. The design's own products, the 3T unwelded
    copies and keys and a table of two slots per emission, are not
    counted. The operations are every emission's position, key and
    insert."""
    import torch

    from permuto_sdf_tpu_torch.ops import marching_cubes as mc

    nx, ny, _ = grid.shape
    _, words, tiles = mc._tiling(grid.shape)
    groups = -(-(ny - 1) // mc._TILE_ROWS)
    rows = torch.tensor([min(mc._TILE_ROWS, ny - 1 - mc._TILE_ROWS * g) for g in range(groups)],
                        device=tile_tris.device).repeat(nx - 1)
    on = tile_tris > 0
    nbytes = (tiles * 4 + int(on.sum()) * 8 + int(rows[on].sum()) * words * 2 + active * 32
              + T + V * 12 + F * 24 + V * 32)
    return bound_ms(nbytes, (OPS_PER_VERTEX_M2 + OPS_PER_KEY_M2 + OPS_PER_INSERT_M2) * 3 * T)


def mesh_kernel_phases(device, cfg, sphere_params, reps=20, plain_reps=2):
    """Kernels M1 and M2 against their plain versions on the planted grid
    (MESH_PLANTED_RES^3) and on the sphere scene's grids (MESH_SCENE_RES^3,
    MESH_SCENE_LARGE_RES^3): M1's word and tile counts and M2's keys,
    degenerate flags and first emissions of each key exactly, its world
    vertices within TOL_M_ULP, the welded V and F of the ranking glue
    (``weld_first``) and of the dispatcher equal to the plain weld's of the
    plain emission; ms per call of M1, M2 (with its table), the ranking
    glue and the whole of M (the host reads the triangle total after M1,
    then M2's overflow flag with the mesh's two counts), each kernel's
    device ms. M2's bound must not exceed the whole of M's.
    Also kernel A and the whole SDF of one 64^3 block of the grid SDF (row
    M0). Returns ({kernel: numbers}, summary)."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.models.fields import sdf_apply
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

    def scene_sdf(pts):
        return sdf_apply(sphere_params["sdf"], pts, ITER, cfg.sdf_model)[0]

    n_p, n_s, n_l = MESH_PLANTED_RES, MESH_SCENE_RES, MESH_SCENE_LARGE_RES
    grids = {"planted": lambda: (torch.from_numpy(planted_mesh_grid(n_p)).to(device),
                                 (-0.5, -0.5, -0.5), (1.0 / (n_p - 1),) * 3),
             "sphere_scene": lambda: (mc.sdf_grid(scene_sdf, n_s, -0.5, 0.5, device=device),
                                      (-0.5, -0.5, -0.5), (1.0 / (n_s - 1),) * 3),
             f"sphere_scene_{n_l}": lambda: (mc.sdf_grid(scene_sdf, n_l, -0.5, 0.5,
                                                         device=device),
                                             (-0.5, -0.5, -0.5), (1.0 / (n_l - 1),) * 3)}
    results, summary = {}, {}
    for label, make in grids.items():
        grid, origin, spacing = make()
        words, tiles = mc.mt_count_cuda(grid, 0.0)
        words_p, tiles_p = mc.mt_count_plain(grid, 0.0)
        m1_err = int((words.to(torch.int32) - words_p.to(torch.int32)).abs().max()) + int(
            (tiles - tiles_p).abs().max())
        offsets, T = mc.mt_offsets(tiles)
        emitted = mc.mt_emit_cuda(grid, 0.0, words, tiles, offsets, T, origin, spacing)
        emitted_p = mc.mt_emit_plain(grid, 0.0, origin, spacing)
        first_p = mc.mt_first_plain(emitted_p[1])
        if emitted[1].shape != emitted_p[1].shape or not torch.equal(emitted[1], emitted_p[1]):
            fail(f"kernel M2:{label}: weld keys differ from the plain version")
        if not torch.equal(emitted[2], emitted_p[2]):
            fail(f"kernel M2:{label}: degenerate flags differ from the plain version")
        if not torch.equal(emitted[3], first_p):
            fail(f"kernel M2:{label}: the first emissions of the keys differ from the plain "
                 f"version's")
        ulps = _ulps(emitted[0], emitted_p[0])
        abs_err = float((emitted[0] - emitted_p[0]).abs().max()) if T else 0.0
        V, F = mc.weld_first(emitted[0], emitted[3], emitted[2], emitted[4])
        Vp, Fp = mc.weld(*emitted_p)
        Vm, Fm = mc.marching_tetrahedra(grid, 0.0, origin, spacing)  # the dispatcher: kernel M
        if not (torch.equal(V, Vp) and torch.equal(F, Fp) and torch.equal(Vm, Vp)
                and torch.equal(Fm, Fp)):
            fail(f"kernel M:{label}: the welded mesh differs from the plain path "
                 f"(V {V.shape[0]} vs {Vp.shape[0]}, F {F.shape[0]} vs {Fp.shape[0]})")
        del emitted_p, first_p, Vp, Fp, Vm, Fm
        used = torch.zeros(V.shape[0], dtype=torch.bool, device=device)
        used[F.reshape(-1)] = True
        active = _active_cubes(grid)
        cubes = (grid.shape[0] - 1) * (grid.shape[1] - 1) * (grid.shape[2] - 1)

        def m1():
            return mc.mt_count_cuda(grid, 0.0)

        def m2():
            return mc.mt_emit_cuda(grid, 0.0, words, tiles, offsets, T, origin, spacing)

        ms1, ms2 = time_ms(m1, reps, device), time_ms(m2, reps, device)
        ms_weld = time_ms(lambda: mc.weld_first(emitted[0], emitted[3], emitted[2], emitted[4]),
                          reps, device)
        ms_m = time_ms(lambda: mc.marching_tetrahedra_cuda(grid, 0.0, origin, spacing), reps,
                       device)
        dms1, dms2 = device_ms(m1, "M1", device), device_ms(m2, "M2", device)
        plain = label != f"sphere_scene_{n_l}"
        pms1 = time_ms(lambda: mc.mt_count_plain(grid, 0.0), plain_reps, device) if plain else None
        pms2 = (time_ms(lambda: mc.mt_emit_plain(grid, 0.0, origin, spacing), plain_reps, device)
                if plain else None)
        pms = (time_ms(lambda: mc.marching_tetrahedra_plain(grid, 0.0, origin, spacing),
                       plain_reps, device) if plain else None)
        E = 3 * T
        b1 = bound_ms(grid.numel() * 4 + words.numel() * 2 + tiles.numel() * 4,
                      OPS_PER_CUBE_M1 * cubes)
        b2 = _m2_bound(grid, words, tiles, active, T, V.shape[0], F.shape[0])
        bm = bound_ms(grid.numel() * 4 + V.shape[0] * 12 + F.shape[0] * 24,
                      OPS_PER_CUBE_M1 * cubes
                      + (OPS_PER_VERTEX_M2 + OPS_PER_KEY_M2 + OPS_PER_INSERT_M2) * E)
        if b2[0] > bm[0]:
            fail(f"kernel M2:{label}: its bound {b2[0]:.4g} ms exceeds the whole of M's "
                 f"{bm[0]:.4g}: it counts bytes the function does not need")
        _report(f"M1:{label} {tuple(grid.shape)} cubes={cubes} active={active}", m1_err, 0,
                ms1, pms1 if plain else float("nan"), b1)
        _report(f"M2:{label} T={T} (world ulps)", ulps, TOL_M_ULP, ms2,
                pms2 if plain else float("nan"), b2)
        summary[label] = {
            "grid": list(grid.shape), "cubes": cubes, "active_cubes": active, "triangles": T,
            "active_tiles": int((tiles > 0).sum()), "tiles": tiles.numel(),
            "active_words": int((words > 0).sum()), "words": words.numel(),
            "table_slots": mc.table_slots(T),
            "degenerate": int(emitted[2].sum()), "V": V.shape[0], "F": F.shape[0],
            "unreferenced_vertices": int((~used).sum()), "world_max_ulps": ulps,
            "world_max_abs_err": abs_err, "m1_ms": ms1, "m2_ms": ms2, "weld_ms": ms_weld,
            "m_ms": ms_m, "m1_device_ms": dms1, "m2_device_ms": dms2,
            "m1_plain_ms": pms1, "m2_plain_ms": pms2, "m_plain_ms": pms,
            "m1_bound_ms": b1[0], "m1_bound_by": b1[1], "m2_bound_ms": b2[0],
            "m2_bound_by": b2[1], "m_bound_ms": bm[0], "m_bound_by": bm[1]}
        print(f"[mesh kernel {label}] {tuple(grid.shape)}: {active} active cubes, T={T} "
              f"({summary[label]['degenerate']} degenerate), V={V.shape[0]} F={F.shape[0]} "
              f"({summary[label]['unreferenced_vertices']} unreferenced), world ulps {ulps}; "
              f"M1 {ms1:.4f} ms (device {dms1}, bound {b1[0]:.4g}), M2 {ms2:.4f} (device "
              f"{dms2}, bound {b2[0]:.4g}), ranking glue {ms_weld:.4f}, M whole {ms_m:.4f} "
              f"(bound {bm[0]:.4g}, {bm[1]}), plain {pms} ms", flush=True)
        if label == "sphere_scene":
            results["M1"] = dict(max_abs_err=float(m1_err), ms=ms1, plain_ms=pms1,
                                 bound_ms=b1[0], bound_by=b1[1], device_ms=dms1)
            results["M2"] = dict(max_abs_err=abs_err, ms=ms2, plain_ms=pms2, bound_ms=b2[0],
                                 bound_by=b2[1], device_ms=dms2)
        if label == "planted" and not (summary[label]["degenerate"] > 0
                                       and summary[label]["unreferenced_vertices"] > 0):
            fail("kernel M: the planted grid reached no degenerate face")
        del emitted, grid

    # row M0: one 64^3 block of the grid SDF (kernel A, then the whole SDF)
    spec = cfg.sdf_model.encoding
    prm = sphere_params["sdf"]["encoding"]
    pts = grid_block_points(device, n_s)
    scales, E_mat, _ = pe.encoding_constants(spec, None, device)
    L = spec.nr_levels
    args = (pts, prm["lattice_values"], prm["shift_per_level"], scales,
            torch.ones(L, device=device), E_mat, L, spec.concat_points_scaling, True)
    got, want = pe.encode_fwd_cuda(*args), pe.encode_fwd_plain(*args)
    a_err = float((got - want).abs().max())
    a_ms = time_ms(lambda: pe.encode_fwd_cuda(*args), reps, device)
    a_pms = time_ms(lambda: pe.encode_fwd_plain(*args), plain_reps, device)
    uniq = torch.unique(pe.flat_slot_ids(pts, prm["lattice_values"], prm["shift_per_level"],
                                         scales, E_mat, L)).numel()
    a_b = bound_ms(pts.numel() * 4 + uniq * 2 * 4 + got.numel() * 4,
                   OPS_PER_POINT_LEVEL_A * pts.shape[0] * L)
    _report(f"A:m0_block N={pts.shape[0]} K={L}", a_err, TOL_A, a_ms, a_pms, a_b)
    with torch.no_grad():
        block_ms = time_ms(lambda: scene_sdf(pts), reps, device)
    summary["m0"] = {"points": pts.shape[0], "a_ms": a_ms, "a_plain_ms": a_pms,
                     "a_bound_ms": a_b[0], "a_bound_by": a_b[1], "a_max_abs_err": a_err,
                     "block_sdf_ms": block_ms}
    print(f"[mesh M0] one 64^3 block ({pts.shape[0]} points): A {a_ms:.4f} ms (bound "
          f"{a_b[0]:.4g}), the block's SDF (A + MLP) {block_ms:.4f} ms", flush=True)
    return results, summary


def sdf_mesh_phase(device, cfg, sphere_params):
    """The slice: ``train_sdf_from_mesh.train`` at full width on the UV
    sphere (SDF_MESH_STEPS steps, after a one-step warm-up), one step card
    against CPU, ``main(["--smoke", "--out_mesh", ...])`` in process, and
    extraction at MESH_RES of the trained field and of the flagship sphere
    scene: ms per mesh split into the grid SDF and M, V and F, the closed
    edge share and Chamfer against the ground-truth sphere mesh; at
    MESH_PLAIN_RES V and F equal the plain path's on the same grid. The
    launches are read in two kinds of window: the SDF_MESH_STEPS-step run
    (per step; A, B, F and G must launch) and each extraction's grid SDF and
    first M call (per mesh; A once per 64^3 block, M1 and M2 once).
    The cross-check step, ``main``, the timing repeats and the plain
    comparisons fall outside them. Returns (summary, the windows' summed
    launches)."""
    import os

    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.datasets.mesh_io import load_obj, make_uv_sphere, sample_points_on_mesh
    from permuto_sdf_tpu_torch.eval.chamfer import point_mesh_chamfer
    from permuto_sdf_tpu_torch.models.fields import sdf_apply
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc
    from permuto_sdf_tpu_torch.ops.ray_primitives import AABB
    from permuto_sdf_tpu_torch.train import train_sdf_from_mesh as tsm
    from permuto_sdf_tpu_torch.train.optimizers import tree_leaves

    gt = make_uv_sphere(radius=0.3)
    tsm.train(gt, nr_iters=1, log_every=1, device=device)  # warm-up (cuBLAS, allocator)
    # ms/step from two runs that share their set-up (the 300,000-point pool
    # sampled on the host, the init): the difference of their wall times;
    # the launches per step from the longer run alone
    walls = {}
    for steps in (SDF_MESH_SHORT_STEPS, SDF_MESH_STEPS):
        torch.cuda.synchronize(device)
        reset_counts()
        t0 = time.perf_counter()
        params, mcfg, hist = tsm.train(gt, nr_iters=steps, log_every=50, seed=SEED,
                                       device=device)
        torch.cuda.synchronize(device)
        walls[steps] = time.perf_counter() - t0
    train_counts = read_counts()
    missing = [k for k in SDF_MESH_TRAIN_KERNELS if train_counts[k] <= 0]
    if missing:
        fail(f"train_sdf_from_mesh.train launched no kernel {missing}")
    _check_copies("train_sdf_from_mesh.train", train_counts, params, SDF_MESH_STEPS)
    per_step = {k: train_counts[k] / SDF_MESH_STEPS for k in SDF_MESH_TRAIN_KERNELS}
    train_s = walls[SDF_MESH_STEPS]
    ms_step = ((walls[SDF_MESH_STEPS] - walls[SDF_MESH_SHORT_STEPS]) * 1e3
               / (SDF_MESH_STEPS - SDF_MESH_SHORT_STEPS))
    pool = sample_points_on_mesh(gt, 300_000, np.random.default_rng(SEED))  # train's pool
    losses = [v for _, v in hist]
    print(f"[sdf_from_mesh] {SDF_MESH_STEPS} full-width steps in {train_s:.2f} s, "
          f"{SDF_MESH_SHORT_STEPS} in {walls[SDF_MESH_SHORT_STEPS]:.2f} s: {ms_step:.2f} "
          f"ms/step, launches per step {per_step}; losses "
          f"{[round(x, 6) for x in losses]}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"sdf_from_mesh: the loss did not fall ({losses})")

    # one step card vs CPU from the trained params, on the same draws
    idx, u = tsm.draw_step(tsm.step_generators(SEED, SDF_MESH_STEPS)[0], 3000, 30000,
                          300_000)
    aabb = AABB()
    lo, hi = torch.tensor(aabb.min_corner), torch.tensor(aabb.max_corner)
    pts, nrm = (torch.from_numpy(a) for a in pool)
    loss_g, grads_g = tsm.loss_and_grads(params, idx, u, pts.to(device), nrm.to(device),
                                         SDF_MESH_STEPS, mcfg, lo.to(device), hi.to(device))
    t0 = time.perf_counter()
    loss_c, grads_c = tsm.loss_and_grads(_tree_map(lambda t: t.detach().cpu(), params), idx, u,
                                         pts, nrm, SDF_MESH_STEPS, mcfg, lo, hi)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_err = {}
    for i, (gg, gc) in enumerate(zip(tree_leaves(grads_g), tree_leaves(grads_c))):
        if gg is None and gc is None:
            continue
        if gg is None or gc is None or not torch.isfinite(gg).all():
            fail(f"sdf_from_mesh cross-check: leaf {i} has a missing or non-finite gradient")
        grad_err[i] = float((gg.cpu() - gc).norm() / gc.norm())
    cross = {"loss_card": float(loss_g), "loss_cpu": float(loss_c), "loss_rel_err": loss_err,
             "grad_rel_l2_err": grad_err, "tol_loss": TOL_SDF_MESH_LOSS,
             "tol_grad": TOL_SDF_MESH_GRAD, "cpu_step_s": cpu_s}
    print(json.dumps({"sdf_from_mesh_cross_check": cross}), flush=True)
    if not loss_err <= TOL_SDF_MESH_LOSS:
        fail(f"sdf_from_mesh cross-check: loss {float(loss_g)} vs {float(loss_c)} on the CPU")
    if not max(grad_err.values()) <= TOL_SDF_MESH_GRAD:
        fail(f"sdf_from_mesh cross-check: gradients off by more than {TOL_SDF_MESH_GRAD}: "
             f"{grad_err}")

    # the module's command line, in process
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "smoke.obj")
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        tsm.main(["--smoke", "--out_mesh", path])
        smoke_s = time.perf_counter() - t0
        smoke_mesh = load_obj(path)
    if not (len(smoke_mesh.F) > 0 and np.isfinite(smoke_mesh.V).all()):
        fail("sdf_from_mesh main --smoke wrote an empty or non-finite mesh")
    smoke = {"seconds": smoke_s, "V": len(smoke_mesh.V), "F": len(smoke_mesh.F)}
    print(f"[sdf_from_mesh] main --smoke --out_mesh: {smoke_s:.2f} s, V={smoke['V']} "
          f"F={smoke['F']}", flush=True)

    fields = {
        "trained": lambda p: sdf_apply(params, p, 9_999_999, mcfg)[0],
        "sphere_scene": lambda p: sdf_apply(sphere_params["sdf"], p, ITER, cfg.sdf_model)[0],
    }
    runs, mesh_counts = [], dict.fromkeys(counters(), 0)
    for name, fn in fields.items():
        for res in MESH_RES:
            spacing = (1.0 / (res - 1),) * 3
            torch.cuda.synchronize(device)
            reset_counts()  # one mesh: the grid SDF, then M
            t0 = time.perf_counter()
            grid = mc.sdf_grid(fn, res, -0.5, 0.5, device=device)
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            V, F = mc.marching_tetrahedra(grid, 0.0, (-0.5,) * 3, spacing)
            torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            c = read_counts()
            blocks = (-(-res // 64)) ** 3  # sdf_grid's 64^3 blocks
            if not (c["A"] == blocks and c["M1"] == c["M2"] == 1 and c["copies"] <= 1):
                fail(f"extraction {name} at {res}: launches A {c['A']} (one per block: "
                     f"{blocks}), M1 {c['M1']}, M2 {c['M2']} (1 each), interleaved-table "
                     f"copies {c['copies']} (at most 1)")
            for k in mesh_counts:
                mesh_counts[k] += c[k]
            m_runs = []  # M again on the same grid: its first call also allocates
            for _ in range(MESH_M_REPS):
                t3 = time.perf_counter()
                mc.marching_tetrahedra(grid, 0.0, (-0.5,) * 3, spacing)
                torch.cuda.synchronize(device)
                m_runs.append((time.perf_counter() - t3) * 1e3)
            m_ms = statistics.median(m_runs)
            run = {"field": name, "res": res, "grid_ms": (t1 - t0) * 1e3, "m_ms": m_ms,
                   "m_first_call_ms": (t2 - t1) * 1e3, "m_ms_all": m_runs,
                   "mesh_ms": (t1 - t0) * 1e3 + m_ms, "V": V.shape[0],
                   "F": F.shape[0], "closed_edge_share": _closed_edge_share(F),
                   "grid_blocks": blocks,
                   "launches_per_mesh": {k: c[k] for k in ("A", "M1", "M2", "copies")}}
            if not (F.shape[0] > 0 and torch.isfinite(V).all()):
                fail(f"extraction {name} at {res}: empty or non-finite mesh")
            if res in MESH_PLAIN_RES:
                Vp, Fp = mc.marching_tetrahedra_plain(grid, 0.0, (-0.5,) * 3, spacing)
                run["world_max_ulps_vs_plain"] = _ulps(V, Vp) if V.shape == Vp.shape else None
                if not (torch.equal(V, Vp) and torch.equal(F, Fp)):
                    fail(f"extraction {name} at {res}: V/F {V.shape[0]}/{F.shape[0]} vs the "
                         f"plain path's {Vp.shape[0]}/{Fp.shape[0]}")
            t0 = time.perf_counter()
            run["chamfer"] = list(point_mesh_chamfer(V.cpu().numpy(), F.cpu().numpy(), gt.V, gt.F,
                                                     nr_samples=CHAMFER_SAMPLES, seed=SEED))
            run["chamfer_s"] = time.perf_counter() - t0
            del grid
            runs.append(run)
            print(f"[extract] {name} {res}^3: {run['mesh_ms']:.1f} ms per mesh (grid SDF "
                  f"{run['grid_ms']:.1f}, M {m_ms:.2f}, median of {MESH_M_REPS}; its first "
                  f"call {run['m_first_call_ms']:.2f}); launches per mesh "
                  f"{run['launches_per_mesh']} ({blocks} blocks); V={run['V']} F={run['F']}, "
                  f"closed edges {run['closed_edge_share']:.5f}, Chamfer vs the sphere "
                  f"{run['chamfer'][0]:.3e} (pred->gt {run['chamfer'][1]:.3e}, gt->pred "
                  f"{run['chamfer'][2]:.3e})", flush=True)
    summary = {"train": {"steps": SDF_MESH_STEPS, "seconds": train_s,
                         "short_run": [SDF_MESH_SHORT_STEPS, walls[SDF_MESH_SHORT_STEPS]],
                         "ms_per_step": ms_step, "loss_history": hist,
                         "launches_per_step": per_step},
               "cross_check": cross, "main_smoke": smoke, "extraction": runs}
    return summary, {k: train_counts[k] + mesh_counts[k] for k in mesh_counts}


# ---------------------------------------------------------------------------
# Slice 7: the plain sphere tracers (C3, J3), sampling without the grid (C2)
# and the NeRF trainer (I2)
# ---------------------------------------------------------------------------

PT_CHUNK = 8192  # render_image_sphere_traced's default chunk
PT_TRACES = 15  # its nr_sphere_traces
PT_FRAMES = 3  # timed plain-traced frames per scene, after one warm-up frame
PT_KERNELS = ("C3", "J3f", "A", "B")  # J0 only when the scene's field is not cached yet
PT_COMPACT_KERNELS = ("C3", "J3f", "H0", "A", "B")
PT_COMPACT_ROUNDS = 5  # render_rays_sphere_traced_compacted's nr_rounds
TOL_C3_ULP = 0  # t_first: the same float operations; has exact
TOL_J3 = 1e-6  # positions: the same float operations (--fmad=false); flags exact
OPS_PER_PROBE = 23  # a probe's t, point and voxel index (as probe_sampler_ops)
C3_SPAN = 16  # the probes one test of C3's pass 1 settles (kSpan, occupancy_grid.cu)
OPS_PER_ROW_J3 = 30  # J3's step, convergence test and the bound sphere's test
# J3f and J2f against their plain versions (the SDF through sdf_apply, then
# J3's or J2's plain version): the encoding is kernel A's bit for bit, but
# the fused MLP sums in order with fmaf where cuBLAS may block its sums, so
# positions (t and sdf for J2f) agree within TOL_FUSED where the flags
# agree. A flag (a convergence or bound test at its edge) may differ, and a
# path may differ where a position at a voxel's edge takes another jump:
# each on at most max(FUSED_MAX_ROWS, FUSED_SHARE of the rows), each such
# row within FUSED_MAX_GAP (2.5 voxels of the 256^3 grid). Set from the
# readings on an H100 80GB HBM3 at 700 W, which had no such row and gaps of
# at most 1.5e-8 (PERF.md, PR 14), with room for a couple of rays at an edge.
TOL_FUSED = 1e-5
FUSED_MAX_ROWS = 2
FUSED_SHARE = 0.0005
FUSED_MAX_GAP = 0.01
OPS_PER_GELU = 15  # tanh and the polynomial
OPS_PER_SAMPLE_C2 = 20  # C2's per-slot count, spacing, z, clip and dt
OPS_PER_RAY_SPHERE = 36  # the bound sphere's intersection of a ray (in C2)
# C2 against its plain version (the same float operations in the same
# order, `--fmad=false`): t_entry and t_exit in ulp, and z, dt,
# ray_fixed_dt, t_entry and t_exit absolute; masks and counts exact
TOL_C2_ULP = 0
TOL_C2 = 0.0
OPS_PER_PROBE_I2 = 3  # I2's decay, max and threshold
OPS_PER_SOFTPLUS = 20  # exp, log1p and the test against 20
# I2f against its plain version (entry 1, nerf_hash_density, I2) and the
# card against the CPU: the encoding is kernel A's bit for bit, but I2f's
# three 64-wide layers are the tensor cores' 3xTF32 products (~22 of
# float32's 24 bits of a product, summed in the tensor cores' order) where
# cuBLAS (the CPU's matmul) sums float32 products in its own blocks, so the
# pre-softplus value moves by float rounding (~1e-6 of its |x| < ~20 on the
# refresh cases' field, which has no cancellation), which the softplus
# turns into ~1e-6 relative: the probed values within TOL_I2F relative; a
# flag may differ only where the threshold lies between the two values, on
# at most max(FUSED_MAX_ROWS, FUSED_SHARE of the probes) voxels.
TOL_I2F = 1e-5
I2F_TABLE_SCALE = 1e3  # the refresh cases' table: a trained table's magnitude
I2F_BIAS_SHIFT = -7.0  # ... and b3[0] moved so that the densities straddle the threshold
NERF_SHORT = 2  # the short run whose time the window's run subtracts
NERF_STEPS = 24  # the NeRF window: 3 grid refreshes (every 8 iterations)
NERF_KERNELS = ("A", "C", "D", "D'", "F", "I2f")
GRIDFREE_KERNELS = ("A", "B", "C2", "D", "D'", "E1", "E2", "F", "G")


def c3_bound(gcfg, occupancy, field, o, d, te, tx, P, rays_per_pass=16384):
    """The least time of kernel C3's work on these rays, given the grid's
    distance field ``field`` (built once per grid state for the tracers, so
    not counted here). A ray that meets the bound needs one probe per
    C3_SPAN-probe span up to the span of its first occupied probe (every
    span without one): the field at the span's start rules the span out
    where its end lies within (distance - 1) voxels on every axis. It also
    needs each probe up to the first occupied one in a span not ruled out:
    only its voxel's byte settles that. Bytes: the rays once, the results
    once, and each field byte and voxel those probes read once. Returns
    (bound_ms's tuple, the counts)."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    v = gcfg.nr_voxels_per_dim
    dev = occupancy.device
    field_read = torch.zeros(v ** 3, dtype=torch.bool, device=dev)
    voxels_read = torch.zeros(v ** 3, dtype=torch.bool, device=dev)
    idx = torch.arange(P, device=dev)
    frac = (idx.to(torch.float32) + 0.5) / float(P)
    starts = torch.arange(0, P, C3_SPAN, device=dev)
    ends = torch.clamp(starts + C3_SPAN, max=P - 1)
    shift = torch.tensor(gcfg.grid_translation, dtype=torch.float32, device=dev)
    span_probes = fine_probes = meets = 0
    for i in range(0, o.shape[0], rays_per_pass):
        oi, di = o[i:i + rays_per_pass], d[i:i + rays_per_pass]
        tei = te[i:i + rays_per_pass].reshape(-1, 1)
        txi = tx[i:i + rays_per_pass].reshape(-1, 1)
        ts = tei + frac[None, :] * (txi - tei)
        pts = oi[:, None, :] + ts[..., None] * di[:, None, :]
        ijk = torch.floor((pts - shift + gcfg.grid_extent / 2.0)
                          / torch.tensor(gcfg.voxel_size, dtype=torch.float32)).to(torch.int64)
        inb = ((ijk >= 0) & (ijk < v)).all(dim=-1)
        c = ijk.clamp(0, v - 1)
        lin = (c[..., 0] * v + c[..., 1]) * v + c[..., 2]
        occ = occupancy[lin] & inb
        first = torch.where(occ.any(dim=-1), torch.argmax(occ.to(torch.uint8), dim=-1), P - 1)
        upto = (idx[None, :] <= first[:, None]) & (txi > tei)
        a_ijk, b_ijk = ijk[:, starts], ijk[:, ends]
        a_in, a_lin = inb[:, starts], lin[:, starts]
        k = field[a_lin].to(torch.int64)
        reach = (b_ijk - a_ijk).abs().amax(dim=-1)
        lo, hi = torch.minimum(a_ijk, b_ijk), torch.maximum(a_ijk, b_ijk)
        touches = ((hi >= 0) & (lo < v)).all(dim=-1)
        flagged = torch.where(a_in, (k == 0) | (reach > k - 1), touches)
        span_upto = upto[:, starts]
        fine = upto & flagged[:, idx // C3_SPAN]
        span_probes += int(span_upto.sum())
        fine_probes += int(fine.sum())
        meets += int((txi > tei).sum())
        field_read[a_lin[span_upto & a_in]] = True
        voxels_read[lin[fine & inb]] = True
        del ts, pts, ijk, inb, c, lin, occ, fine
    R = o.shape[0]
    work = dict(span_probes=span_probes, fine_probes=fine_probes,
                field_bytes=int(field_read.sum()), voxels=int(voxels_read.sum()))
    b = bound_ms(R * 8 * 4 + R * 5 + work["field_bytes"] + work["voxels"],
                 (span_probes + fine_probes) * OPS_PER_PROBE + meets * 6)
    return b, work


def plain_trace_kernel_phases(device, cfg, params, grid, field, reps=20, plain_reps=3):
    """Kernels C3 and J3 against their plain versions on the sphere scene:
    C3 on every ray of the 400x400 view (R = 160,000: the seed of the
    compacted renderer on the whole frame), J3 at one PT_CHUNK-ray chunk of
    ``render_image_sphere_traced`` (the full-state form after the seed and
    the first SDF evaluation; the bucket form, an index list with fill slots,
    the sdf store and the next positions, checked once). J3 is timed from a
    restored copy of the state, the restore's own time subtracted. Returns
    {kernel: numbers}."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    gcfg, P = cfg.grid, 512
    results = {}
    K, tf = camera_k(WIDTH, HEIGHT)
    o, d = rays_from_frame(K, tf, WIDTH, HEIGHT, device=device)
    _, te, _, tx, _ = tps.BOUND.ray_intersection(o, d)
    R = o.shape[0]

    # --- C3: the first occupied probe segment of every ray of the view, on
    # the grid's distance field (the tracers build it once per grid state)
    kc = dict(dist_field=field)
    cargs = (gcfg, grid.occupancy, o, d, te, tx, P)
    got = og.first_occupied_cuda(*cargs, **kc)
    want = og.first_occupied_plain(*cargs)
    if not torch.equal(got[1], want[1]):
        fail(f"kernel C3: has differs on {(got[1] != want[1]).sum().item()} rays")
    ulp = _ulps(got[0], want[0])
    ms = time_ms(lambda: og.first_occupied_cuda(*cargs, **kc), reps, device)
    pms = time_ms(lambda: og.first_occupied_plain(*cargs), plain_reps, device)
    b, work = c3_bound(gcfg, grid.occupancy, field, o, d, te, tx, P)
    _report(f"C3 R={R} P={P} (has {int(want[1].sum())}; {work}; t_first {ulp} ulp)",
            float(ulp), TOL_C3_ULP, ms, pms, b)
    dms = device_ms(lambda: og.first_occupied_cuda(*cargs, **kc), "C3", device)
    results["C3"] = dict(max_abs_err=(got[0] - want[0]).abs().max().item(), ms=ms, plain_ms=pms,
                         bound_ms=b[0], bound_by=b[1], device_ms=dms, work=work)
    # C3 at the plain frame's shape: one PT_CHUNK-ray chunk from the view's middle
    mid = (R // 2 // PT_CHUNK) * PT_CHUNK
    chunk = tuple(t[mid:mid + PT_CHUNK].contiguous() for t in (o, d, te, tx))
    ch = (gcfg, grid.occupancy) + chunk + (P,)
    got, want = og.first_occupied_cuda(*ch, **kc), og.first_occupied_plain(*ch)
    ulp = _ulps(got[0], want[0])
    if not torch.equal(got[1], want[1]) or not ulp <= TOL_C3_ULP:
        fail(f"kernel C3 on a {PT_CHUNK}-ray chunk: has differs on "
             f"{(got[1] != want[1]).sum().item()} rays, t_first {ulp} ulp")
    results["C3"]["chunk_ms"] = time_ms(lambda: og.first_occupied_cuda(*ch, **kc), reps, device)
    results["C3"]["chunk_device_ms"] = device_ms(lambda: og.first_occupied_cuda(*ch, **kc),
                                                 "C3", device)
    b, work = c3_bound(gcfg, grid.occupancy, field, *chunk, P)
    results["C3"]["chunk_bound_ms"], results["C3"]["chunk_work"] = b[0], work
    print(f"[kernel C3:chunk] R={PT_CHUNK} (has {int(want[1].sum())}; {work}; t_first {ulp} "
          f"ulp) ms={results['C3']['chunk_ms']:.4f} device_ms="
          f"{results['C3']['chunk_device_ms']} bound_ms={b[0]:.6f} ({b[1]})", flush=True)
    results["C3"]["grids"], results["C3"]["refresh"] = probe_grid_phases(
        device, gcfg, grid, (o, d, te, tx), chunk, P, reps)

    # --- J3: one iteration of the full-state loop on one chunk
    mid = (R // 2 // PT_CHUNK) * PT_CHUNK
    oc, dc = o[mid:mid + PT_CHUNK].contiguous(), d[mid:mid + PT_CHUNK].contiguous()
    pos, alive, _ = st._plain_seed(oc, dc, tps.BOUND, gcfg, grid, field)
    n = oc.shape[0]
    state0 = {"pos_f": pos.contiguous(), "alive_f": alive.contiguous(),
              "conv_f": torch.zeros_like(alive)}
    with torch.no_grad():
        s_val = tps.sdf_apply(params["sdf"], state0["pos_f"], ITER, cfg.sdf_model)[0].reshape(-1)
    bound = st._sphere_bound(tps.BOUND)
    kw = dict(dist_field=field, grid_cfg=gcfg, sdf_multiplier=0.9, sdf_converged_tresh=2e-4,
              bound=bound)
    ks, ps = ({k: v.clone() for k, v in state0.items()} for _ in range(2))
    st.trace_step_pos_cuda(None, s_val, dc, ks["pos_f"], ks["alive_f"], ks["conv_f"], None, **kw)
    st.trace_step_pos_plain(None, s_val, dc, ps["pos_f"], ps["alive_f"], ps["conv_f"], None, **kw)
    for k in ("alive_f", "conv_f"):
        if not torch.equal(ks[k], ps[k]):
            fail(f"kernel J3: {k} differs on {(ks[k] != ps[k]).sum().item()} rows")
    err = (ks["pos_f"] - ps["pos_f"]).abs().max().item()
    # the bucket form (the compacted tracer's round): rows of the alive
    # list, fill slots, the sdf store and the next positions
    idx, _ = compaction.nonzero_static_plain(state0["alive_f"], n, n)
    bs = [{"pos_f": st._padded(state0["pos_f"]), "alive_f": st._padded(state0["alive_f"], False),
           "conv_f": st._padded(state0["conv_f"], False),
           "sdf_f": torch.zeros(n + 1, device=device)} for _ in range(2)]
    s_b = st._padded(s_val)[idx]
    outs = [fn(idx, s_b, st._padded(dc), b_["pos_f"], b_["alive_f"], b_["conv_f"], b_["sdf_f"], **kw,
               pos_out=True) for fn, b_ in ((st.trace_step_pos_cuda, bs[0]),
                                            (st.trace_step_pos_plain, bs[1]))]
    for k in ("alive_f", "conv_f"):
        if not torch.equal(bs[0][k], bs[1][k]):
            fail(f"kernel J3 (bucket form): {k} differs")
    err = max(err, (bs[0]["pos_f"] - bs[1]["pos_f"]).abs().max().item(),
              (bs[0]["sdf_f"] - bs[1]["sdf_f"]).abs().max().item(),
              (outs[0] - outs[1]).abs().max().item())
    work = {k: v.clone() for k, v in state0.items()}

    def restore():
        for k, v in work.items():
            v.copy_(state0[k])

    def run_j3(fn):
        restore()
        fn(None, s_val, dc, work["pos_f"], work["alive_f"], work["conv_f"], None, **kw)

    restore_ms = time_ms(restore, reps, device)
    ms = time_ms(lambda: run_j3(st.trace_step_pos_cuda), reps, device) - restore_ms
    pms = time_ms(lambda: run_j3(st.trace_step_pos_plain), plain_reps, device) - restore_ms
    act = state0["alive_f"] & (s_val.abs() >= 2e-4)
    moved = ps["pos_f"][act & (s_val > gcfg.voxel_size)]
    lookups = int(moved.shape[0])
    lin, _ = og.point_to_lin_idx(gcfg, moved)
    voxels = int(torch.unique(lin).numel())
    b = bound_ms(n * (4 + 12 + 12 + 12 + 1 + 1 + 1 + 1) + voxels,
                 n * OPS_PER_ROW_J3 + lookups * OPS_PER_LOOKUP)
    _report(f"J3 rows={n} (alive {int(state0['alive_f'].sum())}, converged "
            f"{int(ps['conv_f'].sum())}, {lookups} jumps of {voxels} voxels; the bucket form "
            f"too)", err, TOL_J3, ms, pms, b)
    dms = device_ms(lambda: run_j3(st.trace_step_pos_cuda), "J3", device)
    results["J3"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                         device_ms=dms)
    return results


def probe_grid_phases(device, gcfg, grid, rays, chunk, P, reps=20):
    """Kernel C3 exactly on the scene's, an empty, a random sparse and a
    full grid (``chebyshev_grids``), each with its distance field at the
    tracers' cap, at the whole view and at one PT_CHUNK-ray chunk; then a
    grid refresh between two seeds (kernel I marking every probed voxel
    occupied, on a copy of the scene's grid), the seeds reading the
    trainer's cached field, which the refresh rebuilds: the second seed
    moves as the plain version's. Returns (C3's numbers per grid, the
    refresh's)."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    probe_grids = {}
    for name, occ in chebyshev_grids(device, gcfg, grid.occupancy).items():
        field = og.chebyshev_empty_distance(gcfg, occ, st._EMPTY_DIST_CAP)
        probe_grids[name] = {}
        for label, rs in (("view", rays), ("chunk", chunk)):
            args = (gcfg, occ) + rs + (P,)
            got = og.first_occupied_cuda(*args, dist_field=field)
            want = og.first_occupied_plain(*args)
            ulp = _ulps(got[0], want[0])
            if not torch.equal(got[1], want[1]) or not ulp <= TOL_C3_ULP:
                fail(f"kernel C3 ({label}) on the {name} grid: has differs on "
                     f"{(got[1] != want[1]).sum().item()} rays, t_first {ulp} ulp")
            run = lambda: og.first_occupied_cuda(*args, dist_field=field)  # noqa: E731
            probe_grids[name][label] = {"has": int(want[1].sum()), "ms": time_ms(run, reps, device),
                                        "device_ms": device_ms(run, "C3", device)}
        print(f"[kernel C3:{name}] " + ", ".join(
            f"{lb} has {x['has']} ms={x['ms']:.4f} device_ms={x['device_ms']}"
            for lb, x in probe_grids[name].items()), flush=True)

    # a refresh between two seeds: the second follows the refreshed grid
    state = og.OccupancyGridState(values=grid.values.clone(), occupancy=grid.occupancy.clone())
    args = lambda: (gcfg, state.occupancy) + chunk + (P,)  # noqa: E731
    seed = lambda: og.first_occupied_cuda(  # noqa: E731
        *args(), dist_field=tps._cached_dist_field(gcfg, state))
    builds = og.chebyshev_field_cuda.launches
    before = seed()
    if not torch.equal(seed()[0], before[0]):
        fail("kernel C3: two seeds on one grid state differ")
    _, lin = og.compute_stratified_sample_of_grid_points(gcfg, 1 << 18, 5, device=device)
    og.update_with_sdf_random_sample(gcfg, state, lin, torch.zeros(lin.shape[0], device=device),
                                     INV_S_TRAINED)
    after = seed()
    want = og.first_occupied_plain(*args())
    builds = og.chebyshev_field_cuda.launches - builds
    moved = int((after[0] != before[0]).sum())
    if (builds != 2 or not torch.equal(after[1], want[1]) or _ulps(after[0], want[0]) != 0
            or moved == 0):
        fail(f"kernel C3 across a grid refresh: {builds} field builds (expected 2), "
             f"{moved} seeds moved, has differs on {(after[1] != want[1]).sum().item()} rays")
    refresh = {"field_builds": builds, "seeds_moved": moved,
               "has_before": int(before[1].sum()), "has_after": int(after[1].sum())}
    print(f"[kernel C3:refresh] {builds} field builds for two grid states, {moved} of "
          f"{PT_CHUNK} seeds moved (has {refresh['has_before']} -> {refresh['has_after']}) as "
          f"the plain version's", flush=True)
    return probe_grids, refresh


def plain_trace_render_phase(device, cfg, scenes, fast_runs):
    """``render_image_sphere_traced`` (PT_CHUNK, PT_TRACES) at 400x400 on
    both scenes, one warm-up frame and PT_FRAMES timed ones, beside the fast
    tracer's ms/frame of the same run; then the compacted renderer
    (``render_rays_sphere_traced_compacted``, its defaults) on the whole
    sphere-scene view in one call, warm-up and PT_FRAMES timed. Launch
    counts reset before each warm-up and read after the last frame."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    K, tf = camera_k(WIDTH, HEIGHT)
    out = {}
    for scene, (params, grid) in scenes.items():
        reset_counts()
        times = []
        for _ in range(PT_FRAMES + 1):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            img = tps.render_image_sphere_traced(params, grid, K, tf, WIDTH, HEIGHT, ITER, cfg,
                                                 chunk=PT_CHUNK, nr_sphere_traces=PT_TRACES,
                                                 device=device)
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        missing = [k for k in PT_KERNELS if counts[k] <= 0]
        if missing:
            fail(f"plain sphere-traced frame ({scene}): no launch of kernel {missing}")
        if not all(torch.isfinite(t).all() for t in img):
            fail(f"plain sphere-traced frame ({scene}): non-finite values")
        lit = int((img[2] > 0).sum())
        if lit <= 0:
            fail(f"plain sphere-traced frame ({scene}): nothing lit")
        timed = times[1:]
        med = statistics.median(timed)
        fast = fast_runs.get(f"{scene}_400", {}).get("ms_per_frame_median")
        chunks = -(-WIDTH * HEIGHT // PT_CHUNK)
        out[f"{scene}_plain"] = {
            "ms_per_frame_median": med, "ms_per_frame_min": min(timed),
            "ms_per_frame_max": max(timed), "ms_per_frame_all": timed, "warmup_frame_ms": times[0],
            "fast_tracer_ms_per_frame_median": fast, "lit": lit, "chunks_per_frame": chunks,
            "launches_per_frame": {k: counts[k] / (PT_FRAMES + 1) for k in PT_KERNELS},
            "launches": counts}
        print(f"[plain_traced] {scene} {WIDTH}x{HEIGHT} chunk {PT_CHUNK}, {PT_TRACES} traces, "
              f"{PT_FRAMES} frames: median {med:.1f} ms/frame (min {min(timed):.1f}, max "
              f"{max(timed):.1f}), warm-up {times[0]:.1f}; fast tracer {fast} ms/frame; lit "
              f"{lit}; launches/frame "
              f"{ {k: round(v, 2) for k, v in out[f'{scene}_plain']['launches_per_frame'].items()} }",
              flush=True)
        # J3f once a chunk (all PT_TRACES iterations, the SDF inside the
        # launch), the unfused J3 never, and A only in the shading (the SDF's
        # and the RGB model's encodes), B once a chunk
        runs = chunks * (PT_FRAMES + 1)
        want = {"J3f": runs, "J3": 0, "A": 2 * runs, "B": runs}
        if any(counts[k] != v for k, v in want.items()):
            fail(f"plain sphere-traced frame ({scene}): launches "
                 f"{ {k: counts[k] for k in want} }, expected {want}")
    params, grid = scenes["sphere"]
    o, d = rays_from_frame(K, tf, WIDTH, HEIGHT, device=device)
    field = tps._cached_dist_field(cfg.grid, grid)
    reset_counts()
    times = []
    for _ in range(PT_FRAMES + 1):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        rgb, nrm, w = tps.render_rays_sphere_traced_compacted(params, grid, o, d, ITER, cfg,
                                                              dist_field=field)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    missing = [k for k in PT_COMPACT_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"compacted sphere-traced frame: no launch of kernel {missing}")
    # J3f once a round, the unfused J3 never, A only in the shading
    want = {"J3f": PT_COMPACT_ROUNDS * (PT_FRAMES + 1), "J3": 0, "A": 2 * (PT_FRAMES + 1)}
    if any(counts[k] != v for k, v in want.items()):
        fail(f"compacted sphere-traced frame: launches {({k: counts[k] for k in want})}, "
             f"expected {want}")
    if not (torch.isfinite(rgb).all() and torch.isfinite(nrm).all()) or not w.sum() > 0:
        fail("compacted sphere-traced frame: non-finite values or nothing shaded")
    timed = times[1:]
    med = statistics.median(timed)
    out["sphere_compacted"] = {
        "rays": o.shape[0], "first_bucket": max(256, o.shape[0] // 4),
        "ms_per_frame_median": med, "ms_per_frame_min": min(timed),
        "ms_per_frame_max": max(timed), "ms_per_frame_all": timed, "warmup_frame_ms": times[0],
        "shaded": int(w.sum()),
        "launches_per_frame": {k: counts[k] / (PT_FRAMES + 1) for k in PT_COMPACT_KERNELS},
        "launches": counts}
    print(f"[plain_traced] compacted renderer, whole {WIDTH}x{HEIGHT} sphere view in one call: "
          f"median "
          f"{med:.1f} ms (min {min(timed):.1f}, max {max(timed):.1f}), shaded {int(w.sum())}; "
          f"launches/frame "
          f"{ {k: round(v, 2) for k, v in out['sphere_compacted']['launches_per_frame'].items()} }",
          flush=True)
    return out


def plain_trace_cross_check(device, cfg, params, grid, field):
    """CROSS_RAYS rays (a strided subsample of the whole 400x400 view) of
    the sphere scene through ``render_rays_sphere_traced`` on the card and
    on the CPU (plain versions; the CPU takes the card's distance field),
    at the sphere-frame gates: the lit masks agree on ST_CROSS_LIT_AGREE of
    the rays; the CPU's final positions shaded on the card give its rgb and
    normals within TOL_ST_CROSS; on the whole path a ray lit in both differs
    by more only where its final position differs from the CPU's by at most
    ST_CROSS_MAX_POS_GAP, on at most ST_CROSS_MAX_OFF_SHARE of those rays."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.models.fields import SDFEval
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    side = int(CROSS_RAYS ** 0.5)
    K, tf = _strided_camera(WIDTH, HEIGHT, side)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    params_cpu = _tree_map(cpu, params)
    grid_cpu = og.OccupancyGridState(cpu(grid.values), cpu(grid.occupancy))
    o, d = rays_from_frame(K, tf, side, side, device="cpu")
    t0 = time.perf_counter()
    ref = tps.render_rays_sphere_traced(params_cpu, grid_cpu, o, d, ITER, cfg,
                                        dist_field=cpu(field))
    cpu_s = time.perf_counter() - t0
    card = tps.render_rays_sphere_traced(params, grid, o.to(device), d.to(device), ITER, cfg,
                                         dist_field=field)
    lit_c, lit_p = card[2].cpu()[:, 0] > 0, ref[2][:, 0] > 0
    both = lit_c & lit_p
    agree = (lit_c == lit_p).float().mean().item()
    err = {k: (card[i].cpu() - ref[i]).abs().amax(dim=-1) for i, k in ((0, "rgb"),
                                                                      (1, "normals"))}
    with torch.no_grad():  # the render's trace: J3f on the card, the plain loop on the CPU
        pos_c = st.sphere_trace(SDFEval(cfg.sdf_model), o.to(device), d.to(device), tps.BOUND,
                                PT_TRACES, grid_cfg=cfg.grid, grid=grid, dist_field=field,
                                final_sdf=False, ctx=(params["sdf"], ITER))[0]
        pos_p = st.sphere_trace(SDFEval(cfg.sdf_model), o, d, tps.BOUND, PT_TRACES,
                                grid_cfg=cfg.grid, grid=grid_cpu, dist_field=cpu(field),
                                final_sdf=False, ctx=(params_cpu["sdf"], ITER))[0]
        same = tps._shade(params, pos_p.to(device), d.to(device), ITER, cfg)
        want = tps._shade(params_cpu, pos_p, d, ITER, cfg)
    shade_err = max((a.cpu() - b).abs().amax(dim=-1)[lit_p].max().item() if lit_p.any() else 0.0
                    for a, b in zip(same, want))
    gap = (pos_c.cpu() - pos_p).abs().amax(dim=-1)
    off = both & ((err["rgb"] > TOL_ST_CROSS) | (err["normals"] > TOL_ST_CROSS))
    unexcused = off & ~((gap > 0) & (gap <= ST_CROSS_MAX_POS_GAP))
    n_meet = int(tps.BOUND.ray_intersection(o, d)[4].sum())
    summary = {"rays": o.shape[0], "stride": WIDTH // side, "miss_the_bound": o.shape[0] - n_meet,
               "lit_card": int(lit_c.sum()), "lit_cpu": int(lit_p.sum()),
               "lit_agreement": agree, "rays_lit_differently": int((lit_c != lit_p).sum()),
               "same_positions_max_err": shade_err,
               "whole_path_rgb_max_err": err["rgb"][both].max().item() if both.any() else 0.0,
               "whole_path_normals_max_err": (err["normals"][both].max().item()
                                              if both.any() else 0.0),
               "whole_path_rays_off": int(off.sum()),
               "rays_with_other_positions": int((gap > 0).sum()),
               "max_position_gap": gap.max().item(), "off_rays_unexcused": int(unexcused.sum()),
               "tol": TOL_ST_CROSS, "cpu_s": cpu_s}
    print(json.dumps({"plain_trace_cross_check": summary}), flush=True)
    if not (summary["miss_the_bound"] and lit_p.any() and not lit_p.all()):
        fail(f"plain-trace cross-check: the sample lacks misses or lit rays ({summary})")
    if not agree >= ST_CROSS_LIT_AGREE:
        fail(f"plain-trace cross-check: lit masks agree on {agree:.4f} of the rays")
    if not shade_err <= TOL_ST_CROSS:
        fail(f"plain-trace cross-check: the CPU's positions shaded on the card differ by "
             f"{shade_err:.3e}")
    if summary["off_rays_unexcused"]:
        fail(f"plain-trace cross-check: {summary['off_rays_unexcused']} rays differ by more "
             f"than {TOL_ST_CROSS:.4f} at a final position the same as the CPU's or more than "
             f"{ST_CROSS_MAX_POS_GAP:g} from it")
    if not summary["whole_path_rays_off"] <= ST_CROSS_MAX_OFF_SHARE * int(both.sum()):
        fail(f"plain-trace cross-check: {summary['whole_path_rays_off']} of {int(both.sum())} "
             f"rays lit in both differ by more than {TOL_ST_CROSS:.4f}")
    return summary


def _recording_eval(sdf_eval, active_of, recs):
    """``sdf_eval`` that also records, at each call of a plain trace loop,
    the points of the rows the fused kernel evaluates (``active_of()``, the
    active rows at that moment) and their sdf."""
    def fn(ctx, pts):
        s = sdf_eval(ctx, pts)
        act = active_of()
        recs.append((pts[act], s[act]))
        return s
    return fn


def _fused_bound(params_sdf, cfg, K, recs, gate, substeps, state_bytes):
    """The least time of a fused trace launch over this run's work: the
    bytes of the distinct 32-byte table sectors its evaluations gather, the
    staged weights, the state and a byte a field lookup; the operations of
    its evaluations (K levels of lattice math, the MLP and its GELUs, the
    step) and lookups -> (bound_ms(...), work)."""
    import torch

    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

    pts = torch.cat([p for p, _ in recs]) if recs else torch.zeros((0, 3))
    s = torch.cat([v for _, v in recs]) if recs else torch.zeros((0,))
    enc = params_sdf["encoding"]
    scales, E, _ = pe.encoding_constants(cfg.encoding, None, pts.device)
    sectors = [torch.zeros((0,), dtype=torch.int64, device=pts.device)]
    for part in pts.split(32768):  # the slot ids of ~32k points at a time, 4 slots a sector
        ids = pe.flat_slot_ids(part, enc["lattice_values"], enc["shift_per_level"], scales, E, K)
        sectors.append((ids // 4).unique())
    n_sectors = int(torch.cat(sectors).unique().numel())
    evals = int(pts.shape[0])
    lookups = int(((s > gate) & (s.abs() >= 2e-4)).sum()) * substeps
    n_in = 2 * K + 3
    mlp_ops = 2 * (n_in * 32 + 2 * 32 * 32 + 32) + 3 * 32 * OPS_PER_GELU
    ops = evals * (K * OPS_PER_POINT_LEVEL_A + mlp_ops + OPS_PER_ROW_J3) + lookups * OPS_PER_LOOKUP
    nbytes = n_sectors * 32 + 4 * (n_in * 32 + 2 * 32 * 32 + 4 * 32 + 1) + state_bytes + lookups
    work = {"evaluations": evals, "table_sectors": n_sectors, "lookups": lookups,
            "ops_per_evaluation": K * OPS_PER_POINT_LEVEL_A + mlp_ops + OPS_PER_ROW_J3}
    return bound_ms(nbytes, ops), work


def _fused_compare(name, rows, pos_k, pos_p, flags_k, flags_p):
    """The fused result against the plain one on ``rows`` rows: rays whose
    flags differ, and rays whose flags agree but whose position (or t)
    differs by more than TOL_FUSED (another jump at a voxel's edge), each
    at most max(FUSED_MAX_ROWS, FUSED_SHARE of the rows) and within
    FUSED_MAX_GAP -> (the largest gap on the other rays, summary)."""
    import torch

    differ = torch.zeros(pos_k.shape[0], dtype=torch.bool, device=pos_k.device)
    for a, b in zip(flags_k, flags_p):
        differ |= a != b
    gap = (pos_k - pos_p).abs()
    gap = gap.amax(dim=-1) if gap.dim() > 1 else gap
    path = ~differ & (gap > TOL_FUSED)
    ok = ~differ & ~path
    summary = {"rows": rows, "flags_differ": int(differ.sum()), "paths_differ": int(path.sum()),
               "max_gap_flags_agree": gap[~differ].max().item() if (~differ).any() else 0.0,
               "max_gap_differing": gap[differ | path].max().item() if (differ | path).any()
               else 0.0}
    limit = max(FUSED_MAX_ROWS, FUSED_SHARE * rows)
    if summary["flags_differ"] > limit or summary["paths_differ"] > limit:
        fail(f"kernel {name}: {summary} (at most {limit:g} rows may differ)")
    if summary["max_gap_differing"] > FUSED_MAX_GAP:
        fail(f"kernel {name}: {summary} (a differing row within {FUSED_MAX_GAP:g})")
    return (gap[ok].max().item() if ok.any() else 0.0), summary


def fused_trace_phases(device, cfg, scenes, reps=10, plain_reps=2):
    """Kernels J3f and J2f (the trace loops with the flagship SDF evaluated
    inside the launch) against their plain versions (``sdf_apply`` on the
    card, then J3's or J2's plain version) on the sphere and the plane
    scene, from the same state: J3f at the plain frame's PT_CHUNK-ray chunk
    (the C3 seed, PT_TRACES iterations) and at the compacted renderer's
    first round (its first bucket of the whole view, 3 iterations, the sdf
    store); J2f at the fast frame's round 0 (the 400² view padded as the
    render pads it, after J1's prepass: LOD 6, 5 iterations, 4 chained
    jumps) and its refine (every level, 3 iterations). Each against
    ``_fused_compare``'s limits; timed from a restored state (the restore's
    time subtracted), device ms in the kernel's own symbols, the bound from
    the run's own work.
    Returns ({"J3f": ..., "J2f": ...} of the sphere scene, summary)."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.models.fields import SDFEval
    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    gcfg = cfg.grid
    K_cam, tf = camera_k(WIDTH, HEIGHT)
    o_all, d_all = rays_from_frame(K_cam, tf, WIDTH, HEIGHT, device=device)
    bound = st._sphere_bound(tps.BOUND)
    L = cfg.sdf_model.nr_levels
    results, summary = {}, {}

    def timed(name, run_k, run_p, restore):
        restore_ms = time_ms(restore, reps, device)
        ms = time_ms(lambda: (restore(), run_k()), reps, device) - restore_ms
        pms = time_ms(lambda: (restore(), run_p()), plain_reps, device) - restore_ms
        # one launch a call: per launch, so a record the profiler drops biases nothing
        dms = device_ms(lambda: (restore(), run_k()), name, device, reps=5, per_launch=True)
        return ms, pms, dms

    for scene, (params, grid) in scenes.items():
        field = tps._cached_dist_field(gcfg, grid)
        ctx = (params["sdf"], ITER)
        full = SDFEval(cfg.sdf_model, None)
        out = {}

        # --- J3f: the plain frame's centre chunk, all PT_TRACES iterations
        mid = (o_all.shape[0] // 2 // PT_CHUNK) * PT_CHUNK
        oc, dc = o_all[mid:mid + PT_CHUNK].contiguous(), d_all[mid:mid + PT_CHUNK].contiguous()
        pos, alive, _ = st._plain_seed(oc, dc, tps.BOUND, gcfg, grid, field)
        state0 = {"pos_f": pos.contiguous(), "alive_f": alive.contiguous(),
                  "conv_f": torch.zeros_like(alive)}
        ks, ps, work = ({k: v.clone() for k, v in state0.items()} for _ in range(3))
        kw = dict(dist_field=field, grid_cfg=gcfg, iters=PT_TRACES, sdf_multiplier=0.9,
                  sdf_converged_tresh=2e-4, bound=bound)
        recs = []
        rec = _recording_eval(full, lambda: ps["alive_f"] & ~ps["conv_f"], recs)
        with torch.no_grad():
            st.trace_loop_pos_cuda(full, ctx, None, dc, ks["pos_f"], ks["alive_f"], ks["conv_f"],
                                   None, **kw)
            st.trace_loop_pos_plain(rec, ctx, None, dc, ps["pos_f"], ps["alive_f"],
                                    ps["conv_f"], None, **kw)
        err, cmp_ = _fused_compare("J3f", PT_CHUNK, ks["pos_f"], ps["pos_f"],
                                   (ks["alive_f"], ks["conv_f"]), (ps["alive_f"], ps["conv_f"]))
        b, w = _fused_bound(params["sdf"], cfg.sdf_model, L, recs, gcfg.voxel_size, 1,
                            PT_CHUNK * (12 + 12 + 2 + 12 + 2))

        def restore(work=work, state0=state0):
            for k, v in work.items():
                v.copy_(state0[k])

        def run(fn, work=work, ctx=ctx, dc=dc, kw=kw, full=full):
            with torch.no_grad():
                fn(full, ctx, None, dc, work["pos_f"], work["alive_f"], work["conv_f"], None,
                   **kw)

        ms, pms, dms = timed("J3f", lambda: run(st.trace_loop_pos_cuda),
                             lambda: run(st.trace_loop_pos_plain), restore)
        _report(f"J3f:{scene} chunk={PT_CHUNK} traces={PT_TRACES} ({cmp_}; {w})", err, TOL_FUSED,
                ms, pms, b)
        out["J3f_chunk"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0],
                                bound_by=b[1], device_ms=dms, compare=cmp_, work=w)

        # --- J3f, the bucket form: the compacted renderer's first round on the whole view
        pos, alive, _ = st._plain_seed(o_all, d_all, tps.BOUND, gcfg, grid, field)
        R = o_all.shape[0]
        bstate0 = {"pos_f": st._padded(pos.contiguous()), "alive_f": st._padded(alive, False),
                   "conv_f": torch.zeros(R + 1, dtype=torch.bool, device=device),
                   "sdf_f": torch.zeros(R + 1, device=device)}
        dirs_f = st._padded(d_all.contiguous())
        idx, _ = compaction.nonzero_static_plain(bstate0["alive_f"][:R], max(256, R // 4), R)
        ks, ps = ({k: v.clone() for k, v in bstate0.items()} for _ in range(2))
        bkw = dict(dist_field=field, grid_cfg=gcfg, iters=3, sdf_multiplier=0.9,
                   sdf_converged_tresh=2e-4, bound=bound)
        with torch.no_grad():
            st.trace_loop_pos_cuda(full, ctx, idx, dirs_f, ks["pos_f"], ks["alive_f"],
                                   ks["conv_f"], ks["sdf_f"], **bkw)
            st.trace_loop_pos_plain(full, ctx, idx, dirs_f, ps["pos_f"], ps["alive_f"],
                                    ps["conv_f"], ps["sdf_f"], **bkw)
        err_b, cmp_b = _fused_compare(
            "J3f", int((idx < R).sum()), torch.cat([ks["pos_f"], ks["sdf_f"][:, None]], 1),
            torch.cat([ps["pos_f"], ps["sdf_f"][:, None]], 1), (ks["alive_f"], ks["conv_f"]),
            (ps["alive_f"], ps["conv_f"]))
        recs, bwork = [], {k: v.clone() for k, v in bstate0.items()}
        with torch.no_grad():
            st.trace_loop_pos_plain(
                _recording_eval(full, lambda: (bwork["alive_f"] & ~bwork["conv_f"])[idx]
                                & (idx < R), recs),
                ctx, idx, dirs_f, bwork["pos_f"], bwork["alive_f"], bwork["conv_f"],
                bwork["sdf_f"], **bkw)
        b, w = _fused_bound(params["sdf"], cfg.sdf_model, L, recs, gcfg.voxel_size, 1,
                            idx.shape[0] * 8 + int((idx < R).sum()) * 48)  # 8 B an id, 48 a row

        def brestore(bwork=bwork, bstate0=bstate0):
            for k, v in bwork.items():
                v.copy_(bstate0[k])

        def brun(fn, bwork=bwork, idx=idx, dirs_f=dirs_f, ctx=ctx, bkw=bkw, full=full):
            with torch.no_grad():
                fn(full, ctx, idx, dirs_f, bwork["pos_f"], bwork["alive_f"], bwork["conv_f"],
                   bwork["sdf_f"], **bkw)

        ms, pms, dms = timed("J3f", lambda: brun(st.trace_loop_pos_cuda),
                             lambda: brun(st.trace_loop_pos_plain), brestore)
        _report(f"J3f:{scene}_bucket bucket={idx.shape[0]} iters=3 ({cmp_b}; {w})", err_b,
                TOL_FUSED, ms, pms, b)
        out["J3f_bucket"] = dict(max_abs_err=err_b, ms=ms, plain_ms=pms, bound_ms=b[0],
                                 bound_by=b[1], device_ms=dms, compare=cmp_b, work=w)

        # --- J2f: the fast frame's round 0 (LOD 6) after the prepass, then the refine
        Rf = st.pow2_bucket(o_all.shape[0], lo=256, hi=1 << 21)
        pad = Rf - o_all.shape[0]
        o = torch.cat([o_all, torch.tensor([[10.0, 0.0, 0.0]], device=device).expand(pad, 3)])
        d = torch.cat([d_all, torch.tensor([[1.0, 0.0, 0.0]], device=device).expand(pad, 3)])
        _, te, _, tx, hit = tps.BOUND.ray_intersection(o, d)
        s0 = {"origins_f": st._padded(o), "dirs_f": st._padded(d), "texit_f": st._padded(tx[:, 0]),
              "t_f": st._padded(te[:, 0]), "alive_f": st._padded(hit[:, 0], False),
              "conv_f": torch.zeros(Rf + 1, dtype=torch.bool, device=device),
              "sdf_f": torch.zeros(Rf + 1, device=device)}
        st.jump_prepass_plain(field, s0["origins_f"], s0["dirs_f"], s0["texit_f"], s0["t_f"],
                              s0["alive_f"], gcfg, 16)
        jkw = dict(dist_field=field, grid_cfg=gcfg, sdf_multiplier=0.9, sdf_converged_tresh=2e-4,
                   jump_substeps=4, jump_gate=gcfg.voxel_size)
        keys = ("origins_f", "dirs_f", "texit_f", "t_f", "alive_f", "conv_f", "sdf_f")
        for stage, ev, iters in (("round0", SDFEval(cfg.sdf_model, ST_KW["lod_schedule"][0]), 5),
                                 ("refine", full, ST_KW["nr_refine_iters"])):
            mask = (s0["alive_f"] & ~s0["conv_f"])[:Rf]
            idx, _ = compaction.nonzero_static_plain(mask, st.pow2_bucket(
                int(mask.sum()), lo=256, hi=Rf), Rf)
            ks, ps, work = ({k: v.clone() for k, v in s0.items()} for _ in range(3))
            recs = []
            rec = _recording_eval(ev, lambda: (ps["alive_f"] & ~ps["conv_f"])[idx] & (idx < Rf),
                                  recs)
            with torch.no_grad():
                c_k = st.trace_round_cuda(ev, ctx, idx, *(ks[k] for k in keys), iters=iters,
                                          **jkw)
                c_p = st.trace_round_plain(rec, ctx, idx, *(ps[k] for k in keys), iters=iters,
                                           **jkw)
            n = int((idx < Rf).sum())
            err_j, cmp_j = _fused_compare("J2f", n, torch.stack([ks["t_f"], ks["sdf_f"]], 1),
                                          torch.stack([ps["t_f"], ps["sdf_f"]], 1),
                                          (ks["alive_f"], ks["conv_f"]),
                                          (ps["alive_f"], ps["conv_f"]))
            cmp_j["counts"], cmp_j["counts_plain"] = c_k.tolist(), c_p.tolist()
            if (c_k - c_p).abs().sum().item() > 2 * max(FUSED_MAX_ROWS, FUSED_SHARE * n):
                fail(f"kernel J2f ({scene} {stage}): counts {c_k.tolist()} vs {c_p.tolist()}")
            Kl = ev.max_levels or L
            b, w = _fused_bound(params["sdf"], cfg.sdf_model, Kl, recs, gcfg.voxel_size, 4,
                                idx.shape[0] * 8 + n * (12 + 12 + 4 + 4 + 2 + 4 + 4 + 2 + 4))

            def restore(work=work, s0=s0):
                for k, v in work.items():
                    v.copy_(s0[k])

            def run(fn, work=work, ev=ev, idx=idx, iters=iters):
                with torch.no_grad():
                    fn(ev, ctx, idx, *(work[k] for k in keys), iters=iters, **jkw)

            ms, pms, dms = timed("J2f", lambda: run(st.trace_round_cuda),
                                 lambda: run(st.trace_round_plain), restore)
            _report(f"J2f:{scene}_{stage} R={Rf} bucket={idx.shape[0]} levels={Kl} iters={iters} "
                    f"({cmp_j}; {w})", err_j, TOL_FUSED, ms, pms, b)
            out[f"J2f_{stage}"] = dict(max_abs_err=err_j, ms=ms, plain_ms=pms, bound_ms=b[0],
                                       bound_by=b[1], device_ms=dms, compare=cmp_j, work=w)
            s0 = {k: v.clone() for k, v in ps.items()}  # the refine starts from the round
            s0["conv_f"] = torch.zeros_like(s0["conv_f"])  # ... with every alive ray re-opened
        print(json.dumps({"fused_trace": {scene: out}}), flush=True)
        summary[scene] = out
        if scene == "sphere":
            keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")
            results["J3f"] = {k: out["J3f_chunk"][k] for k in keys}
            results["J2f"] = {k: out["J2f_round0"][k] for k in keys}
    return results, summary


def _ulp_gap(a, b) -> int:
    """The largest distance in float32 units in the last place between a
    and b (both finite, of one sign or zero)."""
    import torch

    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    gap = torch.where(a == b, 0, (ia - ib).abs())  # -0 == 0
    return int(gap.max()) if a.numel() else 0


def _c2_rays(device, R):
    """R rays made from SEED against the unit-diameter bound: from outside
    (crossing, missing, grazing, pointing away: both t < 0) and from
    inside (t_entry clamped to 0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 19)
    o = rng.normal(size=(R, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * rng.uniform(0.0, 1.5, (R, 1))
    d = rng.uniform(-0.4, 0.4, (R, 3)) - o
    d[-R // 8:] = o[-R // 8:]
    o[:3] = [[0.5, 0.0, -2.0], [0.5 + 3e-8, 0.0, -2.0], [0.5 - 3e-8, 0.0, -2.0]]
    d[:3] = [0.0, 0.0, 1.0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(device),
            torch.from_numpy(d.astype(np.float32)).to(device))


def _c2_check(label, got, want):
    """C2 against its plain version: masks, counts and does_intersect
    exactly, t_entry and t_exit within TOL_C2_ULP, z, dt, ray_fixed_dt and
    the t within TOL_C2 -> (largest absolute difference, t's ulp gap)."""
    import torch

    for i, what in ((2, "masks"), (6, "does_intersect")):
        if not torch.equal(got[i], want[i]):
            fail(f"kernel C2 ({label}): {what} differ in "
                 f"{(got[i] != want[i]).sum().item()} places")
    ulp = max(_ulp_gap(got[4], want[4]), _ulp_gap(got[5], want[5]))
    if ulp > TOL_C2_ULP:
        fail(f"kernel C2 ({label}): t_entry/t_exit {ulp} ulp from the plain version")
    err = max((got[i] - want[i]).abs().max().item() for i in (0, 1, 3, 4, 5))
    if not err <= TOL_C2:
        fail(f"kernel C2 ({label}): values {err:.3e} from the plain version")
    return err, ulp


def nerf_kernel_phases(device, ncfg, params, reel, reps=20, plain_reps=3):
    """Kernels C2, I2 and I2f against their plain versions at the NeRF
    step's shapes (``NerfTrainConfig()``): C2, the sphere's intersection and
    the samples in one launch, on one step's rays (R = 512, S = 64, the
    jitter on; the flagship step's shapes too) and on a batch of 512 rays
    with misses, grazes and starts inside and beyond the sphere. I2 on one
    refresh's probes (n = 65,536 of the 64^3 grid, the density of the
    initial field). C2 and I2 exact (C2: TOL_C2_ULP, TOL_C2). I2 is timed
    from a restored copy of the grid, the restore's own time subtracted.
    I2f (the whole refresh in one launch) at iteration 0 (the c2f window
    still closes levels) and at an open window, on the initial field with
    its table and density bias moved (``refresh_density_params``), within
    TOL_I2F; then one NeRF refresh card against CPU. Returns {kernel:
    numbers}."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import random_rays_from_reel
    from permuto_sdf_tpu_torch.models.fields import nerf_hash_density
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import ray_sampler as rs
    from permuto_sdf_tpu_torch.train import train_nerf as tn
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    results = {}
    draws = tn.draw_train_step(tps.step_generators(SEED, 0)[0], ncfg, reel).to(device)
    o, d, _, _, _ = random_rays_from_reel(reel, ncfg.nr_rays, indices=draws.ray_indices,
                                          apply_mask=False)
    R, S = o.shape[0], ncfg.max_nr_samples_per_ray
    md, start = ncfg.min_dist_between_samples, draws.fg_start
    sphere = tn.BOUND
    bargs = (o, d, sphere, md, S, start)
    want = rs.samples_fg_sphere_plain(*bargs)
    launches = rs.samples_fg_sphere_cuda.launches
    got = rs.samples_fg_sphere_cuda(*bargs)
    if rs.samples_fg_sphere_cuda.launches != launches + 1:
        fail("kernel C2: not one launch a call")
    err, ulp = _c2_check("step", got, want)
    o_m, d_m = _c2_rays(device, 512)
    margs = (o_m, d_m, sphere, 2.0 / S, S, None)
    want_m = rs.samples_fg_sphere_plain(*margs)
    err_m, ulp_m = _c2_check("misses", rs.samples_fg_sphere_cuda(*margs), want_m)
    ms = time_ms(lambda: rs.samples_fg_sphere_cuda(*bargs), reps, device)
    pms = time_ms(lambda: rs.samples_fg_sphere_plain(*bargs), plain_reps, device)
    b = bound_ms(R * (24 + 4) + R * S * 9 + R * (4 + 9),
                 R * S * OPS_PER_SAMPLE_C2 + R * OPS_PER_RAY_SPHERE)
    _report(f"C2 R={R} S={S} (valid {int(want[2].sum())}; t within "
            f"{max(ulp, ulp_m)} ulp)", max(err, err_m), TOL_C2, ms, pms, b)
    dms = device_ms(lambda: rs.samples_fg_sphere_cuda(*bargs), "C2", device, per_launch=True)
    print(f"[kernel C2] device ms {dms}; misses batch: "
          f"{int((~want_m[6]).sum())} of 512 miss, {int(want_m[2].sum())} valid samples, "
          f"err {err_m:.3e}, t within {ulp_m} ulp", flush=True)
    results["C2"] = dict(max_abs_err=max(err, err_m), ms=ms, plain_ms=pms, bound_ms=b[0],
                         bound_by=b[1], device_ms=dms)

    gcfg, n = ncfg.grid, ncfg.grid_nr_random_samples
    jitter = (torch.rand((n, 3), generator=torch.Generator().manual_seed(SEED)) - 0.5).to(device)
    centers, lin = og.compute_stratified_sample_of_grid_points(gcfg, n, 2, jitter, device)
    with torch.no_grad():
        density = nerf_hash_density(params["model"], centers, 16, ncfg.fg_model)
    gen = torch.Generator().manual_seed(SEED + 1)
    vals0 = (torch.rand(gcfg.nr_voxels, generator=gen) * 2 * ncfg.grid_occupancy_thresh).to(device)
    grid0 = og.OccupancyGridState(values=vals0, occupancy=vals0 > ncfg.grid_occupancy_thresh)
    grids = [og.OccupancyGridState(grid0.values.clone(), grid0.occupancy.clone()) for _ in range(2)]
    og.density_update_cuda(gcfg, grids[0], lin, density, ncfg.grid_decay, ncfg.grid_occupancy_thresh)
    og.density_update_plain(gcfg, grids[1], lin, density, ncfg.grid_decay,
                            ncfg.grid_occupancy_thresh)
    if not torch.equal(grids[0].occupancy, grids[1].occupancy):
        fail("kernel I2: occupancy differs from the plain version")
    err = (grids[0].values - grids[1].values).abs().max().item()
    work = og.OccupancyGridState(grid0.values.clone(), grid0.occupancy.clone())

    def restore():
        work.values.copy_(grid0.values)
        work.occupancy.copy_(grid0.occupancy)

    def run_i2(fn):
        restore()
        fn(gcfg, work, lin, density, ncfg.grid_decay, ncfg.grid_occupancy_thresh)

    restore_ms = time_ms(restore, reps, device)
    ms = time_ms(lambda: run_i2(og.density_update_cuda), reps, device) - restore_ms
    pms = time_ms(lambda: run_i2(og.density_update_plain), plain_reps, device) - restore_ms
    b = bound_ms(n * (4 + 4 + 4 + 4 + 1), n * OPS_PER_PROBE_I2)
    flips = int((grids[1].occupancy != grid0.occupancy).sum())
    _report(f"I2 n={n} grid={gcfg.nr_voxels_per_dim}^3 ({flips} voxels flipped)", err, 0.0,
            ms, pms, b)
    dms = device_ms(lambda: run_i2(og.density_update_cuda), "I2", device)
    results["I2"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                         device_ms=dms)

    model = refresh_density_params(params["model"])
    active = density_refresh_case(device, ncfg, model, 0, "c2f_active", reps, plain_reps)
    it_open = 2501 * ncfg.grid_update_every + 3  # past the first 64 updates: the ids wrap
    results["I2f"] = density_refresh_case(device, ncfg, model, it_open, "open", reps,
                                          plain_reps)
    results["I2f"]["c2f_active"] = active
    results["I2f"]["cross_check"] = density_refresh_cross_check(device, ncfg, {"model": model})
    return results


def nerf_phase(device, reel, ncfg):
    """The NeRF trainer at ``NerfTrainConfig()`` (capacity 2^18, 24 levels,
    512 rays, 64 fg + 32 bg samples, a 64^3 grid refreshed from 65,536
    probes every 8 iterations) on the synthetic reel: ``train`` from
    scratch for NERF_SHORT and for NERF_SHORT + NERF_STEPS iterations (the
    same first iterations), ms/step and launches per step from their
    difference (3 refreshes in it; each one launch of I2f, and none of I or
    I2 in either run); the loss falls; the valid fg samples of
    one batch at the window's end; ``render_image`` of one view (one
    warm-up, one timed); one step card against CPU (loss within
    TOL_LOSS_CROSS, every leaf's gradient within TOL_GRAD_CROSS relative
    L2); ``main(["--smoke"])`` in process. Returns (summary, counts of the
    window's run and the render, the trained params)."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import random_rays_from_reel
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import train_nerf as tn
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    runs = {}
    for label, iters in (("short", NERF_SHORT), ("window", NERF_SHORT + NERF_STEPS)):
        torch.cuda.synchronize(device)
        reset_counts()
        t0 = time.perf_counter()
        params, grid, hist = tn.train(reel, ncfg, nr_iters=iters, seed=SEED, log_every=1,
                                      device=device)
        torch.cuda.synchronize(device)
        runs[label] = (time.perf_counter() - t0, read_counts(), hist)
    (t_s, c_s, _), (t_w, c_w, hist) = runs["short"], runs["window"]
    _check_copies("nerf train", c_w, params, NERF_SHORT + NERF_STEPS)
    ms = (t_w - t_s) * 1e3 / NERF_STEPS
    per_step = {k: (c_w[k] - c_s[k]) / NERF_STEPS for k in NERF_KERNELS + ("I", "I2")}
    losses = [h[1] for h in hist]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"nerf train: the loss did not fall ({losses[0]} -> {losses[-1]})")
    missing = [k for k in NERF_KERNELS if per_step[k] <= 0]
    if missing:
        fail(f"nerf train: the window launched no kernel {missing}")
    # every grid refresh is one launch of I2f, and neither entry of I nor I2
    refreshes = sum(1 for it in range(NERF_SHORT + NERF_STEPS)
                    if it % ncfg.grid_update_every == 0)
    if c_w["I2f"] != refreshes or c_w["I"] != 0 or c_w["I2"] != 0:
        fail(f"nerf train: {refreshes} grid refreshes launched I2f {c_w['I2f']}, I {c_w['I']} "
             f"and I2 {c_w['I2']} times, expected {refreshes}, 0 and 0")
    it_end = NERF_SHORT + NERF_STEPS
    draws = tn.draw_train_step(tps.step_generators(SEED, it_end)[0], ncfg, reel).to(device)
    o, d, _, _, _ = random_rays_from_reel(reel, ncfg.nr_rays, indices=draws.ray_indices,
                                          apply_mask=False)
    _, te, _, tx, _ = tn.BOUND.ray_intersection(o, d)
    smp = og.compute_samples_in_occupied_regions(ncfg.grid, grid, o, d, te, tx,
                                                 ncfg.min_dist_between_samples,
                                                 ncfg.max_nr_samples_per_ray,
                                                 start=draws.fg_start)
    valid = int(smp.mask.sum())
    tn.render_image(params, grid, reel, 0, it_end, ncfg, device=device)  # warm-up
    reset_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    rgb, alpha = tn.render_image(params, grid, reel, 0, it_end, ncfg, device=device)
    torch.cuda.synchronize(device)
    render_ms = (time.perf_counter() - t0) * 1e3
    render_counts = read_counts()
    if not (torch.isfinite(rgb).all() and torch.isfinite(alpha).all()):
        fail("nerf render_image: non-finite values")
    psnr = _psnr(rgb, reel.rgb[0])
    cross = _nerf_cross_check(device, ncfg, params, grid, reel, it_end)
    t0 = time.perf_counter()
    tn.main(["--smoke"])
    smoke_s = time.perf_counter() - t0
    summary = {
        "config": "NerfTrainConfig()", "steps": NERF_STEPS, "ms_per_step": ms,
        "rays_per_s": ncfg.nr_rays / ms * 1e3, "valid_fg_samples_per_step": valid,
        "valid_fg_samples_per_s": valid / ms * 1e3, "launches_per_step": per_step,
        "first_loss": losses[0], "final_loss": losses[-1],
        "occupied_share": float(grid.occupancy.float().mean()),
        "render_image_ms": render_ms, "render_image_psnr_vs_view": psnr,
        "render_launches": {k: render_counts[k] for k in ("A", "C", "D")},
        "cross_check": cross, "main_smoke_s": smoke_s}
    print(f"[nerf] {NERF_STEPS} steps: {ms:.1f} ms/step, {summary['rays_per_s']:.0f} rays/s, "
          f"{summary['valid_fg_samples_per_s']:.0f} valid fg samples/s ({valid} per step), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, occupied {summary['occupied_share']:.3f}, "
          f"launches/step { {k: round(v, 2) for k, v in per_step.items()} }; render_image "
          f"{reel.width}x{reel.height} {render_ms:.1f} ms (PSNR {psnr:.2f} dB vs the view); "
          f"main --smoke {smoke_s:.1f} s", flush=True)
    counts = {k: c_w[k] + render_counts[k] for k in c_w}
    return summary, counts, params


def _nerf_cross_check(device, ncfg, params, grid, reel, it):
    """One full-width NeRF step on the CPU (plain versions) and on the card
    with the same draws: the loss within TOL_LOSS_CROSS relative and every
    leaf's gradient within TOL_GRAD_CROSS relative L2."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import train_nerf as tn
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps
    from permuto_sdf_tpu_torch.train.optimizers import tree_leaves

    cpu = lambda t: t.detach().cpu()  # noqa: E731
    draws = tn.draw_train_step(tps.step_generators(SEED, it + 1)[0], ncfg, reel)
    loss_c, _, g_c = tn.compute_loss_and_grads(params, grid, reel, draws, it, ncfg)
    t0 = time.perf_counter()
    loss_p, _, g_p = tn.compute_loss_and_grads(
        _tree_map(cpu, params), og.OccupancyGridState(cpu(grid.values), cpu(grid.occupancy)),
        reel.to("cpu"), draws, it, ncfg)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(loss_c) - float(loss_p)) / max(abs(float(loss_p)), 1e-30)
    worst = 0.0
    for a, b in zip(tree_leaves(g_c), tree_leaves(g_p)):
        if a is None or b is None or not b.abs().max() > 0:
            continue
        worst = max(worst, (torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b)).item())
    summary = {"loss_rel_err": loss_err, "grad_max_rel_l2": worst, "cpu_s": cpu_s,
               "tol_loss": TOL_LOSS_CROSS, "tol_grad": TOL_GRAD_CROSS}
    print(json.dumps({"nerf_cross_check": summary}), flush=True)
    if not loss_err <= TOL_LOSS_CROSS:
        fail(f"nerf cross-check: loss differs by {loss_err:.3e} relative")
    if not worst <= TOL_GRAD_CROSS:
        fail(f"nerf cross-check: a gradient differs by {worst:.3e} relative L2")
    return summary


class _CountedIntersection:
    """Counts the calls of the plain ``Sphere.ray_intersection`` while
    active (``calls``)."""

    def __enter__(self):
        from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere

        self.calls, self.plain = 0, Sphere.ray_intersection

        def counted(sphere, *args):
            self.calls += 1
            return self.plain(sphere, *args)

        Sphere.ray_intersection = counted
        return self

    def __exit__(self, *exc):
        from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere

        Sphere.ray_intersection = self.plain


def _step_device_launches(device, run_cfg, params, grid, reel, it, label):
    """One step of ``run_cfg`` at iteration ``it`` (after a warm-up step at
    it - 1) under torch.profiler: device busy ms, idle share, the device
    launches (kernels, memsets and copies) and C2's device ms a launch, and
    the calls of the plain bound intersection in the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    optimizer = tps.make_optimizer(run_cfg)
    opt_state = optimizer.init(params)
    draws = [tps.draw_train_step(tps.step_generators(SEED, i)[0], run_cfg, reel)
             for i in (it - 1, it)]
    tps.train_step(params, opt_state, grid, reel, draws[0], it - 1, run_cfg, optimizer)
    torch.cuda.synchronize(device)
    with _CountedIntersection() as plain, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tps.train_step(params, opt_state, grid, reel, draws[1], it, run_cfg, optimizer)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = _profile_summary(prof, wall_ms, label) or {}
    c2 = _kernel_events(prof, "C2")
    c2_n = sum(e.count for e in c2)
    return {"wall_ms": wall_ms, "device_busy_ms": summary.get("device_busy_ms"),
            "device_idle_share": summary.get("device_idle_share"),
            "device_launches": sum(e.count for e in prof.key_averages()
                                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                                   and _dev_us(e) > 0) if summary else None,
            "C2_device_ms_per_launch": (sum(_dev_us(e) for e in c2) / 1e3 / c2_n
                                        if c2_n else None),
            "plain_intersection_calls": plain.calls}


def gridfree_phase(device, cfg, params, grid, reel):
    """The flagship with ``use_occupancy_grid=False``: ``train`` resumed at
    the training phase's state for TRAIN_STEPS steps (no refresh, no
    offsurface loss, the fg samples from C2), right after a
    window of the same steps with the grid (the host's speed drifts over
    the script, so the two are compared within this phase): ms/step,
    rays/s, valid samples/s and launches per step; C2 once per step, C and
    I never, and the plain bound intersection never in the grid-free
    window. Then one step of each under torch.profiler: device launches a
    step, device busy ms and idle share. Returns (summary, counts of the
    grid-free window)."""
    import dataclasses

    start = cfg.nr_iter_sphere_fit + TRAIN_FROM
    out = {}
    runs = {"grid": cfg, "gridfree": dataclasses.replace(cfg, use_occupancy_grid=False)}
    for label, run_cfg in runs.items():
        with _CountedIntersection() as plain:
            _, run = _train_window(device, label, run_cfg, params, grid, reel, start,
                                   TRAIN_STEPS)
        _check_importance_launches(label, run)
        timed = [r["ms"] for r in run["per_step"][WARMUP_STEPS:]]
        med = statistics.median(timed)
        samples = statistics.mean(r["nr_samples"] for r in run["per_step"])
        out[label] = {"first_iter": start + 1, "steps": TRAIN_STEPS, "ms_per_step_median": med,
                      "ms_per_step_min": min(timed), "ms_per_step_max": max(timed),
                      "ms_per_step_all": timed, "rays_per_s_median": cfg.nr_rays / med * 1e3,
                      "valid_samples_per_step_mean": samples,
                      "valid_samples_per_s_median": samples / med * 1e3,
                      "launches_per_step": {k: run["launches"][k] / TRAIN_STEPS
                                            for k in GRIDFREE_KERNELS + ("C", "I", "If")},
                      "plain_intersection_calls_per_step": plain.calls / TRAIN_STEPS}
        print(f"[gridfree] {label}: {TRAIN_STEPS} steps from iteration {start + 1}: median "
              f"{med:.1f} ms/step (min {min(timed):.1f}, max {max(timed):.1f}), "
              f"{out[label]['rays_per_s_median']:.0f} rays/s, "
              f"{out[label]['valid_samples_per_s_median']:.0f} valid samples/s, launches/step "
              f"{ {k: round(v, 2) for k, v in out[label]['launches_per_step'].items()} }, "
              f"plain intersections/step {plain.calls / TRAIN_STEPS:.2f}", flush=True)
    counts = run["launches"]
    if counts["C"] or counts["I"] or counts["If"] or counts["C2"] != TRAIN_STEPS:
        fail(f"grid-free train: launches C {counts['C']}, I {counts['I']}, If {counts['If']}, "
             f"C2 {counts['C2']} (expected 0, 0, 0, {TRAIN_STEPS})")
    missing = [k for k in GRIDFREE_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"grid-free train: no launch of kernel {missing}")
    if out["gridfree"]["plain_intersection_calls_per_step"]:
        fail("grid-free train: the step still runs the plain bound intersection on the card")
    out["gridfree_over_grid"] = (out["gridfree"]["ms_per_step_median"]
                                 / out["grid"]["ms_per_step_median"])
    it = start + TRAIN_STEPS + 2
    for label, run_cfg in runs.items():
        step = _step_device_launches(device, run_cfg, _tree_map(_clone, params),
                                     grid if label == "grid" else None, reel, it,
                                     f"{label}_step")
        out[label]["step_profile"] = step
        print(f"[gridfree] {label}: one step under torch.profiler: "
              f"{json.dumps(step)}", flush=True)
    if out["gridfree"]["step_profile"]["plain_intersection_calls"]:
        fail("grid-free step: the plain bound intersection ran on the card")
    return out, counts


def _clone(t):
    return t.clone() if hasattr(t, "clone") else t


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def main() -> int:
    import dataclasses

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
    t0 = time.perf_counter()
    results = kernel_phases(device, cfg)
    t1 = time.perf_counter()
    results.update(train_kernel_phases(device, cfg))
    t2 = time.perf_counter()
    results.update(hit_ray_kernel_phases(device, cfg))
    print(f"[kernel phases] {time.perf_counter() - t0:.1f} s wall (A-D {t1 - t0:.1f} s, "
          f"F, G, D', I {t2 - t1:.1f} s)", flush=True)

    # 3. the slice: full-width render on both grids
    params = plant_plane_sdf(tps.init_params(SEED, cfg, device=device))
    grids = {"full": tps.og.make_occupancy_grid(cfg.grid, device=device),
             "shell": shell_grid(cfg.grid, device)}
    images, counts, times = slice_phase(device, cfg, params, grids, WIDTH, HEIGHT, CHUNK)
    chunks = -(-WIDTH * HEIGHT // CHUNK)
    for name, c in counts.items():
        missing = [k for k in RENDER_KERNELS if c[k] <= 0]
        if missing:
            fail(f"render on the {name} grid launched no kernel {missing}")
        # the importance stage: round 1 (E1), then the merges and round 2 in
        # one launch of E2 (form c) per chunk
        if not c["E1"] == c["E2"] == chunks * N_FRAMES:
            fail(f"render on the {name} grid: E1/E2 launches {c['E1']}/{c['E2']}, expected "
                 f"{chunks * N_FRAMES} each")
        # one table state over the frames: at most one copy per hash table
        if not c["copies"] <= encoding_tables(params):
            fail(f"render on the {name} grid: {c['copies']} interleaved-table copies for "
                 f"{encoding_tables(params)} tables")

    # where the frame's device time goes (one extra profiled frame)
    frame_profile = profile_phase(device, cfg, params, grids["full"], WIDTH, HEIGHT, CHUNK)
    if frame_profile is not None:
        print("[device per launch] exact frame's profile, us: " + ", ".join(
            f"{k} {v:.2f} ({frame_profile['kernels_launches'][k]} launches)"
            for k, v in frame_profile["kernels_us_per_launch"].items()), flush=True)
    # E1 and E2 (its three forms) against their plain versions at one
    # chunk's and one step's shapes
    results.update(importance_kernel_phases(device, cfg, params, grids["full"], frame_profile))

    # 4. the card against the CPU on the same rays
    cross_check(device, cfg, params, grids["full"], images["full"], WIDTH, HEIGHT)

    # 5. the training slice: sphere init, a saved state, train resumed from it
    tparams, tgrid, reel, train_counts, train_summary = train_phase(device, cfg)
    train_summary["profile"] = profile_train_step(device, cfg, tparams, tgrid, reel)

    # 6. the card against the CPU on one training step
    train_cross_check(device, cfg, tparams, tgrid, reel)

    # 7. the sphere scene and the plane scene; J0-J2 and H0 against their plain versions
    sphere_params, sphere_grid, scene_summary = sphere_scene(device, cfg)
    # kernel If on the scene's trained SDF, and one refresh card against CPU
    scene_summary["refresh_kernel"] = refresh_case(device, cfg, sphere_params["sdf"], ITER,
                                                   "sphere_scene")
    scene_summary["refresh_cross_check"] = refresh_cross_check(device, cfg, sphere_params)
    st_results, field = sphere_kernel_phases(device, cfg, sphere_params, sphere_grid)
    results.update(st_results)
    results["E1"]["sharp"] = importance_sharp_phase(device, cfg, sphere_params, sphere_grid)
    scenes = {"sphere": (sphere_params, sphere_grid), "plane": (params, grids["full"])}

    # 8. sphere-traced frames at the viewer's operating point, one profiled
    st_runs = sphere_render_phase(device, cfg, scenes)
    st_profile = profile_sphere_frame(device, cfg, sphere_params, sphere_grid)
    st_first_profile = profile_sphere_frame(device, cfg, sphere_params, sphere_grid, first=True)

    # 9. the card against the CPU on 1024 sphere-traced rays
    st_cross = sphere_cross_check(device, cfg, sphere_params, sphere_grid, field)

    # 10. the LOD volumetric frame on both scenes against their exact frames,
    # one profiled, and the card against the CPU on 1024 LOD rays
    K_cam, tf_cam = camera()
    exact = {"sphere": tps.render_image(sphere_params, sphere_grid, K_cam, tf_cam, WIDTH, HEIGHT,
                                        ITER, cfg, chunk=CHUNK, device=device),
             "plane": images["full"]}
    lod_runs = lod_render_phase(device, cfg, scenes, exact)
    lod_profile = profile_lod_frame(device, cfg, sphere_params, sphere_grid)
    lod_cross = lod_cross_check(device, cfg, sphere_params, sphere_grid)

    # 11. hit-ray compaction in training on the sphere scene
    hit_train = hit_ray_train_phase(device, cfg, sphere_params, sphere_grid, reel)

    # 12. the recommended training profile: L, D2, D2' and F/G with parity
    # against their plain versions, the lever windows through train, and
    # one lever step card against CPU
    lever_results, lever_parity = lever_kernel_phases(device, cfg, tparams, tgrid, reel)
    results.update(lever_results)
    lever_train = lever_train_phase(device, cfg, tparams, tgrid, reel, sphere_params,
                                    sphere_grid, hit_train["bucket_frac"])
    gate_it = lever_train["gate_iter"]
    step_cfg = _lever_cfg(cfg, table_grad_alternate=False, table_grad_parity=0)
    lever_train["profile"] = profile_train_step(device, step_cfg, tparams, tgrid, reel)
    lever_cross = train_cross_check(device, dataclasses.replace(step_cfg, table_grad_parity=1),
                                    tparams, tgrid, reel, it=gate_it + 200,
                                    label="lever_cross_check")

    # 13. slice 6: kernels M1 and M2 against their plain versions, then the
    # SDF-from-mesh trainer, its card-vs-CPU step, main --smoke and the
    # extraction at 196^3-512^3 of the trained field and the sphere scene
    t0 = time.perf_counter()
    mesh_results, mesh_kernels = mesh_kernel_phases(device, cfg, sphere_params)
    results.update(mesh_results)
    sdf_mesh, mesh_counts = sdf_mesh_phase(device, cfg, sphere_params)
    mesh_s = time.perf_counter() - t0
    print(f"[mesh phases] {mesh_s:.1f} s wall for the kernel M phase and the slice", flush=True)

    # 14. slice 7: C3 and J3 against their plain versions, the plain
    # sphere-traced frames on both scenes and the compacted renderer on the
    # whole view, 1024 plain-traced rays card vs CPU; C2 and I2 against their
    # plain versions, the NeRF trainer (window, render, card vs CPU, main
    # --smoke) and a grid-free flagship window
    from permuto_sdf_tpu_torch.train import train_nerf as tn

    t0 = time.perf_counter()
    results.update(plain_trace_kernel_phases(device, cfg, sphere_params, sphere_grid, field))
    plain_runs = plain_trace_render_phase(device, cfg, scenes, st_runs)
    plain_cross = plain_trace_cross_check(device, cfg, sphere_params, sphere_grid, field)
    # slice 14: J3f and J2f, the trace loops with the SDF inside the launch,
    # against their plain versions on both scenes
    fused_results, fused_summary = fused_trace_phases(device, cfg, scenes)
    results.update(fused_results)
    ncfg = tn.NerfTrainConfig()
    results.update(nerf_kernel_phases(device, ncfg, tn.init_params(SEED, ncfg, reel.nr_images,
                                                                    device), reel))
    nerf_summary, nerf_counts, _ = nerf_phase(device, reel, ncfg)
    gridfree, gridfree_counts = gridfree_phase(device, cfg, tparams, tgrid, reel)
    slice7_s = time.perf_counter() - t0
    print(f"[slice 7 phases] {slice7_s:.1f} s wall for C3, J3, J3f, J2f, C2, I2 and I2f, the "
          f"plain-traced frames, the NeRF trainer and the grid-free window", flush=True)

    # 15. summary lines
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
        "E1": ("importance_round", "permuto_sdf_tpu_torch/kernels/csrc/importance_sampling.cu",
               "permuto_sdf_tpu/ops/importance_sampling.py:38"),
        "E2": ("merge_samples", "permuto_sdf_tpu_torch/kernels/csrc/importance_sampling.cu",
               "permuto_sdf_tpu/ops/volume_rendering.py:294"),
        "H1": ("take_rays", "permuto_sdf_tpu_torch/kernels/csrc/compaction.cu",
               "permuto_sdf_tpu/train/train_permuto_sdf.py:451"),
        "H2": ("scatter_rays", "permuto_sdf_tpu_torch/kernels/csrc/compaction.cu",
               "permuto_sdf_tpu/train/train_permuto_sdf.py:469"),
        "L": ("train_lod_select", "permuto_sdf_tpu_torch/kernels/csrc/volume_rendering.cu",
              "permuto_sdf_tpu/train/train_permuto_sdf.py:536"),
        "D2": ("neus_render_mixed", "permuto_sdf_tpu_torch/kernels/csrc/volume_rendering.cu",
               "permuto_sdf_tpu/train/train_permuto_sdf.py:608"),
        "D2'": ("neus_render_mixed_bwd", "permuto_sdf_tpu_torch/kernels/csrc/volume_rendering.cu",
                "permuto_sdf_tpu/train/train_permuto_sdf.py:608"),
        "M1": ("marching_tets_count", "permuto_sdf_tpu_torch/kernels/csrc/marching_tets.cu",
               "permuto_sdf_tpu/native/marching_tets.cpp:88"),
        "M2": ("marching_tets_emit", "permuto_sdf_tpu_torch/kernels/csrc/marching_tets.cu",
               "permuto_sdf_tpu/native/marching_tets.cpp:88"),
        "C3": ("first_occupied_probe", "permuto_sdf_tpu_torch/kernels/csrc/occupancy_grid.cu",
               "permuto_sdf_tpu/ops/occupancy_grid.py:367"),
        "J3": ("plain_sphere_trace_step", "permuto_sdf_tpu_torch/kernels/csrc/sphere_trace.cu",
               "permuto_sdf_tpu/ops/sphere_trace.py:88"),
        "C2": ("samples_fg", "permuto_sdf_tpu_torch/kernels/csrc/ray_sampler.cu",
               "permuto_sdf_tpu/ops/ray_sampler.py:29"),
        "I2": ("occupancy_density_refresh",
               "permuto_sdf_tpu_torch/kernels/csrc/occupancy_grid.cu",
               "permuto_sdf_tpu/ops/occupancy_grid.py:193"),
        "J3f": ("plain_sphere_trace_loop", "permuto_sdf_tpu_torch/kernels/csrc/sphere_trace.cu",
                "permuto_sdf_tpu/ops/sphere_trace.py:88"),
        "J2f": ("sphere_trace_round", "permuto_sdf_tpu_torch/kernels/csrc/sphere_trace.cu",
                "permuto_sdf_tpu/ops/sphere_trace.py:337"),
        "If": ("occupancy_grid_refresh_fused",
               "permuto_sdf_tpu_torch/kernels/csrc/occupancy_grid.cu",
               "permuto_sdf_tpu/train/train_permuto_sdf.py:776"),
        "I2f": ("occupancy_density_refresh_fused",
                "permuto_sdf_tpu_torch/kernels/csrc/occupancy_grid.cu",
                "permuto_sdf_tpu/train/train_nerf.py:102"),
    }
    entries = []
    for k, (name, source, replaces) in meta.items():
        r = results[k]
        launches = (sum(c[k] for c in counts.values()) + train_counts[k]
                    + sum(v["launches"][k] for v in st_runs.values())
                    + sum(v["launches"][k] for v in lod_runs.values())
                    + sum(v["launches"][k] for v in hit_train["runs"].values())
                    + sum(v["launches"][k] for v in lever_train["runs"].values())
                    + mesh_counts[k] + sum(v["launches"][k] for v in plain_runs.values())
                    + nerf_counts[k] + gridfree_counts[k])
        entries.append({"name": f"{k}:{name}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "max_err": GATED[k][0],
                        "err_kind": ERR_KIND[k], "tol": GATED[k][1], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        "device_ms": r.get("device_ms")})
    print("[device ms per call] at the kernel phases' shapes (torch.profiler, the kernel's own "
          "symbols): " + ", ".join(
              f"{e['name'].split(':')[0]} {e['device_ms']:.5f}" if e["device_ms"] is not None
              else f"{e['name'].split(':')[0]} not measured" for e in entries), flush=True)
    render = {}
    for k, v in times.items():
        med = statistics.median(v)
        render[k] = {"ms_per_frame_median": med, "ms_per_frame_min": min(v),
                     "ms_per_frame_max": max(v), "ms_per_frame_all": v,
                     "rays_per_s_median": WIDTH * HEIGHT / med * 1e3,
                     "launches_per_frame": {n: c / N_FRAMES for n, c in counts[k].items()
                                            if n in RENDER_KERNELS},
                     "chunks_per_frame": chunks,
                     "e_launches_per_chunk": (counts[k]["E1"] + counts[k]["E2"])
                     / (chunks * N_FRAMES)}
    print(json.dumps({"render": render, "interleave_copy": results["interleave_copy"],
                      "frame_device_us_per_launch": (frame_profile or {}).get(
                          "kernels_us_per_launch"), "card": card}), flush=True)
    print(json.dumps({"fg_sets": results["fg_sets"], "card": card}), flush=True)
    print(json.dumps({"train": train_summary, "card": card}), flush=True)
    print(json.dumps({"sphere_traced": {"operating_point": ST_KW, "scene": scene_summary,
                                        "runs": st_runs, "cross_check": st_cross,
                                        "profile": st_profile,
                                        "profile_first_frame": st_first_profile},
                      "card": card}), flush=True)
    print(json.dumps({"lod": {"runs": lod_runs, "profile": lod_profile,
                              "cross_check": lod_cross}, "card": card}), flush=True)
    print(json.dumps({"hit_ray_train": hit_train, "card": card}), flush=True)
    print(json.dumps({"levers": {"train": lever_train, "parity_kernels": lever_parity,
                                 "selection": {k: results["L"][k] for k in
                                               ("sel_rays_exact", "sel_rays_tied")},
                                 "cross_check": lever_cross}, "card": card}), flush=True)
    print(json.dumps({"mesh": {"kernels": mesh_kernels, "sdf_from_mesh": sdf_mesh,
                               "phases_s": mesh_s},
                      "card": card}), flush=True)
    print(json.dumps({"plain_traced": {"runs": {k: {x: y for x, y in v.items() if x != "launches"}
                                                 for k, v in plain_runs.items()},
                                        "cross_check": plain_cross, "phases_s": slice7_s,
                                        "fused": fused_summary,
                                        "c3": {k: results["C3"].get(k) for k in
                                               ("chunk_ms", "chunk_device_ms", "chunk_bound_ms",
                                                "work", "chunk_work", "grids", "refresh")}},
                      "card": card}), flush=True)
    print(json.dumps({"nerf": nerf_summary, "nerf_refresh": results["I2f"],
                      "gridfree_train": gridfree, "card": card}),
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
