#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``permuto_sdf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. print the card (``nvidia-smi`` name and power limit), turn TF32 off for
   matmuls and convolutions, build kernels A-D from ``kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of one 2048-ray chunk of the flagship eval render, with the
   tolerance stated, and time both (CUDA events);
3. render 400x400 frames of the full-width flagship model (random weights
   from a seed, plus a planted plane SDF so the frame has a surface) with
   ``render_image`` on a fully occupied grid and on a sparse shell grid,
   N_FRAMES timed frames each after a warm-up (median and spread), with
   every kernel's launch count reset just before and read just after;
4. render 1024 of those rays again on the CPU (the plain path) and compare:
   the CPU's samples rendered on the card must agree within TOL_CROSS,
   and the card's whole path may differ by more only on rays whose
   samples differ from the CPU's;
5. print a ``kernels`` JSON line, then as the last line
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
# Card vs CPU render of the same samples: matmul summation order (cuBLAS
# vs CPU BLAS) moves sdf by ~1e-7, which NeuS alphas amplify by inv_s ~ 3e3.
TOL_CROSS = 2e-3
N_FRAMES = 5  # timed frames per grid, after one warm-up frame

# Float operations per unit of work, for the operations side of the bound.
# A, B and D: approximate counts from the kernel source; their bytes side
# is at least twice their operations side. C: counted operation by
# operation from the kernel body (see probe_sampler_ops).
OPS_PER_POINT_LEVEL_A = 110
OPS_PER_POINT_LEVEL_B = 150
OPS_PER_SAMPLE_D = 60


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


def counters():
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

    return {"A": pe.encode_fwd_cuda, "B": pe.encode_point_grad_cuda,
            "C": og.probe_sampler_cuda, "D": vr.render_weights_cuda}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


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
                  "C": "probe_sampler_kernel", "D": "render_weights_kernel"}


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
        "frame_wall_ms_profiled": wall_ms,
        "device_busy_ms": total_ms,
        "device_idle_share": max(0.0, 1.0 - total_ms / wall_ms),
        "kernels_AD_ms": by_kernel,
        "kernels_AD_share_of_device": sum(by_kernel.values()) / total_ms,
        "top": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3, "count": e.count}
                for e in events[:top]],
    }
    print(json.dumps({"profile": summary}), flush=True)
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

    # 3. the slice: full-width render on both grids
    params = plant_plane_sdf(tps.init_params(SEED, cfg, device=device))
    grids = {"full": tps.og.make_occupancy_grid(cfg.grid, device=device),
             "shell": shell_grid(cfg.grid, device)}
    images, counts, times = slice_phase(device, cfg, params, grids, WIDTH, HEIGHT, CHUNK)
    for name, c in counts.items():
        missing = [k for k, v in c.items() if v <= 0]
        if missing:
            fail(f"render on the {name} grid launched no kernel {missing}")

    # where the frame's device time goes (one extra profiled frame)
    profile_phase(device, cfg, params, grids["full"], WIDTH, HEIGHT, CHUNK)

    # 4. the card against the CPU on the same rays
    cross_check(device, cfg, params, grids["full"], images["full"], WIDTH, HEIGHT)

    # 5. summary lines
    meta = {
        "A": ("permuto_encode_fwd", "permuto_sdf_tpu_torch/kernels/csrc/permuto_encoding.cu",
              "permuto_sdf_tpu/ops/permuto_encoding.py:504"),
        "B": ("permuto_encode_point_grad", "permuto_sdf_tpu_torch/kernels/csrc/permuto_encoding.cu",
              "permuto_sdf_tpu/models/fields.py:167"),
        "C": ("occupancy_probe_sampler", "permuto_sdf_tpu_torch/kernels/csrc/occupancy_grid.cu",
              "permuto_sdf_tpu/ops/occupancy_grid.py:226"),
        "D": ("neus_nerf_render_weights", "permuto_sdf_tpu_torch/kernels/csrc/volume_rendering.cu",
              "permuto_sdf_tpu/ops/volume_rendering.py:151"),
    }
    entries = []
    for k, (name, source, replaces) in meta.items():
        r = results[k]
        entries.append({"name": f"{k}:{name}", "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(c[k] for c in counts.values()),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    render = {}
    for k, v in times.items():
        med = statistics.median(v)
        render[k] = {"ms_per_frame_median": med, "ms_per_frame_min": min(v),
                     "ms_per_frame_max": max(v), "ms_per_frame_all": v,
                     "rays_per_s_median": WIDTH * HEIGHT / med * 1e3,
                     "launches_per_frame": {n: c / N_FRAMES for n, c in counts[k].items()}}
    print(json.dumps({"render": render, "card": card}), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
