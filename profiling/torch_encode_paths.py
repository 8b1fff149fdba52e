#!/usr/bin/env python3
"""Time the main paths that kernels A-G, C3, J0, J2f, J3f and M run, for the port of one tree.

    python3 profiling/torch_encode_paths.py [--root DIR] [--frames 5] [--out FILE]
                                            [--paths host,events,fg,grid,plain,frame,sphere,
                                                     train,gridfree,lever,sdf,nerf,mesh,
                                                     refresh]
    python3 profiling/torch_encode_paths.py --summarize FILE.json ...

Imports ``permuto_sdf_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
the checkout that holds this script), so the same measurements run on two
trees, for example a parent unpacked with ``git archive`` beside the change.
Run the trees in alternating processes on one GPU and compare only within
that session: frame and step times move with the host's load.

Per tree, on the card (CUDA, one GPU), with the parameters made from a seed
(``--paths`` picks the sections; default all):
- events: CUDA-event ms and device ms per call of the E1, E2 and D
  wrappers at R = 2048 (E2 in each form the tree has);
- fg: CUDA-event ms, device ms in the kernel's own symbols and device ms
  of every kernel and memset of the call, of kernels F and G on the point
  sets of the checkout's own ``chip_smoke.fg_point_sets`` (random, rays,
  clustered) at the training step's fg (d = 3, N = 49,152) and background
  (d = 4, N = 16,384) counts, every level and parity (phase 1 of period 2);
- grid: CUDA-event ms and device ms per call of kernel C on the checkout's
  own ``chip_smoke.probe_sampler_cases`` (the exact frame's 2048-ray
  chunk on the full and the shell grid, the flagship step's batch with
  jittered starts, NeRF's 64³ grid), the wall µs per call of its wrapper
  on 32 of the step's rays (the device idle), and of kernel J0 on
  ``chip_smoke.chebyshev_grids`` at 256³ (a shell, empty, random sparse,
  full) at caps 15 and 63;
- plain: chip_smoke's sphere scene; CUDA-event ms and device ms per call
  of kernel C3 at the plain frame's PT_CHUNK-ray chunk and on the whole
  400² view (R = 160,000) on ``chebyshev_grids`` (the scene's grid, empty,
  random sparse, full; each with its distance field where the tree's C3
  reads one); then ``render_image_sphere_traced`` at 400² (PT_CHUNK,
  PT_TRACES): ``--frames`` timed frames after a warm-up, then one under
  torch.profiler, whose own wall time is printed beside the timed ones;
- host: the wall µs per call of ``encode_fwd_cuda`` on 256 points (the
  launch and wrapper cost, the device idle), of a cache hit of
  ``interleaved_table``, of ``importance_round_cuda`` (E1),
  ``merge_samples_cuda`` (E2: the merge, and where the tree has them the
  merge that draws round 2 and the one that also merges the draws in) and
  of ``neus_render`` (kernel D through its autograd function) on 32 rays;
- frame: ``render_image`` at 400² (chip_smoke's exact frame on the full
  grid), ``--frames`` frames, then one under torch.profiler;
- sphere: chip_smoke's sphere scene, then the sphere-traced 400² frame at
  its operating point: ``--frames`` timed frames after a warm-up, then
  under torch.profiler twice: first with the distance field cache emptied
  (the first frame after a grid refresh, which builds the field with J0),
  then the next frame, with each kernel's device ms per launch;
  then kernel J1 alone on the 400² view's padded state (CUDA-event ms per
  call and device ms per call), and kernel H0 alone on the alive rays it
  leaves (the mask alone, fused with a second mask where the tree's H0
  takes one, and after the tree's elementwise ops);
- train: chip_smoke's ``train_phase`` (24 steps resumed past the ease-in;
  interleaved-table copies per step) and one flagship step under
  torch.profiler (D''s device ms per launch in it, as every kernel's), and
  one with hit-ray compaction at HIT_FRAC (H1's and H2's launches in it);
  then kernel D' alone at the step's shapes (``_weights_bwd_alone``);
- gridfree: one flagship step with ``use_occupancy_grid=False`` (the fg
  samples from kernel C2, in the tree's form: after the plain bound
  intersection, or with it inside C2's launch) under torch.profiler after
  a warm-up step, on the train path's state: device busy ms, idle share,
  device launches and C2's device ms a launch;
- lever: LEVER_STEPS steps of chip_smoke's recommended profile past its
  gate (the train-time LOD, parity alternating) on the trained state, host
  clock per step, and one step under torch.profiler (and one with hit-ray
  compaction at HIT_FRAC, for H1 and H2); then kernels L, D2
  and D2' on their own at the next step's shapes (R = nr_rays, S = 96,
  K + E = 24 + 8): CUDA-event ms per call and device ms per launch among
  the profiler's records (``device_ms(per_launch=True)``), and a hash of
  L's and D2's outputs on ``lod_kernels.lever_batch`` (made from a seed),
  so two trees' outputs compare bit for bit;
- sdf_from_mesh: ``train_sdf_from_mesh.train`` for 50 and 300 steps
  (ms/step from the difference), one step under torch.profiler, then the
  trained field's 512³ mesh three times (grid SDF and marching tetrahedra);
- nerf: ``train_nerf.train`` at ``NerfTrainConfig()`` for 2 and 26 steps
  (ms/step from the difference) and one step under torch.profiler;
- refresh: one flagship ``occupancy_update`` (262,144 probes, the SDF on 14
  levels; random weights): host ms per call, one call profiled (device busy
  ms, device launches, If's or I's and A's device ms), and the host ms of
  drawing its jitter on the CPU and copying it to the card; then the same
  for NeRF's ``occupancy_update`` at ``NerfTrainConfig()`` (65,536 probes
  of the 64³ grid, the density on all 24 levels; random weights with the
  table scaled by 1e3 and the density's bias moved by -7, so that the
  densities straddle the threshold; I2f's, or I's, A's and I2's device ms);
- mesh: chip_smoke's sphere scene and its grid SDF at 256³ and 512³ (host
  clock, median of the calls after the first); on each grid, CUDA-event ms per call of the tree's own pieces of kernel M
  (M1, M2, the welding glue that follows M2, and the whole of
  ``marching_tetrahedra_cuda``), device ms per call of M1 and M2 in their
  own symbols, the whole of M on the host clock (median of 10 calls), and
  one whole call under torch.profiler (device busy ms; M1's and M2's
  device ms in it).

Each profile gives the device ms and the launches of kernels A, B, C, C2, C3,
D, D', E1, E2, F, G, H0, H1, H2, I, If, I2, I2f, J0, J1, J2, J2f, J3, J3f, M1, M2, L, D2 and
D2' and
their ratio,
the device ms per launch, and the count of every device activity of the window
(kernels, memsets and copies: ``device_launches``). Each
path also
records the peak of ``torch.cuda.max_memory_allocated``.
Prints the profiles as chip_smoke does and, last, one JSON line of the
results (also written to ``--out``). ``--summarize`` reads such files and
prints, for each number and each ``--label``, the median over the runs and
the range (no GPU needed).
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import statistics
import sys
import time

SDF_SHORT, SDF_STEPS = 50, 300
NERF_SHORT, NERF_STEPS = 2, 26
MESH_RES, MESH_REPS = 512, 3
HOST_CALLS = 2000
LEVER_STEPS, LEVER_WARMUP = 12, 2
PROFILED = ("A", "B", "C", "C2", "C3", "D", "D'", "E1", "E2", "F", "G", "H0", "H1", "H2", "I", "If",
            "I2", "I2f", "J0", "J1", "J2", "J2f", "J3", "J3f", "M1", "M2", "L", "D2", "D2'")
LOD_REPS = 20
PATHS = ("host", "events", "fg", "grid", "plain", "frame", "sphere", "train", "gridfree",
         "lever", "sdf", "nerf", "mesh", "refresh")
HIT_FRAC = 0.5  # the hit-ray step's bucket fraction, so that its profile holds H1 and H2
REFRESH_CALLS, REFRESH_ITER = 10, 2000  # the flagship's c2f window still closes levels here
NERF_REFRESH_TABLE_SCALE = 1e3  # a trained table's magnitude
NERF_REFRESH_BIAS_SHIFT = -7.0  # the densities straddle the threshold 1e-3
M_RES = (256, 512)
M_HOST_CALLS = 10
M_GRID_CALLS = 4
GRID_HOST_RAYS = 32


def _profiled(cs, device, what, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    s = cs._profile_summary(prof, wall_ms, what)
    if s is None:
        return None
    out = {"wall_ms": wall_ms, "device_busy_ms": s["device_busy_ms"],
           "device_idle_share": s["device_idle_share"],
           # every device activity of the window: kernels, memsets and copies
           "device_launches": sum(e.count for e in prof.key_averages()
                                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                                  and cs._dev_us(e) > 0)}
    out.update(_kernel_stats(cs, prof))
    return out


def _kernel_stats(cs, prof):
    """Device ms and launches of each profiled kernel, by the kernel symbols
    of this checkout's chip_smoke (a parent tree's may lack the newer
    kernels; the older ones keep their symbols)."""
    out = {}
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    for k in PROFILED:
        sym = _own_chip_smoke().KERNEL_SYMBOLS[k]
        sym = sym if isinstance(sym, tuple) else (sym,)
        hits = [e for e in events if any(x in e.key for x in sym)]
        dev_us = sum(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) for e in hits)
        out[f"{k}_ms"] = dev_us / 1e3
        out[f"{k}_launches"] = sum(e.count for e in hits)
        if out[f"{k}_launches"]:
            out[f"{k}_ms_per_launch"] = out[f"{k}_ms"] / out[f"{k}_launches"]
    return out


def _peak_mib(device):
    import torch

    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def _tiny_samples(device, R=32, S1=64, n=16):
    """A prefix-masked uniform sample set with its sdf, sorted draws with
    theirs, and t_exit: one small importance stage's inputs."""
    import torch

    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask

    g = torch.Generator().manual_seed(2)
    fixed = torch.full((R,), 0.01)
    z = 0.2 + fixed[:, None] * torch.arange(S1, dtype=torch.float32)[None, :]
    nr = torch.randint(S1 // 2, S1 + 1, (R,), generator=g)
    mask = prefix_mask(nr, S1)
    dirs = torch.nn.functional.normalize(torch.randn(R, 3, generator=g), dim=-1)
    smp = RaySamples(origins=torch.zeros(R, 3), dirs=dirs, z=torch.where(mask, z, 0.0),
                     dt=torch.where(mask, fixed[:, None], 0.0), mask=mask, ray_fixed_dt=fixed,
                     sdf=0.3 - z + 0.01 * torch.randn(R, S1, generator=g))
    zi = torch.sort(0.2 + 0.6 * torch.rand(R, n, generator=g), dim=1).values
    imp = RaySamples(origins=smp.origins, dirs=dirs, z=zi, dt=torch.zeros(R, n),
                     mask=torch.ones(R, n, dtype=torch.bool), ray_fixed_dt=fixed, sdf=0.3 - zi)
    t_exit = torch.full((R, 1), 0.2 + 0.01 * S1)
    to = lambda x: x.to(device) if x is not None else None  # noqa: E731
    smp = RaySamples(**{f: to(getattr(smp, f)) for f in smp.__dataclass_fields__})
    imp = RaySamples(**{f: to(getattr(imp, f)) for f in imp.__dataclass_fields__})
    return smp, imp, to(t_exit)


def host_costs(device, cfg):
    """Wall µs per call of the wrappers of A, E1, E2 and D on tiny inputs,
    and of a cache hit of the interleaved table where the tree has one."""
    import inspect

    import torch

    from permuto_sdf_tpu_torch.ops import importance_sampling as isp
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

    spec = pe.PermutoEncodingSpec(pos_dim=3, capacity=cfg.capacity, nr_levels=24,
                                  concat_points_scaling=1e-3)
    prm = pe.init_encoding_params(torch.Generator().manual_seed(0), spec, device)
    scales, E, _ = pe.encoding_constants(spec, None, device)
    pts = torch.rand(256, 3, generator=torch.Generator().manual_seed(1)).to(device) - 0.5
    args = (pts, prm["lattice_values"], prm["shift_per_level"], scales,
            torch.ones(24, device=device), E, 24, 1.0, True)
    smp, imp, t_exit = _tiny_samples(device)
    n = imp.max_samples
    merged = isp.merge_samples_cuda(smp, imp, t_exit)
    R, S = merged.mask.shape
    grads = torch.nn.functional.normalize(torch.randn(R * S, 3, device=device), dim=-1)
    rgb = torch.rand(R * S, 3, device=device)
    out = {}
    calls = {"encode_fwd_cuda": lambda: pe.encode_fwd_cuda(*args),
             "importance_round_cuda": lambda: isp.importance_round_cuda(smp, smp.sdf, n, None,
                                                                        1.0),
             "merge_samples_cuda": lambda: isp.merge_samples_cuda(smp, imp, t_exit),
             "render_weights_cuda": lambda: vr.render_weights_cuda(0, merged, merged.sdf, grads,
                                                                   rgb, 2981.0, 1.0),
             "neus_render": lambda: vr.neus_render(merged, merged.sdf, grads, rgb, 2981.0, 1.0)}
    if "nr_draws" in inspect.signature(isp.merge_samples_cuda).parameters:
        calls["merge_samples_cuda_draw"] = lambda: isp.merge_samples_cuda(
            smp, imp, t_exit, nr_draws=n)
        calls["merge_samples_cuda_draw_merge"] = lambda: isp.merge_samples_cuda(
            smp, imp, t_exit, nr_draws=n, merge_draws=True)
    if hasattr(pe, "interleaved_table"):
        calls["interleaved_table_hit"] = lambda: pe.interleaved_table(prm["lattice_values"])
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        torch.cuda.synchronize(device)
        out[name + "_us"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    return out


def event_costs(cs, device):
    """CUDA-event ms per wrapper call (chip_smoke's ``time_ms``) and device
    ms per call in the kernel's own symbols (torch.profiler) of E1 (round
    1, S = 64), E2 (the merge 64 + 16 with sdf; where the tree has them
    also the merge that draws round 2 and the one that merges the draws
    in) and D (NeuS, S = 96), all at R = 2048."""
    import inspect

    import torch

    from permuto_sdf_tpu_torch.ops import importance_sampling as isp
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

    smp, imp, t_exit = _tiny_samples(device, R=2048)
    big, big_imp, big_te = _tiny_samples(device, R=2048, S1=80)
    merged = isp.merge_samples_cuda(big, big_imp, big_te)
    R, S = merged.mask.shape
    n = imp.max_samples
    grads = torch.nn.functional.normalize(torch.randn(R * S, 3, device=device), dim=-1)
    rgb = torch.rand(R * S, 3, device=device)
    calls = {"E1": ("E1", lambda: isp.importance_round_cuda(smp, smp.sdf, n, None, 1.0)),
             "E2_merge": ("E2", lambda: isp.merge_samples_cuda(smp, imp, t_exit)),
             "D_neus": ("D", lambda: vr.render_weights_cuda(0, merged, merged.sdf, grads, rgb,
                                                            2981.0, 1.0))}
    if "nr_draws" in inspect.signature(isp.merge_samples_cuda).parameters:
        calls["E2_merge_draw"] = ("E2", lambda: isp.merge_samples_cuda(smp, imp, t_exit, n))
        calls["E2_merge_draw_merge"] = ("E2", lambda: isp.merge_samples_cuda(
            smp, imp, t_exit, n, merge_draws=True))
    out = {}
    for name, (kernel, fn) in calls.items():
        out[name + "_ms"] = cs.time_ms(fn, 20, device)
        out[name + "_device_ms"] = _device_ms(cs, device, fn, kernel)[0]
    return out


def _device_ms(cs, device, fn, kernel, calls=20):
    """Device ms per call of ``fn`` over ``calls`` calls under
    torch.profiler: (in ``kernel``'s own symbols, in every device activity
    of the call); (None, None) if three tries record no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # the profiler now and then delivers no device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(device)
        own = _kernel_stats(cs, prof)[f"{kernel}_ms"]
        total = sum(cs._dev_us(e) for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3
        if own > 0:
            return own / calls, total / calls
    return None, None


@functools.lru_cache(maxsize=None)
def _own_chip_smoke():
    """The chip_smoke module of the checkout that holds this script (its
    point sets stay the same whichever tree ``--root`` names)."""
    import importlib.util

    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_own_chip_smoke", here)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fg_costs(cs, device, cfg):
    """Kernels F and G on the three point sets, d = 3 and d = 4, every
    level and parity (1, 2): CUDA-event ms and device ms per call (the
    kernel's own symbols, and every device activity of the call, its
    output's memset included)."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

    sets_of = _own_chip_smoke().fg_point_sets
    rng = np.random.default_rng(cs.SEED + 1)
    L, R = cfg.nr_levels, cfg.nr_rays
    out = {}

    for d, n, per_ray, scaling in ((3, R * cfg.samples_per_ray, cfg.samples_per_ray, 1e-3),
                                   (4, R * cfg.nr_samples_bg, cfg.nr_samples_bg, 1.0)):
        spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=cfg.capacity, nr_levels=L,
                                      concat_points_scaling=scaling)
        prm = pe.init_encoding_params(torch.Generator().manual_seed(cs.SEED + d), spec, device)
        prm["lattice_values"] *= 1e3
        scales, E, _ = pe.encoding_constants(spec, None, device)
        g = torch.from_numpy(rng.normal(size=(n, 2 * L + d)).astype(np.float32)).to(device)
        u = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(device)
        window = torch.ones(L, device=device)
        for set_name, pts in sets_of(device, n, d, per_ray, cs.SEED + 7).items():
            base = (pts, prm["lattice_values"], prm["shift_per_level"], scales, window, E, L)
            for levels in ((0, 1), (1, 2)):
                label = f"d{d}_{set_name}" + ("_parity" if levels[1] > 1 else "")
                calls = {"F": lambda: pe.encode_table_grad_cuda(*base, g, levels),
                         "G": lambda: pe.encode_double_backward_cuda(
                             *base, scaling, True, g, u, levels)}
                for kernel, fn in calls.items():
                    key = f"{kernel}.{label}"
                    out[key + ".ms"] = cs.time_ms(fn, 20, device)
                    out[key + ".device_ms"], out[key + ".call_device_ms"] = _device_ms(
                        cs, device, fn, kernel)
    return out


def grid_costs(cs, device, cfg):
    """Kernel C on the probe-sampler cases and J0 on the distance-field
    grids of the checkout's own chip_smoke: CUDA-event ms and device ms
    per call; C's wrapper wall µs per call on GRID_HOST_RAYS rays."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og

    own = _own_chip_smoke()
    out = {}
    cases = own.probe_sampler_cases(device, cfg)
    for label, cargs in cases.items():
        fn = lambda: og.probe_sampler_cuda(*cargs)  # noqa: E731
        out[f"C.{label}.ms"] = cs.time_ms(fn, 20, device)
        out[f"C.{label}.device_ms"] = _device_ms(cs, device, fn, "C")[0]
    step = cases["step_jitter"]
    n = GRID_HOST_RAYS
    small = step[:2] + tuple(t[:n].contiguous() for t in step[2:6]) + step[6:9] + (
        step[9][:n].contiguous(),)
    og.probe_sampler_cuda(*small)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        og.probe_sampler_cuda(*small)
    torch.cuda.synchronize(device)
    out["C.wrapper_us"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    gcfg = cfg.grid
    grids = own.chebyshev_grids(device, gcfg, own.shell_grid(gcfg, device).occupancy)
    for label, occ in grids.items():
        for cap in (15, 63):
            fn = lambda: og.chebyshev_field_cuda(gcfg, occ, cap)  # noqa: E731
            key = f"J0.{'shell' if label == 'scene' else label}.cap{cap}"
            out[key + ".ms"] = cs.time_ms(fn, 20, device)
            out[key + ".device_ms"] = _device_ms(cs, device, fn, "J0")[0]
    return out


def plain_path(cs, device, cfg, frames):
    """Kernel C3 on the sphere scene's and three other grids at the plain frame's chunk and on the whole view, then the
    plain sphere-traced 400² frame: timed frames, and one under
    torch.profiler."""
    import inspect

    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    own = _own_chip_smoke()
    # the trees whose C3 reads the distance field get the grid's, built once
    # per grid state as the tracers build it
    reads_field = "dist_field" in inspect.signature(og.first_occupied_cuda).parameters
    params, grid, _ = cs.sphere_scene(device, cfg)
    gcfg, P = cfg.grid, 512
    K, tf = cs.camera_k(cs.WIDTH, cs.HEIGHT)
    o, d = rays_from_frame(K, tf, cs.WIDTH, cs.HEIGHT, device=device)
    _, te, _, tx, _ = tps.BOUND.ray_intersection(o, d)
    R, chunk = o.shape[0], own.PT_CHUNK
    mid = (R // 2 // chunk) * chunk
    rays = {"chunk": tuple(t[mid:mid + chunk].contiguous() for t in (o, d, te, tx)),
            "view": (o, d, te, tx)}
    out = {}
    for label, occ in own.chebyshev_grids(device, gcfg, grid.occupancy).items():
        kc = ({"dist_field": og.chebyshev_empty_distance(gcfg, occ, st._EMPTY_DIST_CAP)}
              if reads_field else {})
        for shape, rs in rays.items():
            fn = lambda: og.first_occupied_cuda(gcfg, occ, *rs, P, **kc)  # noqa: E731
            key = f"C3.{label}.{shape}"
            out[key + ".ms"] = cs.time_ms(fn, 20, device)
            out[key + ".device_ms"] = _device_ms(cs, device, fn, "C3")[0]

    def frame():
        tps.render_image_sphere_traced(params, grid, K, tf, cs.WIDTH, cs.HEIGHT, cs.ITER, cfg,
                                       chunk=chunk, nr_sphere_traces=own.PT_TRACES,
                                       device=device)

    frame()  # warm-up: the distance field is built here
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(frames):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    prof = _profiled(cs, device, "plain_frame", frame)
    print(f"[plain frame] timed {[round(t, 1) for t in times]} ms, median "
          f"{statistics.median(times):.1f}; the profiled frame's wall "
          f"{prof['wall_ms'] if prof else None} ms, busy "
          f"{prof['device_busy_ms'] if prof else None} ms, "
          f"{prof['device_launches'] if prof else None} device launches", flush=True)
    out["frame"] = {"ms_all": times, "ms_median": statistics.median(times),
                    "peak_mib": _peak_mib(device), "profile": prof}
    return out


def sphere_path(cs, device, cfg, frames):
    """``frames`` timed sphere-traced frames after a warm-up; then the first
    frame after a grid refresh (the distance field built by J0) and the
    next one, each under torch.profiler, with J1's and H0's device ms per
    launch in them; then kernel J1 alone (``_prepass_alone``)."""
    import torch

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    params, grid, _ = cs.sphere_scene(device, cfg)
    K, tf = cs.camera_k(cs.WIDTH, cs.HEIGHT)

    def frame():
        tps.render_image_sphere_traced_fast(params, grid, K, tf, cs.WIDTH, cs.HEIGHT, cs.ITER,
                                            cfg, device=device, **cs.ST_KW)

    frame()  # warm-up
    times = []
    for _ in range(frames):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    tps._DIST_FIELD_CACHE.clear()
    first = _profiled(cs, device, "sphere_first_frame", frame)
    peak = _peak_mib(device)
    nxt = _profiled(cs, device, "sphere_frame", frame)
    print(f"[sphere frame] timed {[round(t, 1) for t in times]} ms, median "
          f"{statistics.median(times):.1f}; the profiled frame's wall "
          f"{nxt['wall_ms'] if nxt else None} ms, busy {nxt['device_busy_ms'] if nxt else None} "
          f"ms, {nxt['device_launches'] if nxt else None} device launches", flush=True)
    j1, alive = _prepass_alone(cs, device, cfg, grid)
    return {"ms_all": times, "ms_median": statistics.median(times), "first_frame": first,
            "next_frame": nxt, "peak_mib": peak, "J1_alone": j1,
            "H0_alone": _compact_alone(cs, device, alive)}


def _prepass_alone(cs, device, cfg, grid, reps=20):
    """Kernel J1 alone on the padded state of the 400² view (as chip_smoke's
    sphere phase builds it, 16 jumps), from a restored state: CUDA-event ms
    per call (the restore's own time subtracted) and device ms per call
    among the profiler's records (one launch a call, or two)."""
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    gcfg = cfg.grid
    field = tps._cached_dist_field(gcfg, grid)
    K, tf = cs.camera_k(cs.WIDTH, cs.HEIGHT)
    o, d = rays_from_frame(K, tf, cs.WIDTH, cs.HEIGHT, device=device)
    R = st.pow2_bucket(o.shape[0], lo=256, hi=1 << 21)
    pad = R - o.shape[0]
    o = torch.cat([o, torch.tensor([[10.0, 0.0, 0.0]], device=device).expand(pad, 3)])
    d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]], device=device).expand(pad, 3)])
    _, te, _, tx, hit = tps.BOUND.ray_intersection(o, d)
    state0 = [st._padded(o), st._padded(d), st._padded(tx[:, 0]), st._padded(te[:, 0]),
              st._padded(hit[:, 0], False)]
    work = [v.clone() for v in state0]

    def restore():
        for w, v in zip(work, state0):
            w.copy_(v)

    def run():
        restore()
        st.jump_prepass_cuda(field, *work, gcfg, 16)

    # a tree whose J1 launches two kernels names both symbols
    two = isinstance(cs.KERNEL_SYMBOLS["J1"], tuple)
    out = {"R": R, "ms": cs.time_ms(run, reps, device) - cs.time_ms(restore, reps, device),
           "device_ms_per_call": cs.device_ms(run, "J1", device, reps=reps, per_launch=True,
                                              **({"launches": 2} if two else {}))}
    print(f"[J1 alone] {json.dumps(out)}", flush=True)
    return out, work[-1][:R].clone()


def _compact_alone(cs, device, alive, reps=20):
    """Kernel H0 alone (two launches a call) on the alive rays after the
    prepass (round 0's mask, the second mask all false as conv is there):
    CUDA-event ms per call and device ms per call among the profiler's
    records, on the mask alone and,
    where the tree's H0 takes a second mask, with ``alive & ~conv`` fused
    in; beside the tree's way of forming that mask first (two elementwise
    ops and H0: all device activities of a call)."""
    import inspect

    import torch

    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops import sphere_trace as st

    R = alive.shape[0]
    conv = torch.zeros_like(alive)
    bucket = st.pow2_bucket(int(alive.sum()), lo=256, hi=R)
    # a tree whose H0 takes a second mask forms alive & ~conv in its loads
    fused = "other" in inspect.signature(compaction.nonzero_static_cuda).parameters

    def alone():
        compaction.nonzero_static_cuda(alive, bucket, R)

    def with_ops():
        compaction.nonzero_static_cuda((alive & ~conv).contiguous(), bucket, R)

    out = {"R": R, "bucket": bucket, "ms": cs.time_ms(alone, reps, device),
           "device_ms_per_call": cs.device_ms(alone, "H0", device, reps=reps, per_launch=True,
                                              launches=2),
           "ops_then_h0_ms": cs.time_ms(with_ops, reps, device)}
    if hasattr(cs, "device_ms_all"):
        out["ops_then_h0_device_ms"] = cs.device_ms_all(with_ops, device, reps=reps)[0]
    if fused:
        def run_fused():
            compaction.nonzero_static_cuda(alive, bucket, R, other=conv, negate_other=True)

        out["fused_ms"] = cs.time_ms(run_fused, reps, device)
        out["fused_device_ms_per_call"] = cs.device_ms(run_fused, "H0", device, reps=reps,
                                                       per_launch=True, launches=2)
    print(f"[H0 alone] {json.dumps(out)}", flush=True)
    return out


def lever_path(cs, device, cfg, params, grid, reel):
    """LEVER_STEPS steps of the recommended profile past its gate (the
    train-time LOD, parity alternating with the iteration), host clock per
    step after LEVER_WARMUP, then one step under torch.profiler."""
    import torch

    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    lcfg = cs._lever_cfg(cfg)
    optimizer = tps.make_optimizer(lcfg)
    opt_state = optimizer.init(params)
    it0 = lcfg.nr_iter_sphere_fit + cs.TRAIN_FROM + 20_000  # past the AUTO gate (39,000)
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    copies = pe.interleaved_table.copies
    for i in range(LEVER_WARMUP + LEVER_STEPS):
        draws = tps.draw_train_step(tps.step_generators(cs.SEED, it0 + i)[0], lcfg, reel)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt_state, _, _ = tps.train_step(params, opt_state, grid, reel, draws, it0 + i,
                                                 lcfg, optimizer)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    copies = (pe.interleaved_table.copies - copies) / (LEVER_WARMUP + LEVER_STEPS)
    peak = _peak_mib(device)
    it = it0 + LEVER_WARMUP + LEVER_STEPS
    draws = tps.draw_train_step(tps.step_generators(cs.SEED, it)[0], lcfg, reel)
    prof = _profiled(cs, device, "lever_step", lambda: tps.train_step(
        params, opt_state, grid, reel, draws, it, lcfg, optimizer))
    steps = times[LEVER_WARMUP:]
    return {"ms_all": steps, "ms_median": statistics.median(steps), "peak_mib": peak,
            "interleave_copies_per_step": copies, "profile": prof,
            "profile_hit": _hit_step_profile(cs, device, lcfg, params, grid, reel, it + 2,
                                             "lever_hit_step"),
            "kernels": lever_kernels(cs, device, cfg, params, grid, reel, it + 1)}


def _lod_hashes(device):
    """sha256 of kernel L's cos_fd and sel and of D2's five outputs on
    ``lod_kernels.lever_batch`` (made from a seed, the same on every
    tree)."""
    import hashlib

    from lod_kernels import K, E, lever_batch
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

    smp, sdf, scores, fine, _ = lever_batch(512, device)
    cos_fd, sel = vr.train_lod_select_cuda(smp, sdf, 400.0, 0.6, scores, K, E)
    outs = vr.neus_render_mixed_cuda(smp, sdf, cos_fd, sel, *fine, 400.0, 0.6)

    def sha(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    return {"L_cos_fd": sha([cos_fd]), "L_sel": sha([sel]), "D2": sha(outs)}


def lever_kernels(cs, device, cfg, params, grid, reel, it):
    """Kernels L, D2 and D2' alone at step ``it`` of the recommended profile
    (as chip_smoke's lever phase builds their inputs): CUDA-event ms per
    call over LOD_REPS calls, device ms per launch, and ``_lod_hashes``."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.datasets.tensor_reel import random_rays_from_reel
    from permuto_sdf_tpu_torch.models.fields import rgb_apply, sdf_with_gradient
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    lcfg = cs._lever_cfg(cfg, table_grad_alternate=False)
    ita = it - cfg.nr_iter_sphere_fit
    draws = tps.draw_train_step(tps.step_generators(cs.SEED, it)[0], lcfg, reel).to(device)
    o, d, _, _, _ = random_rays_from_reel(reel, lcfg.nr_rays, indices=draws.ray_indices)
    with torch.no_grad():
        if "t_entry" in inspect.signature(tps._create_fg_samples).parameters:
            # a tree whose sampler takes the bound's range from its caller
            _, te, _, tx, _ = tps.BOUND.ray_intersection(o, d)
            smp = tps._create_fg_samples(params, grid, o, d, te, tx, ita, lcfg, draws)[0]
        else:
            smp = tps._create_fg_samples(params, grid, o, d, ita, lcfg, draws)[0]
    R, S = smp.mask.shape
    K, E = tps._train_lod(lcfg)
    car = tps._map_range_f32(ita, 0.0, cfg.forced_variance_finish_iter, 0.0, 1.0)
    inv_s = vr.variance_inv_s(params["variance"], tps._map_range_f32(
        ita, 0.0, cfg.forced_variance_finish_iter, 0.3, cfg.forced_variance_finish))
    args = (smp, smp.sdf, inv_s, car, draws.lod_scores, K, E)
    cos_fd, sel = vr.train_lod_select_cuda(*args)
    fine = (torch.arange(R, device=device)[:, None] * S + sel).reshape(-1)
    pos_c, dirs_c = smp.flat_positions()[fine], smp.flat_dirs()[fine]
    with torch.no_grad():
        sdf_c, grads_c, geom_c = sdf_with_gradient(params["sdf"], pos_c, ita, lcfg.sdf_model)
        rgb_c = rgb_apply(params["rgb"], pos_c, dirs_c, grads_c, geom_c, ita, lcfg.rgb_model)
    margs = (smp, smp.sdf, cos_fd, sel, sdf_c, grads_c, rgb_c, inv_s, car)
    rng = np.random.default_rng(cs.SEED + 6)
    cots = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
            for shape in ((R, S), (R, 1), (R,), (R, 3), (R, 3))]
    calls = {"L": lambda: vr.train_lod_select_cuda(*args),
             "D2": lambda: vr.neus_render_mixed_cuda(*margs),
             "D2'": lambda: vr.neus_render_mixed_bwd_cuda(*margs, *cots)}
    out = {"R": R, "S": S, "K": K, "E": E, "valid_samples": int(smp.mask.sum())}
    for name, fn in calls.items():
        out[f"{name}_ms"] = cs.time_ms(fn, LOD_REPS, device)
        out[f"{name}_device_ms_per_launch"] = cs.device_ms(fn, name, device, reps=LOD_REPS,
                                                           per_launch=True)
    out["hashes"] = _lod_hashes(device)
    print(f"[lever kernels] {json.dumps(out)}", flush=True)
    return out


def frame_path(cs, device, cfg, frames):
    import torch

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    params = cs.plant_plane_sdf(tps.init_params(cs.SEED, cfg, device=device))
    grid = tps.og.make_occupancy_grid(cfg.grid, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    _, _, times = cs.slice_phase(device, cfg, params, {"full": grid}, cs.WIDTH, cs.HEIGHT,
                                 cs.CHUNK, frames=frames)
    peak = _peak_mib(device)
    prof = _profiled(cs, device, "frame", lambda: tps.render_image(
        params, grid, *cs.camera(), cs.WIDTH, cs.HEIGHT, cs.ITER, cfg, chunk=cs.CHUNK,
        device=device))
    t = times["full"]
    return {"ms_all": t, "ms_median": statistics.median(t), "peak_mib": peak, "profile": prof}


def train_path(cs, device, cfg):
    import torch

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    torch.cuda.reset_peak_memory_stats(device)
    params, grid, reel, _, summary = cs.train_phase(device, cfg)
    peak = _peak_mib(device)
    optimizer = tps.make_optimizer(cfg)
    opt_state = optimizer.init(params)
    it = cfg.nr_iter_sphere_fit + cs.TRAIN_FROM + 100
    draws = tps.draw_train_step(tps.step_generators(cs.SEED, it)[0], cfg, reel)
    tps.train_step(params, opt_state, grid, reel, draws, it, cfg, optimizer)  # warm-up
    prof = _profiled(cs, device, "step", lambda: tps.train_step(
        params, opt_state, grid, reel, draws, it + 1, cfg, optimizer))
    return params, grid, reel, {
        "ms_all": summary["ms_per_step_all"], "ms_median": summary["ms_per_step_median"],
        "peak_mib": peak, "interleave_copies_per_step": summary.get("interleave_copies_per_step"),
        "profile": prof, "profile_hit": _hit_step_profile(cs, device, cfg, params, grid, reel,
                                                          it + 2, "hit_step"),
        "D'_alone": _weights_bwd_alone(cs, device)}


def _hit_step_profile(cs, device, cfg, params, grid, reel, it, what):
    """One step of ``cfg`` with hit-ray compaction at HIT_FRAC (H1 takes the
    bucket's rays, H2 scatters them back, H1 again in its backward) under
    torch.profiler, after a warm-up step."""
    import dataclasses

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    hcfg = dataclasses.replace(cfg, hit_ray_frac=HIT_FRAC)
    optimizer = tps.make_optimizer(hcfg)
    opt_state = optimizer.init(params)
    draws = tps.draw_train_step(tps.step_generators(cs.SEED, it)[0], hcfg, reel)
    tps.train_step(params, opt_state, grid, reel, draws, it, hcfg, optimizer)  # warm-up
    return _profiled(cs, device, what, lambda: tps.train_step(
        params, opt_state, grid, reel, draws, it + 1, hcfg, optimizer))


def gridfree_path(cs, device, cfg, params, reel, it):
    """One flagship step with ``use_occupancy_grid=False`` under
    torch.profiler, after a warm-up step."""
    import dataclasses

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    gcfg = dataclasses.replace(cfg, use_occupancy_grid=False)
    optimizer = tps.make_optimizer(gcfg)
    opt_state = optimizer.init(params)
    draws = tps.draw_train_step(tps.step_generators(cs.SEED, it)[0], gcfg, reel)
    tps.train_step(params, opt_state, None, reel, draws, it, gcfg, optimizer)  # warm-up
    return _profiled(cs, device, "gridfree_step", lambda: tps.train_step(
        params, opt_state, None, reel, draws, it + 1, gcfg, optimizer))


def refresh_path(cs, device, cfg):
    """The flagship grid refresh: ``occupancy_update`` with random weights
    from chip_smoke's seed at REFRESH_ITER (the jitter drawn from a CPU
    generator and copied to the card, as ``train`` does), host clock per
    call (median of REFRESH_CALLS after two warm-up calls), one call under
    torch.profiler (device busy ms, device launches, each kernel's ms and
    launches), and the jitter's draw and copy alone (host clock)."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    params = tps.init_params(cs.SEED, cfg, device=device)
    params["sdf"]["encoding"]["lattice_values"].mul_(1e3)  # a trained table's magnitude
    grid = og.make_occupancy_grid(cfg.grid, device=device)
    n = cfg.grid_nr_random_samples

    def call(i):
        tps.occupancy_update(params, grid, torch.Generator().manual_seed(cs.SEED + i),
                             REFRESH_ITER + i * cfg.grid_update_every, cs.INV_S_TRAINED, cfg)

    def draw(i):
        return (torch.rand((n, 3), generator=torch.Generator().manual_seed(cs.SEED + i))
                - 0.5).to(device)

    host, jitter = [], []
    for i in range(REFRESH_CALLS + 2):
        for fn, out in ((call, host), (draw, jitter)):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize(device)
            out.append((time.perf_counter() - t0) * 1e3)
    host, jitter = host[2:], jitter[2:]
    prof = _profiled(cs, device, "refresh", lambda: call(REFRESH_CALLS + 2))
    out = {"host_ms_all": host, "host_ms_median": statistics.median(host),
           "jitter_host_ms_all": jitter, "jitter_host_ms_median": statistics.median(jitter),
           "profile": prof}
    print(f"[refresh] {json.dumps({k: v for k, v in out.items() if k != 'profile'})}",
          flush=True)
    out["nerf"] = nerf_refresh_path(cs, device)
    return out


def nerf_refresh_path(cs, device):
    """NeRF's grid refresh: ``train_nerf.occupancy_update`` at
    ``NerfTrainConfig()`` with random weights from chip_smoke's seed (the
    table scaled by NERF_REFRESH_TABLE_SCALE, the density's bias moved by
    NERF_REFRESH_BIAS_SHIFT), the jitter drawn from a CPU generator and
    copied to the card as ``train`` does: host clock per call (median of
    REFRESH_CALLS after two warm-up calls), one call under torch.profiler,
    and the jitter's draw and copy alone (host clock)."""
    import torch

    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.train import train_nerf as tn

    ncfg = tn.NerfTrainConfig()
    params = tn.init_params(cs.SEED, ncfg, 1, device=device)
    params["model"]["encoding"]["lattice_values"].mul_(NERF_REFRESH_TABLE_SCALE)
    params["model"]["mlp_feat_and_density"][-1]["b"][0] += NERF_REFRESH_BIAS_SHIFT
    grid = og.make_occupancy_grid(ncfg.grid, device=device)
    n = ncfg.grid_nr_random_samples

    def call(i):
        tn.occupancy_update(params, grid, torch.Generator().manual_seed(cs.SEED + i),
                            i * ncfg.grid_update_every, ncfg)

    def draw(i):
        return (torch.rand((n, 3), generator=torch.Generator().manual_seed(cs.SEED + i))
                - 0.5).to(device)

    host, jitter = [], []
    for i in range(REFRESH_CALLS + 2):
        for fn, out in ((call, host), (draw, jitter)):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize(device)
            out.append((time.perf_counter() - t0) * 1e3)
    host, jitter = host[2:], jitter[2:]
    prof = _profiled(cs, device, "nerf_refresh", lambda: call(REFRESH_CALLS + 2))
    out = {"host_ms_all": host, "host_ms_median": statistics.median(host),
           "jitter_host_ms_all": jitter, "jitter_host_ms_median": statistics.median(jitter),
           "occupied_share": float(grid.occupancy.float().mean()), "profile": prof}
    print(f"[nerf refresh] {json.dumps({k: v for k, v in out.items() if k != 'profile'})}",
          flush=True)
    return out


def _weights_bwd_alone(cs, device, R=512, reps=20):
    """Kernel D' alone at the flagship step's shapes (R rays, NeuS at S = 96
    and NeRF at S = 32) on ``lod_kernels.weights_bwd_batch`` (made from a
    seed): CUDA-event ms per call and device ms per launch among the
    profiler's records."""
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lod_kernels

    out = {}
    for label, mode, S in (("neus_96", 0, 96), ("nerf_32", 1, 32)):
        args = lod_kernels.weights_bwd_batch(R, device, mode=mode, S_bwd=S)
        fn = lambda args=args: vr.render_weights_bwd_cuda(*args)  # noqa: E731
        out[f"{label}_ms"] = cs.time_ms(fn, reps, device)
        out[f"{label}_device_ms_per_launch"] = cs.device_ms(fn, "D'", device, reps=reps,
                                                            per_launch=True)
    print(f"[D' alone] {json.dumps(out)}", flush=True)
    return out


def sdf_from_mesh_path(cs, device):
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.datasets.mesh_io import make_uv_sphere, sample_points_on_mesh
    from permuto_sdf_tpu_torch.models.fields import sdf_apply
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc
    from permuto_sdf_tpu_torch.ops.ray_primitives import AABB
    from permuto_sdf_tpu_torch.train import train_sdf_from_mesh as tsm

    gt = make_uv_sphere(radius=0.3)
    tsm.train(gt, nr_iters=1, log_every=1, device=device)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    walls = {}
    for steps in (SDF_SHORT, SDF_STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, mcfg, _ = tsm.train(gt, nr_iters=steps, log_every=100, seed=cs.SEED,
                                    device=device)
        torch.cuda.synchronize(device)
        walls[steps] = time.perf_counter() - t0
    peak = _peak_mib(device)
    ms_step = (walls[SDF_STEPS] - walls[SDF_SHORT]) * 1e3 / (SDF_STEPS - SDF_SHORT)

    pts, nrm = (torch.from_numpy(a).to(device) for a in
                sample_points_on_mesh(gt, 300_000, np.random.default_rng(cs.SEED)))
    aabb = AABB()
    lo = torch.tensor(aabb.min_corner, device=device)
    hi = torch.tensor(aabb.max_corner, device=device)
    optimizer = tsm.make_optimizer()
    opt_state = optimizer.init(params)

    def step(it):
        idx, u = tsm.draw_step(tsm.step_generators(cs.SEED, it)[0], 3000, 30000, 300_000)
        tsm.train_step(params, opt_state, idx, u, pts, nrm, it, mcfg, optimizer, lo, hi)

    step(SDF_STEPS)  # warm-up
    prof = _profiled(cs, device, "sdf_from_mesh_step", lambda: step(SDF_STEPS + 1))

    fn = lambda p: sdf_apply(params, p, 9_999_999, mcfg)[0]  # noqa: E731
    spacing = (1.0 / (MESH_RES - 1),) * 3
    meshes = []
    for _ in range(MESH_REPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        grid = mc.sdf_grid(fn, MESH_RES, -0.5, 0.5, device=device)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        mc.marching_tetrahedra(grid, 0.0, (-0.5,) * 3, spacing)
        torch.cuda.synchronize(device)
        meshes.append({"grid_ms": (t1 - t0) * 1e3, "mesh_ms": (time.perf_counter() - t0) * 1e3})
        del grid
    return {"ms_per_step": ms_step, "peak_mib": peak, "profile": prof,
            "mesh_512": meshes}


def nerf_path(cs, device, reel):
    import torch

    from permuto_sdf_tpu_torch.train import train_nerf as tn
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    ncfg = tn.NerfTrainConfig()
    tn.train(reel, ncfg, nr_iters=1, seed=cs.SEED, device=device)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    walls = {}
    for steps in (NERF_SHORT, NERF_STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, grid, _ = tn.train(reel, ncfg, nr_iters=steps, seed=cs.SEED, log_every=100,
                                   device=device)
        torch.cuda.synchronize(device)
        walls[steps] = time.perf_counter() - t0
    peak = _peak_mib(device)
    ms_step = (walls[NERF_STEPS] - walls[NERF_SHORT]) * 1e3 / (NERF_STEPS - NERF_SHORT)
    optimizer = tn.make_optimizer(ncfg)
    opt_state = optimizer.init(params)

    def step(it):
        tn.train_step(params, opt_state, grid, reel, tps.step_generators(cs.SEED, it)[0], it,
                      ncfg, optimizer)

    step(NERF_STEPS)  # warm-up
    prof = _profiled(cs, device, "nerf_step", lambda: step(NERF_STEPS + 1))
    return {"ms_per_step": ms_step, "peak_mib": peak, "profile": prof}


def mesh_path(cs, device, cfg):
    """Kernel M on the sphere scene's grids: the tree's M1, M2 and welding
    glue, and the whole of M."""
    import torch

    from permuto_sdf_tpu_torch.models.fields import sdf_apply
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc

    params, _, _ = cs.sphere_scene(device, cfg)
    out = {}
    for res in M_RES:
        grid_runs = []
        for _ in range(M_GRID_CALLS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            grid = mc.sdf_grid(lambda p: sdf_apply(params["sdf"], p, cs.ITER, cfg.sdf_model)[0],
                               res, -0.5, 0.5, device=device)
            torch.cuda.synchronize(device)
            grid_runs.append((time.perf_counter() - t0) * 1e3)
        origin, spacing = (-0.5,) * 3, (1.0 / (res - 1),) * 3
        counted = mc.mt_count_cuda(grid, 0.0)
        offsets, T = mc.mt_offsets(counted[1])
        if hasattr(mc, "weld_first"):  # M2 welds in its hash table; ranking glue after it
            def m2():
                return mc.mt_emit_cuda(grid, 0.0, *counted, offsets, T, origin, spacing)

            emitted = m2()
            glue = lambda: mc.weld_first(emitted[0], emitted[3], emitted[2],  # noqa: E731
                                         emitted[4])
        else:  # M2 emits per cube; torch.unique, a scatter-min and argsort weld
            def m2():
                return mc.mt_emit_cuda(grid, 0.0, counted[0], offsets, T, origin, spacing)

            emitted = m2()
            glue = lambda: mc.weld(*emitted)  # noqa: E731

        def m1():
            return mc.mt_count_cuda(grid, 0.0)

        def whole():
            return mc.marching_tetrahedra_cuda(grid, 0.0, origin, spacing)

        V, F = whole()
        key = f"M{res}"
        r = {"triangles": T, "V": V.shape[0], "F": F.shape[0]}
        for name, fn in (("m1", m1), ("m2", m2), ("weld", glue), ("m", whole)):
            r[name + "_ms"] = cs.time_ms(fn, 20, device)
        r["m1_device_ms"] = _device_ms(cs, device, m1, "M1")[0]
        r["m2_device_ms"], r["m2_call_device_ms"] = _device_ms(cs, device, m2, "M2")
        host = []
        for _ in range(M_HOST_CALLS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            whole()
            torch.cuda.synchronize(device)
            host.append((time.perf_counter() - t0) * 1e3)
        r["m_host_ms"] = statistics.median(host)
        r["grid_ms"] = statistics.median(grid_runs[1:])  # the first call also warms up
        r["mesh_ms"] = r["grid_ms"] + r["m_host_ms"]
        r["profile"] = _profiled(cs, device, f"mesh_{res}", whole)
        print(f"[mesh {res}^3] T={T} V={V.shape[0]} F={F.shape[0]}: M1 {r['m1_ms']:.4f} ms "
              f"(device {r['m1_device_ms']}), M2 {r['m2_ms']:.4f} (device "
              f"{r['m2_device_ms']}), weld glue {r['weld_ms']:.4f}, whole M {r['m_ms']:.4f} "
              f"(host clock {r['m_host_ms']:.4f}); grid SDF {r['grid_ms']:.2f}, mesh "
              f"{r['mesh_ms']:.2f}", flush=True)
        out[key] = r
        del grid, counted, emitted
    return out


def _numbers(res, prefix=""):
    """The result's scalar numbers by dotted key; a list of frame or step
    times counts as its median."""
    out = {}
    for k, v in res.items():
        key = prefix + k
        if isinstance(v, dict):
            out.update(_numbers(v, key + "."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = v
        elif k == "mesh_512":
            for name in ("grid_ms", "mesh_ms"):
                out[f"{key}.{name}"] = statistics.median(m[name] for m in v)
    return out


def summarize(files):
    """One line per number: for each label, the median over its runs and
    the range."""
    runs = {}
    for f in files:
        with open(f) as fh:
            res = json.loads(fh.read())["encode_paths"]
        runs.setdefault(res["tree"], []).append(_numbers(res))
    print("runs: " + ", ".join(f"{label} {len(rs)}" for label, rs in runs.items()))
    for k in sorted(set().union(*(r for rs in runs.values() for r in rs))):
        cells = []
        for label, rs in runs.items():
            v = [r[k] for r in rs if k in r]
            cells.append(f"{label} {statistics.median(v):.6g} [{min(v):.6g}, {max(v):.6g}]"
                         if v else f"{label} -")
        print(f"{k}: " + "; ".join(cells))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--summarize", nargs="+", metavar="FILE", default=None)
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated sections to run, of " + ",".join(PATHS))
    args = ap.parse_args(argv)
    if args.summarize:
        summarize(args.summarize)
        return 0
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_encode_paths: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    if not os.path.dirname(os.path.abspath(cs.__file__)) == root:
        print(f"torch_encode_paths: chip_smoke not found under {root}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    device = torch.device("cuda")
    cfg = tps.PermutoSDFTrainConfig()
    paths = set(args.paths.split(","))
    if not paths <= set(PATHS):
        print(f"torch_encode_paths: unknown --paths {sorted(paths - set(PATHS))}",
              file=sys.stderr)
        return 2
    res = {"tree": args.label or root, "card": cs.card_line()}
    if "host" in paths:
        res["host"] = host_costs(device, cfg)
    if "events" in paths:
        res["events"] = event_costs(cs, device)
    if "fg" in paths:
        res["fg"] = fg_costs(cs, device, cfg)
    if "grid" in paths:
        res["grid"] = grid_costs(cs, device, cfg)
    if "plain" in paths:
        res["plain"] = plain_path(cs, device, cfg, args.frames)
    if "frame" in paths:
        res["frame"] = frame_path(cs, device, cfg, args.frames)
    if "sphere" in paths:
        res["sphere"] = sphere_path(cs, device, cfg, args.frames)
    if paths & {"train", "gridfree", "lever", "nerf"}:
        params, grid, reel, res["train"] = train_path(cs, device, cfg)
        if "gridfree" in paths:
            res["gridfree"] = gridfree_path(cs, device, cfg, params, reel,
                                            cfg.nr_iter_sphere_fit + cs.TRAIN_FROM + 110)
        if "lever" in paths:
            res["lever"] = lever_path(cs, device, cfg, params, grid, reel)
        if "nerf" in paths:
            res["nerf"] = nerf_path(cs, device, reel)
    if "sdf" in paths:
        res["sdf_from_mesh"] = sdf_from_mesh_path(cs, device)
    if "mesh" in paths:
        res["mesh"] = mesh_path(cs, device, cfg)
    if "refresh" in paths:
        res["refresh"] = refresh_path(cs, device, cfg)
    line = json.dumps({"encode_paths": res})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
