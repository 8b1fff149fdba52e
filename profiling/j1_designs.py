#!/usr/bin/env python3
"""Kernel J1 (the tracer's jump prepass) as the port runs it beside the
block shapes and load forms it was measured against, and the kernel it
replaced (``profiling/j1_variants.cu``), alone and inside the fast
sphere-traced frame, on one GPU.

    python3 profiling/j1_designs.py [--turns 3] [--frames 3] [--out FILE]

Builds the variants with the port's nvcc flags into the port's build
directory and makes chip_smoke's sphere scene. On the padded state of the
400x400 view (R = 196,608 rows, as chip_smoke's sphere phase builds it):
checks every design against the port's launch (t, the flags and the count;
designs 0-5 also round 0's list) bit for bit, then in ``--turns`` turns
times each alone (CUDA-event ms per call and device ms per call among the
profiler's records, from a restored state) and, for designs 0-5, inside
``render_image_sphere_traced_fast`` at chip_smoke's operating point (the
port's J1 launch routed to the design): ``--frames`` frames under
torch.profiler, the device ms per call of J1 (its two kernels), A and J2f
and the frame's device busy ms. Prints one JSON line, also
written to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "profiling", "j1_variants.cu")
DESIGNS = {0: "256 rows a block (the port)", 1: "128 rows a block", 2: "512 rows a block",
           3: "256 rows, the field's loads under L2 evict_last",
           4: "256 rows, the rows' state staged in shared memory",
           5: "256 rows, evict_last and the state staged",
           6: "the replaced kernel: a thread a row, an atomic count, no list"}
LIST_DESIGNS = (0, 1, 2, 3, 4, 5)
JUMPS, REPS = 16, 20


def _build(kernels):
    out = kernels.build_dir() / "libj1_variants.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(out), SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed on the J1 variants:\n" + res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    fn = lib.psdf_jump_prepass_design
    fn.argtypes = [ctypes.c_int] + kernels.SIGNATURES["sphere_trace"]["psdf_jump_prepass"]
    fn.restype = ctypes.c_int
    return lib


class _Routed:
    """The sphere_trace library with its J1 launch routed to one design."""

    def __init__(self, lib, variants, design):
        self._lib, self._variants, self._design = lib, variants, design

    def psdf_jump_prepass(self, *args):
        return self._variants.psdf_jump_prepass_design(self._design, *args)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("j1_designs: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    variants = _build(kernels)
    port = kernels.load("sphere_trace")
    cs.KERNEL_SYMBOLS["J1_rowwise"] = "jump_prepass_rowwise_kernel"
    cs.KERNEL_SYMBOLS["J1"] += ("jump_prepass_form_kernel",)  # designs 3-5
    # designs 0-5 launch two kernels a call: device ms per call
    launches = {k: 1 if k == 6 else 2 for k in DESIGNS}
    cfg = tps.PermutoSDFTrainConfig()
    gcfg = cfg.grid
    params, grid, _ = cs.sphere_scene(device, cfg)
    field = tps._cached_dist_field(gcfg, grid)

    K, tf = cs.camera_k(cs.WIDTH, cs.HEIGHT)
    o, d = rays_from_frame(K, tf, cs.WIDTH, cs.HEIGHT, device=device)
    R = st.pow2_bucket(o.shape[0], lo=256, hi=1 << 21)
    pad = R - o.shape[0]
    o = torch.cat([o, torch.tensor([[10.0, 0.0, 0.0]], device=device).expand(pad, 3)])
    d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]], device=device).expand(pad, 3)])
    _, te, _, tx, hit = tps.BOUND.ray_intersection(o, d)
    state0 = {"origins_f": st._padded(o), "dirs_f": st._padded(d),
              "texit_f": st._padded(tx[:, 0]), "t_f": st._padded(te[:, 0]),
              "alive_f": st._padded(hit[:, 0], False)}
    work = {k: v.clone() for k, v in state0.items()}
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    idx = torch.empty((R,), dtype=torch.int64, device=device)
    tile_counts = torch.empty((-(-(R + 1) // 128),), dtype=torch.int32, device=device)

    def restore():
        for k, v in work.items():
            v.copy_(state0[k])

    def launch(design, s):
        count.zero_()
        err = variants.psdf_jump_prepass_design(
            design, R + 1, R, R, kernels.ptr(field), *st._grid_scalars(gcfg), st._EMPTY_DIST_CAP,
            *(kernels.ptr(s[k]) for k in ("origins_f", "dirs_f", "texit_f", "t_f", "alive_f")),
            JUMPS, kernels.ptr(count), kernels.ptr(idx), kernels.ptr(tile_counts),
            kernels.current_stream(device))
        kernels.check(variants, err, f"J1 design {design}")

    ref = {k: v.clone() for k, v in state0.items()}
    n_ref, idx_ref = st.jump_prepass_cuda(field, *(ref[k] for k in state0), gcfg, JUMPS)
    checks = {}
    for design in DESIGNS:
        s = {k: v.clone() for k, v in state0.items()}
        launch(design, s)
        torch.cuda.synchronize(device)
        same = all(torch.equal(s[k], ref[k]) for k in ("t_f", "alive_f"))
        same = same and int(count) == int(n_ref)
        if design in LIST_DESIGNS:
            same = same and torch.equal(idx, idx_ref)
        checks[design] = same
        if not same:
            print(f"j1_designs: design {design} differs from the port's J1", file=sys.stderr)
            return 1

    restore_ms = cs.time_ms(restore, REPS, device)
    alone = {k: {"ms": [], "device_ms_per_call": []} for k in DESIGNS}
    frame = {k: {"J1": [], "A": [], "J2f": [], "busy": []} for k in LIST_DESIGNS}

    def run(design):
        restore()
        launch(design, work)

    def render():
        tps.render_image_sphere_traced_fast(params, grid, K, tf, cs.WIDTH, cs.HEIGHT, cs.ITER,
                                            cfg, device=device, **cs.ST_KW)

    for _ in range(args.turns):
        for design in DESIGNS:
            sym = "J1_rowwise" if design == 6 else "J1"
            alone[design]["ms"].append(
                cs.time_ms(lambda: run(design), REPS, device) - restore_ms)
            alone[design]["device_ms_per_call"].append(
                cs.device_ms(lambda: run(design), sym, device, reps=REPS, per_launch=True,
                             launches=launches[design]))
        for design in LIST_DESIGNS:
            kernels._loaded["sphere_trace"] = _Routed(port, variants, design)
            try:
                render()
                torch.cuda.synchronize(device)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.frames):
                        render()
                    torch.cuda.synchronize(device)
            finally:
                kernels._loaded["sphere_trace"] = port
            for name, per in (("J1", 2), ("A", 1), ("J2f", 1)):  # device ms a call
                ev = cs._kernel_events(prof, name)
                n = sum(e.count for e in ev)
                frame[design][name].append(sum(cs._dev_us(e) for e in ev) / 1e3 / n * per
                                           if n else None)
            busy = sum(cs._dev_us(e) for e in prof.key_averages()
                       if str(getattr(e, "device_type", "")).endswith("CUDA"))
            frame[design]["busy"].append(busy / 1e3 / args.frames)

    def med(xs):
        xs = [x for x in xs if x is not None]
        return statistics.median(xs) if xs else None

    out = {"card": cs.card_line(), "R": R, "jumps": JUMPS, "alive_before": int(hit.sum()),
           "alive_after": int(n_ref), "designs": DESIGNS, "bit_equal": checks,
           "alone": {k: dict(v, ms_median=med(v["ms"]),
                             device_ms_median=med(v["device_ms_per_call"]))
                     for k, v in alone.items()},
           "frame": {k: dict(v, **{f"{n}_median": med(v[n]) for n in ("J1", "A", "J2f", "busy")})
                     for k, v in frame.items()}}
    line = json.dumps({"j1_designs": out})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
