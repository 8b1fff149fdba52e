#!/usr/bin/env python3
"""Kernel C2 (the bound sphere's intersection and the uniform fg samples in
one launch) as the port runs it beside the thread mappings measured
against it (``profiling/c2_variants.cu``), on one GPU.

    python3 profiling/c2_designs.py [--turns 2] [--out FILE]

Builds the variants with the port's nvcc flags into the port's build
directory. On the NeRF and flagship step's rays (R = 512 of chip_smoke's
synthetic reel, S = 64, the step's jitter; ``chip_smoke.nerf_kernel_phases``
draws the same) and on chip_smoke's batch with misses (``_c2_rays``), it
checks each design against ``samples_fg_sphere_plain`` bit for bit and
times each (CUDA events over REPS calls and device ms per launch in C2's
symbols, the designs in turns, ``--turns`` times): 0 the port's (one
flat index divided by S, a thread a slot), 1 a block row a ray and a
thread a slot, 2 a block row a ray at four slots a thread. Prints one
JSON line, also written to ``--out``; exits 1 if a design's output
differs.
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
SOURCE = os.path.join(ROOT, "profiling", "c2_variants.cu")
DESIGNS = {0: "flat index / S, a slot a thread (the port's)",
           1: "block row a ray, a slot a thread", 2: "block row a ray, four slots a thread"}
REPS = 20


def variants_lib(kernels):
    out = kernels.build_dir() / "libc2_variants.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(out), SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed on c2_variants.cu:\n" + res.stdout + res.stderr)
    lib = kernels.declare(ctypes.CDLL(str(out)), "ray_sampler")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.psdf_samples_fg_design.argtypes = [I, I, I, P, P, P] + [F] * 5 + [P] * 8
    lib.psdf_samples_fg_design.restype = I
    return lib


def run_design(lib, kernels, design, o, d, sphere, min_dist, S, start):
    """Design ``design`` of kernel C2 -> samples_fg_sphere_plain's seven
    outputs."""
    import torch

    R, dev = o.shape[0], o.device
    outs = [torch.empty((R, S), dtype=torch.float32, device=dev),
            torch.empty((R, S), dtype=torch.float32, device=dev),
            torch.empty((R, S), dtype=torch.bool, device=dev),
            torch.empty((R,), dtype=torch.float32, device=dev),
            torch.empty((R, 1), dtype=torch.float32, device=dev),
            torch.empty((R, 1), dtype=torch.float32, device=dev),
            torch.empty((R, 1), dtype=torch.bool, device=dev)]
    start = start.reshape(-1).contiguous() if start is not None else None
    err = lib.psdf_samples_fg_design(
        design, R, S, kernels.ptr(o), kernels.ptr(d), kernels.ptr(start),
        *(float(c) for c in sphere.center), float(sphere.radius ** 2), float(min_dist),
        *(kernels.ptr(t) for t in outs), kernels.current_stream(dev))
    kernels.check(lib, err, f"C2, design {design}")
    return outs


def _median(xs):
    """The median of the readings the profiler delivered (None if none)."""
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("c2_designs: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.datasets.synthetic import make_synthetic_reel
    from permuto_sdf_tpu_torch.datasets.tensor_reel import random_rays_from_reel
    from permuto_sdf_tpu_torch.ops import ray_sampler as rs
    from permuto_sdf_tpu_torch.train import train_nerf as tn
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    kernels.build(["ray_sampler"])
    lib = variants_lib(kernels)
    device = torch.device("cuda")
    reel = make_synthetic_reel(device=device)
    ncfg = tn.NerfTrainConfig()
    draws = tn.draw_train_step(tps.step_generators(cs.SEED, 0)[0], ncfg, reel).to(device)
    o, d, _, _, _ = random_rays_from_reel(reel, ncfg.nr_rays, indices=draws.ray_indices,
                                          apply_mask=False)
    S = ncfg.max_nr_samples_per_ray
    batches = {"step": (o, d, tn.BOUND, ncfg.min_dist_between_samples, S, draws.fg_start),
               "misses": (*cs._c2_rays(device, 512), tn.BOUND, 2.0 / S, S, None)}
    ok = True
    for label, bargs in batches.items():
        want = rs.samples_fg_sphere_plain(*bargs)
        for design in DESIGNS:
            got = run_design(lib, kernels, design, *bargs)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"c2_designs: design {design} differs from the plain version ({label})",
                      file=sys.stderr)
                ok = False
    times = {k: {"ms": [], "device_ms": []} for k in DESIGNS}
    bargs = batches["step"]
    for _ in range(args.turns):
        for design in DESIGNS:
            fn = lambda design=design: run_design(lib, kernels, design, *bargs)  # noqa: E731
            times[design]["ms"].append(cs.time_ms(fn, REPS, device))
            times[design]["device_ms"].append(cs.device_ms(fn, "C2", device, per_launch=True))
    out = {"c2_designs": {
        "card": cs.card_line(), "R": o.shape[0], "S": S, "bit_equal": ok,
        "designs": {DESIGNS[k]: {"ms_median": statistics.median(v["ms"]),
                                 "device_ms_median": _median(v["device_ms"]),
                                 "ms": v["ms"], "device_ms": v["device_ms"]}
                    for k, v in times.items()}}}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
