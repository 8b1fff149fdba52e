#!/usr/bin/env python3
"""Kernel C3 as the port runs it (pass 1 reads the grid's Chebyshev distance
field) beside the design it replaced, whose pass 1 read a coarse grid (a
byte per 8^3 block, ``profiling/c3_coarse_variant.cu``), on one GPU.

    python3 profiling/c3_designs.py [--out FILE]

Builds the coarse design with the port's nvcc flags into the port's build
directory, makes chip_smoke's sphere scene, and on ``chebyshev_grids``
(the scene's grid, empty, random sparse, full) at the plain frame's
PT_CHUNK-ray chunk and on the whole 400² view (P = 512) checks both
designs against ``first_occupied_plain`` exactly and times each (CUDA
events and device ms in the kernel's own symbols, the two designs in
turns, twice each). Also times each design's table build once per grid
state: the distance field at the tracers' cap (kernel J0) and the coarse
grid. Prints one JSON line, also written to ``--out``.
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
SOURCE = os.path.join(ROOT, "profiling", "c3_coarse_variant.cu")


def _build(kernels):
    """The coarse design's shared library (built once per source hash)."""
    out = kernels.build_dir() / "libc3_coarse_variant.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(out), SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed on the coarse design:\n" + res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.psdf_coarse_occupancy.argtypes = [_I, _P, _P, _P]
    lib.psdf_first_occupied_coarse.argtypes = ([_I] + [_P] * 6 + [_I] + [_F] * 5 + [_I]
                                               + [_P] * 3)
    lib.psdf_coarse_occupancy.restype = lib.psdf_first_occupied_coarse.restype = _I
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("c3_designs: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    device = torch.device("cuda:0")
    kernels.build()
    lib = _build(kernels)
    cs.KERNEL_SYMBOLS["C3_coarse"] = "first_occupied_coarse_kernel"
    cs.KERNEL_SYMBOLS["C3_coarse_build"] = "coarse_occupancy_kernel"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tps.PermutoSDFTrainConfig()
    params, grid, _ = cs.sphere_scene(device, cfg)
    gcfg, P = cfg.grid, 512
    V = gcfg.nr_voxels_per_dim
    K, tf = cs.camera_k(cs.WIDTH, cs.HEIGHT)
    o, d = rays_from_frame(K, tf, cs.WIDTH, cs.HEIGHT, device=device)
    _, te, _, tx, _ = tps.BOUND.ray_intersection(o, d)
    R, chunk = o.shape[0], cs.PT_CHUNK
    mid = (R // 2 // chunk) * chunk
    rays = {"chunk": tuple(t[mid:mid + chunk].contiguous() for t in (o, d, te, tx)),
            "view": (o, d, te, tx)}
    half = gcfg.grid_extent / 2.0
    trans = [float(v) for v in gcfg.grid_translation]

    def coarse_build(occ):
        coarse = torch.empty(((V + 7) // 8) ** 3, dtype=torch.bool, device=device)
        err = lib.psdf_coarse_occupancy(V, kernels.ptr(occ), kernels.ptr(coarse),
                                        kernels.current_stream(device))
        kernels.check(lib, err, "coarse grid (the coarse design)")
        return coarse

    def coarse_design(occ, coarse, ro, rd, rte, rtx):
        n = ro.shape[0]
        t_first = torch.empty((n,), dtype=torch.float32, device=device)
        has = torch.empty((n,), dtype=torch.bool, device=device)
        err = lib.psdf_first_occupied_coarse(
            n, *(kernels.ptr(x) for x in (ro, rd, rte.reshape(-1), rtx.reshape(-1), occ,
                                          coarse)),
            V, half, *trans, gcfg.voxel_size, P, kernels.ptr(t_first), kernels.ptr(has),
            kernels.current_stream(device))
        kernels.check(lib, err, "first occupied probe (the coarse design)")
        return t_first, has

    out = {"card": cs.card_line(), "grids": {}}
    for label, occ in cs.chebyshev_grids(device, gcfg, grid.occupancy).items():
        field = og.chebyshev_empty_distance(gcfg, occ, st._EMPTY_DIST_CAP)
        coarse = coarse_build(occ)
        if not torch.equal(coarse, og.downsample_occupancy(gcfg, occ, 8)):
            print(f"c3_designs: the coarse grid differs on the {label} grid", file=sys.stderr)
            return 1
        res = {"build_ms": {
            "field": cs.time_ms(lambda: og.chebyshev_empty_distance(gcfg, occ,
                                                                    st._EMPTY_DIST_CAP),
                                5, device),
            "coarse": cs.time_ms(lambda: coarse_build(occ), 20, device)},
            "build_device_ms": {
            "field": cs.device_ms(lambda: og.chebyshev_empty_distance(gcfg, occ,
                                                                      st._EMPTY_DIST_CAP),
                                  "J0", device),
            "coarse": cs.device_ms(lambda: coarse_build(occ), "C3_coarse_build", device)}}
        for shape, rs in rays.items():
            want = og.first_occupied_plain(gcfg, occ, *rs, P)
            designs = {"field": (lambda: og.first_occupied_cuda(gcfg, occ, *rs, P,
                                                                dist_field=field), "C3"),
                       "coarse": (lambda: coarse_design(occ, coarse, *rs), "C3_coarse")}
            for name, (fn, _) in designs.items():
                got = fn()
                if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
                    print(f"c3_designs: the {name} design differs from the plain version on "
                          f"the {label} grid ({shape})", file=sys.stderr)
                    return 1
            times = {k: {"ms": [], "device_ms": []} for k in designs}
            for _ in range(2):  # the designs in turns
                for name, (fn, sym) in designs.items():
                    times[name]["ms"].append(cs.time_ms(fn, 20, device))
                    times[name]["device_ms"].append(cs.device_ms(fn, sym, device))
            res[shape] = {k: {"ms": statistics.median(v["ms"]), "device_ms": v["device_ms"]}
                          for k, v in times.items()}
            res[shape]["has"] = int(want[1].sum())
            print(f"[c3 designs] {label} {shape}: " + ", ".join(
                f"{k} ms {v['ms']:.5f} device {v['device_ms']}" for k, v in res[shape].items()
                if k != "has") + f"; builds {res['build_ms']}, device {res['build_device_ms']}",
                flush=True)
        out["grids"][label] = res
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
