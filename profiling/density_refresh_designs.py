#!/usr/bin/env python3
"""Kernel I2f (NeRF's grid refresh in one launch) as the port runs it
beside the shapes measured against it
(``profiling/density_refresh_variant.cu``) and beside the unfused refresh
it replaced, on one GPU.

    python3 profiling/density_refresh_designs.py [--out FILE]

Builds the variant with the port's nvcc flags into the port's build
directory. At NeRF's refresh (``NerfTrainConfig()``: 65,536 probes of the
64³ grid, the density on all 24 levels, random weights from chip_smoke's
seed with the table and the density's bias moved as chip_smoke's refresh
cases move them, an open c2f window) it checks each shape against the
port's kernel (forms 2-5 bit for bit, the SIMT forms within chip_smoke's
TOL_I2F) and times each (CUDA events and device ms per launch in the
kernel's own symbols, the designs in turns, twice each). Designs (form,
warps a tile of 32 probes, tiles a block; the forms of
``density_refresh_variant.cu``): the port's (form 3: the three 64-wide
layers on the tensor cores in the 3xTF32 split, the weights read through
L1; 4 warps, 2 tiles a block) in other shapes, kernel If's SIMT
evaluation at width 64 with the weights staged by plain loads (form 0, the
first I2f) or by cp.async (1) or read through L1 (6), the tensor cores on
staged weights (2), and the levels' gathers in batches of three (4, 5).
Then kernel A alone on the probes (device ms), and the unfused refresh (entry 1 of kernel I,
``nerf_hash_density``'s kernel A, matmuls, GELUs and softplus, kernel I2):
CUDA-event ms, device busy ms and device launches a call. Prints one JSON
line, also written to ``--out``.
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
SOURCE = os.path.join(ROOT, "profiling", "density_refresh_variant.cu")
# (form, warps a tile, tiles a block); the first is the port's kernel
DESIGNS = ((3, 4, 2), (3, 4, 1), (3, 8, 1), (3, 8, 2), (3, 2, 1), (0, 8, 1), (0, 8, 2),
           (0, 4, 1), (0, 4, 2), (1, 8, 1), (1, 8, 2), (1, 8, 4), (2, 8, 2), (4, 4, 1),
           (4, 8, 1), (5, 8, 2), (6, 8, 1), (6, 4, 1))
ITER = 2501 * 8 + 3  # an open c2f window, an update index past the first 64
DESIGN_KERNELS = "I2f designs"  # the symbols of every form, in chip_smoke's KERNEL_SYMBOLS


def _build(kernels):
    """The variant's shared library (built once per source hash)."""
    out = kernels.build_dir() / "libdensity_refresh_variant.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(out), SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed on the density refresh designs:\n" + res.stdout
                               + res.stderr)
        print("\n".join(line for line in (res.stdout + res.stderr).splitlines()
                        if "density_refresh" in line or "registers" in line), flush=True)
    lib = ctypes.CDLL(str(out))
    _P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.psdf_density_refresh_design.argtypes = ([_I, _U, _I] + [_F] * 5 + [_P] * 2 + [_F] * 2
                                                + [_P] * 2 + [_I, _I, _I, _P])
    lib.psdf_density_refresh_design.restype = _I
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("density_refresh_designs: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.models.fields import _c2f_t
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
    from permuto_sdf_tpu_torch.ops import sdf_net as sn
    from permuto_sdf_tpu_torch.train import train_nerf as tn

    cs.KERNEL_SYMBOLS[DESIGN_KERNELS] = ("density_refresh_kernel", "density_refresh_simt_kernel",
                                         "density_refresh_async_kernel",
                                         "density_refresh_mma_kernel",
                                         "density_refresh_global_kernel")
    device = torch.device("cuda:0")
    kernels.build()
    lib = _build(kernels)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    ncfg = tn.NerfTrainConfig()
    gcfg, fcfg = ncfg.grid, ncfg.fg_model
    n = ncfg.grid_nr_random_samples
    model = cs.refresh_density_params(tn.init_params(cs.SEED, ncfg, 1, device)["model"])
    jitter = (torch.rand((n, 3), generator=torch.Generator().manual_seed(cs.SEED)) - 0.5).to(
        device)
    update_idx = ITER // ncfg.grid_update_every
    refresh = (fcfg, model, ITER, n, update_idx, jitter, ncfg.grid_decay,
               ncfg.grid_occupancy_thresh)
    stream = kernels.current_stream(device)
    tx, ty, tz = (float(v) for v in gcfg.grid_translation)

    def design(form, warps, tiles, grid):
        if (form, warps, tiles) == DESIGNS[0]:
            og.density_refresh_cuda(gcfg, grid, *refresh)
            return
        net, keep = sn.density_net(fcfg, model, ITER, device)  # keep: what net points at
        err = lib.psdf_density_refresh_design(
            n, update_idx, gcfg.nr_voxels_per_dim, gcfg.voxel_size, gcfg.grid_extent / 2.0, tx,
            ty, tz, kernels.ptr(jitter), ctypes.byref(net), ncfg.grid_decay,
            ncfg.grid_occupancy_thresh, kernels.ptr(grid.values), kernels.ptr(grid.occupancy),
            form, warps, tiles, stream)
        kernels.check(lib, err, f"I2f form {form}, {warps} warps, {tiles} tiles a block")

    def name(d):
        return f"f{d[0]}_{d[1]}w_{d[2]}t"

    grids = {d: og.make_occupancy_grid(gcfg, device=device) for d in DESIGNS}
    for d, g in grids.items():
        design(*d, g)
    want = grids[DESIGNS[0]]
    _, lin = og.grid_points_plain(gcfg, n, update_idx, jitter, device)
    lin = lin.long()
    equal, gaps = {}, {}
    for d, g in grids.items():
        equal[name(d)] = (torch.equal(g.values, want.values)
                          and torch.equal(g.occupancy, want.occupancy))
        vk, vp = g.values[lin], want.values[lin]
        differ = g.occupancy[lin] != want.occupancy[lin]
        thresh = ncfg.grid_occupancy_thresh
        tie = (torch.minimum(vk, vp) <= thresh) & (thresh <= torch.maximum(vk, vp))
        gaps[name(d)] = {"max_rel_gap": ((vk - vp).abs() / vp.abs()).max().item(),
                         "flags_differ": int(differ.sum()),
                         "flags_differ_outside_the_tie": int((differ & ~tie).sum())}
    agree = {k: equal[k] or (k.startswith(("f0", "f1", "f6")) and v["max_rel_gap"] <= cs.TOL_I2F
                              and v["flags_differ_outside_the_tie"] == 0)
             for k, v in gaps.items()}
    times = {d: {"ms": [], "device_ms": []} for d in DESIGNS}
    for _ in range(2):  # the shapes in turns
        for d in DESIGNS:
            run = lambda d=d: design(*d, grids[d])  # noqa: E731
            times[d]["ms"].append(cs.time_ms(run, 10, device))
            times[d]["device_ms"].append(cs.device_ms(run, DESIGN_KERNELS, device, reps=5,
                                                      per_launch=True))
    out = {"card": cs.card_line(), "n": n, "L": fcfg.nr_levels, "iter": ITER,
           "designs": {name(d): {"ms": statistics.median(v["ms"]), "device_ms": v["device_ms"],
                                 **gaps[name(d)]}
                       for d, v in times.items()},
           "bit_equal_to_the_port": equal, "agree_with_the_port": agree}
    unfused_grid = og.make_occupancy_grid(gcfg, device=device)

    def unfused():
        og._density_refresh_through(og.grid_points_cuda, og.density_update_cuda, gcfg,
                                    unfused_grid, *refresh)

    busy, launches = cs.device_ms_all(unfused, device, reps=5)
    out["unfused"] = {"ms": cs.time_ms(unfused, 10, device), "device_busy_ms": busy,
                      "device_launches": launches}
    centers, _ = og.grid_points_plain(gcfg, n, update_idx, jitter, device)
    window = pe.coarse2fine_window(_c2f_t(ITER, fcfg.nr_iters_for_c2f), fcfg.nr_levels)
    out["A_alone_device_ms"] = cs.device_ms(
        lambda: pe.permuto_encode(model["encoding"], centers, fcfg.encoding, window), "A", device)
    for k, v in out["designs"].items():
        print(f"[density refresh designs] {k}: ms {v['ms']:.5f} device {v['device_ms']}",
              flush=True)
    print(f"[density refresh designs] unfused: {out['unfused']}; bit equal to the port's "
          f"kernel: {equal}; within TOL_I2F: {agree}", flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not all(agree.values()):
        print("density_refresh_designs: a design differs from the port's kernel",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
