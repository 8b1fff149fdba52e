#!/usr/bin/env python3
"""Kernel If (the flagship trainer's grid refresh in one launch) as the
port runs it beside the shapes measured against it
(``profiling/grid_refresh_variant.cu``) and beside the unfused refresh it
replaced, on one GPU.

    python3 profiling/grid_refresh_designs.py [--out FILE]

Builds the variant with the port's nvcc flags into the port's build
directory. At the flagship refresh (``PermutoSDFTrainConfig()``: 262,144
probes of the 256³ grid, the SDF on 14 of its 24 levels, random weights
from chip_smoke's seed, an iteration whose c2f window is still closing
levels) it checks each shape against the port's kernel bit for bit and
times each (CUDA events and device ms per launch in the kernel's own
symbols, the shapes in turns, twice each): 8 and 4 warps a tile of 32
probes, one block a tile (the port's: the weights staged per tile), or
persistent blocks, as many as fit on the card or 1 or 2 a streaming
multiprocessor, each staging the weights once. Then
the unfused refresh (entry 1 of kernel I, ``sdf_apply``'s kernel A,
matmuls and GELUs, entry 2): CUDA-event ms, device busy ms and device
launches a call. Prints one JSON line, also written to ``--out``.
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
SOURCE = os.path.join(ROOT, "profiling", "grid_refresh_variant.cu")
# (warps a tile, persistent blocks a streaming multiprocessor: 0 as many as
# fit, -1 one block a tile); the first is the port's kernel
DESIGNS = ((8, -1), (4, -1), (8, 0), (4, 0), (8, 1), (8, 2))
C2F_ITER = 2000  # the flagship's c2f window still closes levels here (10,000 iterations)


def _build(kernels):
    """The variant's shared library (built once per source hash)."""
    out = kernels.build_dir() / "libgrid_refresh_variant.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(out), SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed on the refresh designs:\n" + res.stdout + res.stderr)
        print("\n".join(line for line in (res.stdout + res.stderr).splitlines()
                        if "grid_refresh" in line or "registers" in line), flush=True)
    lib = ctypes.CDLL(str(out))
    _P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.psdf_grid_refresh_design.argtypes = ([_I, _U, _I] + [_F] * 5 + [_P] * 2 + [_F] * 3
                                             + [_P] * 2 + [_I, _I, _P])
    lib.psdf_grid_refresh_design.restype = _I
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("grid_refresh_designs: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.models.fields import SDFEval
    from permuto_sdf_tpu_torch.ops import occupancy_grid as og
    from permuto_sdf_tpu_torch.ops import sdf_net as sn
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    device = torch.device("cuda:0")
    kernels.build()
    lib = _build(kernels)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    cfg = tps.PermutoSDFTrainConfig()
    gcfg = cfg.grid
    n = cfg.grid_nr_random_samples
    params = tps.init_params(cs.SEED, cfg, device=device)
    params["sdf"]["encoding"]["lattice_values"].mul_(1e3)  # a trained table's magnitude
    sdf_eval = SDFEval(cfg.sdf_model, cfg.grid_update_max_levels)
    ctx = (params["sdf"], C2F_ITER)
    jitter = (torch.rand((n, 3), generator=torch.Generator().manual_seed(cs.SEED)) - 0.5).to(
        device)
    update_idx = 2501
    refresh = (sdf_eval, ctx, n, update_idx, jitter, cs.INV_S_TRAINED,
               cfg.grid_occupancy_thresh)
    stream = kernels.current_stream(device)
    tx, ty, tz = (float(v) for v in gcfg.grid_translation)

    def design(warps, per_sm, grid):
        if (warps, per_sm) == DESIGNS[0]:
            og.grid_refresh_cuda(gcfg, grid, *refresh)
            return
        net, keep = sn.sdf_net(sdf_eval, ctx, device)  # keep: the tensors net points at
        err = lib.psdf_grid_refresh_design(
            n, update_idx, gcfg.nr_voxels_per_dim, gcfg.voxel_size, gcfg.grid_extent / 2.0, tx,
            ty, tz, kernels.ptr(jitter), ctypes.byref(net), cs.INV_S_TRAINED,
            float(gcfg.half_diagonal), cfg.grid_occupancy_thresh, kernels.ptr(grid.values),
            kernels.ptr(grid.occupancy), warps, per_sm, stream)
        kernels.check(lib, err, f"If, {warps} warps, {per_sm} blocks a multiprocessor")

    grids = {d: og.make_occupancy_grid(gcfg, device=device) for d in DESIGNS}
    for d, g in grids.items():
        design(*d, g)
    want = grids[DESIGNS[0]]
    equal = {f"{w}w_{p}": torch.equal(g.values, want.values)
             and torch.equal(g.occupancy, want.occupancy) for (w, p), g in grids.items()}
    times = {d: {"ms": [], "device_ms": []} for d in DESIGNS}
    for _ in range(2):  # the shapes in turns
        for d in DESIGNS:
            run = lambda d=d: design(*d, grids[d])  # noqa: E731
            times[d]["ms"].append(cs.time_ms(run, 10, device))
            times[d]["device_ms"].append(cs.device_ms(run, "If", device, reps=5,
                                                      per_launch=True))
    out = {"card": cs.card_line(), "n": n, "K": cfg.grid_update_max_levels, "iter": C2F_ITER,
           "designs": {f"{w}w_{p}": {"ms": statistics.median(v["ms"]),
                                     "device_ms": v["device_ms"]}
                       for (w, p), v in times.items()},
           "bit_equal_to_the_port": equal}
    unfused_grid = og.make_occupancy_grid(gcfg, device=device)

    def unfused():
        og._refresh_through(og.grid_points_cuda, og.grid_update_cuda, gcfg, unfused_grid,
                            *refresh)

    busy, launches = cs.device_ms_all(unfused, device, reps=5)
    out["unfused"] = {"ms": cs.time_ms(unfused, 10, device), "device_busy_ms": busy,
                      "device_launches": launches}
    for k, v in out["designs"].items():
        print(f"[refresh designs] {k}: ms {v['ms']:.5f} device {v['device_ms']}", flush=True)
    print(f"[refresh designs] unfused: {out['unfused']}; bit equal to the port's kernel: "
          f"{equal}", flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not all(equal.values()):
        print("grid_refresh_designs: a shape differs from the port's kernel", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
