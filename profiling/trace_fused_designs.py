#!/usr/bin/env python3
"""Kernels J3f and J2f as the port runs them (8 warps a 32-ray tile) beside
the two designs measured against them (1 and 4 warps a tile,
``profiling/trace_fused_variant.cu``), on one GPU.

    python3 profiling/trace_fused_designs.py [--out FILE]

Builds the variant with the port's nvcc flags into the port's build
directory, makes chip_smoke's sphere scene, and on J3f at the plain
frame's PT_CHUNK-ray centre chunk (PT_TRACES iterations) and J2f at the
fast frame's round 0 (the 400² view after J1's prepass, LOD 6, 5
iterations, 4 chained jumps) and its refine (every level, 3 iterations)
checks each design against the port's kernel bit for bit and times each
(CUDA events and device ms per launch in the kernel's own symbols, from a
restored state, the designs in turns, twice each). Prints one JSON line,
also written to ``--out``.
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
SOURCE = os.path.join(ROOT, "profiling", "trace_fused_variant.cu")
DESIGNS = (8, 1, 4)  # warps a tile; 8 is the port's kernel


def _build(kernels, sdf_net):
    """The variant's shared library (built once per source hash)."""
    out = kernels.build_dir() / "libtrace_fused_variant.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(out), SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed on the fused designs:\n" + res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.psdf_trace_loop_pos_design.argtypes = ([_I, _I, _P, sdf_net.SdfNet, _I] + [_P] * 6
                                               + [_I] + [_F] * 5 + [_I, _I] + [_F] * 7 + [_P])
    lib.psdf_trace_round_design.argtypes = ([_I, _I, _P, sdf_net.SdfNet, _I] + [_P] * 8 + [_I]
                                            + [_F] * 5 + [_I, _I] + [_F] * 3 + [_I] + [_P] * 2)
    lib.psdf_trace_loop_pos_design.restype = lib.psdf_trace_round_design.restype = _I
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("trace_fused_designs: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.models.fields import SDFEval
    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops import sdf_net as sn
    from permuto_sdf_tpu_torch.ops import sphere_trace as st
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    device = torch.device("cuda:0")
    kernels.build()
    lib = _build(kernels, sn)
    cs.KERNEL_SYMBOLS["J3f_design"] = "trace_loop_pos_design_kernel"
    cs.KERNEL_SYMBOLS["J2f_design"] = "trace_round_design_kernel"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tps.PermutoSDFTrainConfig()
    params, grid, _ = cs.sphere_scene(device, cfg)
    torch.set_grad_enabled(False)  # the traces alone from here on
    gcfg = cfg.grid
    field = tps._cached_dist_field(gcfg, grid)
    ctx = (params["sdf"], cs.ITER)
    full = SDFEval(cfg.sdf_model, None)
    bound = st._sphere_bound(tps.BOUND)
    stream = kernels.current_stream(device)
    grid_args = (*st._grid_scalars(gcfg), st._EMPTY_DIST_CAP)

    def loop_design(warps, dirs_f, s):
        net, keep = sn.sdf_net(full, ctx, device)  # keep: the tensors net points at
        err = lib.psdf_trace_loop_pos_design(
            dirs_f.shape[0], dirs_f.shape[0], None, net, warps, kernels.ptr(dirs_f),
            kernels.ptr(s["pos_f"]), kernels.ptr(s["alive_f"]), kernels.ptr(s["conv_f"]), None,
            kernels.ptr(field), *grid_args, cs.PT_TRACES, 0.9, 2e-4, float(gcfg.voxel_size),
            *bound[0], bound[1], stream)
        kernels.check(lib, err, f"J3f, {warps} warps a tile")

    def round_design(warps, ev, iters, idx, s):
        net, keep = sn.sdf_net(ev, ctx, device)
        counts = torch.zeros((2,), dtype=torch.int32, device=device)
        err = lib.psdf_trace_round_design(
            idx.shape[0], s["t_f"].shape[0] - 1, kernels.ptr(idx), net, warps,
            *(kernels.ptr(s[k]) for k in ("origins_f", "dirs_f", "texit_f", "t_f", "alive_f",
                                           "conv_f", "sdf_f")),
            kernels.ptr(field), *grid_args, iters, 0.9, 2e-4, float(gcfg.voxel_size), 4,
            kernels.ptr(counts), stream)
        kernels.check(lib, err, f"J2f, {warps} warps a tile")
        return counts

    K_cam, tf = cs.camera_k(cs.WIDTH, cs.HEIGHT)
    o_all, d_all = rays_from_frame(K_cam, tf, cs.WIDTH, cs.HEIGHT, device=device)
    cases = {}

    # J3f: the plain frame's centre chunk
    mid = (o_all.shape[0] // 2 // cs.PT_CHUNK) * cs.PT_CHUNK
    oc, dc = o_all[mid:mid + cs.PT_CHUNK].contiguous(), d_all[mid:mid + cs.PT_CHUNK].contiguous()
    pos, alive, _ = st._plain_seed(oc, dc, tps.BOUND, gcfg, grid, field)
    s0 = {"pos_f": pos.contiguous(), "alive_f": alive.contiguous(),
          "conv_f": torch.zeros_like(alive)}

    def j3f(warps, s, dc=dc):
        if warps == 8:
            st.trace_loop_pos_cuda(full, ctx, None, dc, s["pos_f"], s["alive_f"], s["conv_f"],
                                   None, field, gcfg, cs.PT_TRACES, 0.9, 2e-4, bound)
        else:
            loop_design(warps, dc, s)

    cases["J3f_chunk"] = (s0, j3f, "J3f")

    # J2f: the fast frame's round 0 after the prepass, then its refine
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
    keys = ("origins_f", "dirs_f", "texit_f", "t_f", "alive_f", "conv_f", "sdf_f")
    for stage, ev, iters in (("round0", SDFEval(cfg.sdf_model, cs.ST_KW["lod_schedule"][0]), 5),
                             ("refine", full, cs.ST_KW["nr_refine_iters"])):
        mask = (s0["alive_f"] & ~s0["conv_f"])[:Rf]
        idx, _ = compaction.nonzero_static_plain(mask, st.pow2_bucket(int(mask.sum()), lo=256,
                                                                      hi=Rf), Rf)

        def j2f(warps, s, ev=ev, iters=iters, idx=idx):
            if warps == 8:
                return st.trace_round_cuda(ev, ctx, idx, *(s[k] for k in keys), field, gcfg,
                                           iters, 0.9, 2e-4, 4, gcfg.voxel_size)
            return round_design(warps, ev, iters, idx, s)

        cases[f"J2f_{stage}"] = ({k: v.clone() for k, v in s0.items()}, j2f, "J2f")
        after = {k: v.clone() for k, v in s0.items()}
        j2f(8, after)
        s0 = after  # the refine starts from the round ...
        s0["conv_f"] = torch.zeros_like(s0["conv_f"])  # ... with every alive ray re-opened

    out = {"card": cs.card_line(), "cases": {}}
    for name, (state0, fn, sym) in cases.items():
        work = {k: v.clone() for k, v in state0.items()}

        def restore(work=work, state0=state0):
            for k, v in work.items():
                v.copy_(state0[k])

        want, equal = None, {}
        for warps in DESIGNS:
            got = {k: v.clone() for k, v in state0.items()}
            fn(warps, got)
            if want is None:
                want = got
            else:
                equal[f"{warps}_warps"] = all(torch.equal(got[k], want[k]) for k in want)
        restore_ms = cs.time_ms(restore, 10, device)
        times = {w: {"ms": [], "device_ms": []} for w in DESIGNS}
        for _ in range(2):  # the designs in turns
            for warps in DESIGNS:
                run = lambda warps=warps: (restore(), fn(warps, work))  # noqa: E731
                times[warps]["ms"].append(cs.time_ms(run, 10, device) - restore_ms)
                times[warps]["device_ms"].append(cs.device_ms(
                    run, sym if warps == 8 else f"{sym}_design", device, reps=5,
                    per_launch=True))
        res = {f"{w}_warps": {"ms": statistics.median(v["ms"]), "device_ms": v["device_ms"]}
               for w, v in times.items()}
        out["cases"][name] = {**res, "bit_equal_to_the_port": equal}
        print(f"[fused designs] {name}: " + ", ".join(
            f"{k} ms {v['ms']:.5f} device {v['device_ms']}" for k, v in res.items())
            + f"; bit equal to the port's kernel: {equal}", flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not all(all(c["bit_equal_to_the_port"].values()) for c in out["cases"].values()):
        print("trace_fused_designs: a design differs from the port's kernel", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
