#!/usr/bin/env python3
"""Kernels L, D2 and D2' alone, at the lever step's shapes, on one GPU:
their block shapes, where a launch's time goes, and their code size.

    python3 profiling/lod_kernels.py [--rays 512] [--parts shapes,phases,sass]
                                     [--root DIR] [--out FILE]

On a batch made from a seed (R rays, S = 96 with every slot valid, as on the
flagship step's all-occupied grid, K + E = 24 + 8, the fine rows random):
- shapes: L, D2 and D2' at 1, 2 and 4 rays a block (``lod_block_shapes.cu``,
  which launches the port's kernels), each checked against the port's own
  launch bit for bit and timed (CUDA-event ms per call over 50 calls, device
  ms per launch among the profiler's records), the shapes in turns, three
  times each;
- phases: device ms per launch of each kernel stopped after each of its
  phases (a copy of ``volume_rendering.cu`` built with a return after each
  phase, chosen at run time), so the differences are the phases' times;
  the two last phases include the output stores;
- sass: the SASS instruction count of kernels L, D2 and D2' (and D, D',
  and the shared device functions ``mixed_stage`` and ``mixed_chain``) in
  the ``volume_rendering`` library of the tree at ``--root`` (default: this
  checkout; any tree of the port, e.g. a parent unpacked with
  ``git archive``), from ``cuobjdump``.

Builds with the port's nvcc flags into the port's build directory. Prints
one JSON line, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES_SOURCE = os.path.join(ROOT, "profiling", "lod_block_shapes.cu")
PARTS = ("shapes", "phases", "sass")
SHAPES = (1, 2, 4)  # rays a block
S, K, E = 96, 24, 8
TURNS, REPS = 3, 50
# each kernel's phases: (name, the source line the phase ends before); a
# launch stopped at phase n returns there
PHASES = {
    "L": (("staged", "  // fd cos and alpha"),
          ("fd cos and alpha, cos_fd stored", "  // this lane's run [i0, i1)"),
          ("scan and keys", "  warp_sort_desc(s_key, P, lane);\n  long long* sel_r"),
          ("top-K sort", "  long long* sel_r"),
          ("top K out, extras' keys", "  warp_sort_desc(s_key, P, lane);\n#pragma unroll 1\n"
                                      "  for (int k = lane; k < E")),
    "D2": (("staged", "  const int nr = mixed_chain(base, S, KE, false"),
           ("the mixed chain (rows to slots, alpha, the scan)", "  // the weights (in place of T)"),
           ("weights stored", "  // the fine rows at valid slots, a row per lane")),
    "D2'": (("staged", "  // each fine row's integration term; the forward again"),
            ("terms, the mixed chain again", "#pragma unroll 1\n  for (int i = lane; i < S; "
                                             "i += 32)\n    m.Gw[i] ="),
            ("weight cotangents", "  // the reverse recurrence: the run's maps"),
            ("reverse recurrence", "  // the fine rows, a row per lane: the integration")),
}
KERNEL_START = {"L": "__global__ void __launch_bounds__(128) train_lod_select_kernel(",
                "D2": "__global__ void __launch_bounds__(128) render_mixed_kernel(",
                "D2'": "__global__ void __launch_bounds__(128) render_mixed_bwd_kernel("}
SASS_KERNELS = {"L": "train_lod_select_kernel", "D2": "render_mixed_kernel",
                "D2'": "render_mixed_bwd_kernel", "D": "render_weights_kernel",
                "D'": "render_weights_bwd_kernel", "mixed_chain": "mixed_chain",
                "mixed_stage": "mixed_stage"}


def _phase_source(src: str) -> str:
    """volume_rendering.cu with `if (lod_stop == n) return;` before the end
    of phase n of L, D2 and D2', and psdf_set_lod_stop(n) to choose n."""
    for kernel, phases in PHASES.items():
        start = src.index(KERNEL_START[kernel])
        end = src.index("\n}\n", start)
        body = src[start:end]
        for n, (_, marker) in enumerate(phases, 1):
            if body.count(marker) != 1:
                raise RuntimeError(f"lod_kernels: phase marker of {kernel} not found once: "
                                   f"{marker!r}")
            body = body.replace(marker, f"  if (lod_stop == {n}) return;\n" + marker)
        src = src[:start] + body + src[end:]
    src = src.replace("namespace {\n", "namespace {\n__constant__ int lod_stop;\n", 1)
    return src + ('\nextern "C" int psdf_set_lod_stop(int n) {\n'
                  "  return (int)cudaMemcpyToSymbol(lod_stop, &n, sizeof(int));\n}\n")


def _nvcc(kernels, source, name):
    out = kernels.build_dir() / f"lib{name}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(out), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n" + res.stdout + res.stderr)
    return ctypes.CDLL(str(out))


def _shapes_lib(kernels):
    lib = _nvcc(kernels, SHAPES_SOURCE, "lod_block_shapes")
    sig = kernels.SIGNATURES["volume_rendering"]
    lib.psdf_train_lod_select_rays.argtypes = [ctypes.c_int] + sig["psdf_train_lod_select"]
    lib.psdf_render_mixed_rays.argtypes = [ctypes.c_int] + sig["psdf_render_mixed"]
    lib.psdf_render_mixed_bwd_rays.argtypes = [ctypes.c_int] + sig["psdf_render_mixed_bwd"]
    for fn in (lib.psdf_train_lod_select_rays, lib.psdf_render_mixed_rays,
               lib.psdf_render_mixed_bwd_rays):
        fn.restype = ctypes.c_int
    return lib


def _phases_lib(kernels):
    src = kernels.build_dir() / "lod_phases.cu"
    src.write_text(_phase_source((kernels.CSRC / "volume_rendering.cu").read_text()))
    lib = kernels.declare(_nvcc(kernels, src, "lod_phases"), "volume_rendering")
    lib.psdf_set_lod_stop.argtypes = [ctypes.c_int]
    lib.psdf_set_lod_stop.restype = ctypes.c_int
    return lib


def lever_batch(R, device, seed=15):
    """A lever-shaped batch made from ``seed``: samples, carried sdf, scores,
    the fine rows (sdf, gradients, rgb) and D2's five cotangents."""
    import numpy as np
    import torch

    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    z = np.sort(rng.uniform(0.5, 1.5, (R, S)), axis=1)
    smp = RaySamples(origins=torch.zeros(R, 3, device=device),
                     dirs=torch.nn.functional.normalize(f32(rng.normal(size=(R, 3))), dim=-1),
                     z=f32(z), dt=f32(rng.uniform(0.002, 0.02, (R, S))),
                     mask=torch.ones(R, S, dtype=torch.bool, device=device),
                     ray_fixed_dt=torch.full((R,), 0.01, device=device))
    sdf = f32(0.05 - 0.1 * rng.uniform(size=(R, 1)) - (z - 1.0) * 0.2
              + rng.normal(0, 0.003, (R, S)))
    n = R * (K + E)
    fine = (f32(rng.uniform(-0.05, 0.05, (n, 1))), f32(rng.normal(size=(n, 3))),
            f32(rng.uniform(size=(n, 3))))
    cots = [f32(rng.normal(size=shape)) for shape in ((R, S), (R, 1), (R,), (R, 3), (R, 3))]
    return smp, sdf, f32(rng.uniform(size=(R, S))), fine, cots


def sass_counts(kernels):
    """SASS instructions of each kernel of SASS_KERNELS in the tree's built
    volume_rendering library."""
    kernels.build(("volume_rendering",))
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(kernels.library_path("volume_rendering"))],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = next((k for k, sym in SASS_KERNELS.items()
                        if re.search(rf"\d{sym}E", m.group(1))), None)
            continue
        if cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[cur] = counts.get(cur, 0) + 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS):
        print(f"lod_kernels: unknown --parts {sorted(parts - set(PARTS))}", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if parts != {"sass"} and root != ROOT:
        print("lod_kernels: only --parts sass runs on another tree", file=sys.stderr)
        return 2
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("lod_kernels: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.ops import volume_rendering as vr

    out = {"card": cs.card_line(), "tree": root}
    if "sass" in parts:
        out["sass_instructions"] = sass_counts(kernels)
        print(f"[sass] {out['sass_instructions']}", flush=True)
    if parts == {"sass"}:
        return _emit(out, args.out, True)

    device = torch.device("cuda:0")
    kernels.build(("volume_rendering",))
    R = args.rays
    smp, sdf, scores, (sdf_c, grads_c, rgb_c), cots = lever_batch(R, device)
    stream = kernels.current_stream(device)
    inv_s, car = 400.0, 0.6
    cos_fd, sel = vr.train_lod_select_cuda(smp, sdf, inv_s, car, scores, K, E)
    margs = (smp, sdf, cos_fd, sel, sdf_c, grads_c, rgb_c, inv_s, car)
    d2 = vr.neus_render_mixed_cuda(*margs)
    d2b = vr.neus_render_mixed_bwd_cuda(*margs, *cots)
    out.update(R=R, S=S, K=K, E=E)
    ok = True

    if "shapes" in parts:
        lib = _shapes_lib(kernels)
        _, _, _, ins = vr._mixed_inputs(*margs[:7])

        def run_l(rays):
            c, s = torch.empty_like(cos_fd), torch.empty_like(sel)
            err = lib.psdf_train_lod_select_rays(
                rays, R, S, K, E, kernels.ptr(sdf), kernels.ptr(smp.dt),
                kernels.ptr(smp.mask), kernels.ptr(scores), inv_s, car, kernels.ptr(c),
                kernels.ptr(s), stream)
            kernels.check(lib, err, f"L, {rays} rays a block")
            return c, s

        def run_d2(rays):
            outs = [torch.empty_like(t) for t in d2]
            err = lib.psdf_render_mixed_rays(
                rays, R, S, K + E, *vr._mixed_ptrs(ins), inv_s, car,
                *(kernels.ptr(t) for t in outs), stream)
            kernels.check(lib, err, f"D2, {rays} rays a block")
            return outs

        def run_d2b(rays):
            outs = [torch.empty_like(t) for t in d2b]
            err = lib.psdf_render_mixed_bwd_rays(
                rays, R, S, K + E, *vr._mixed_ptrs(ins), inv_s, car,
                *(kernels.ptr(c.contiguous()) for c in cots), *(kernels.ptr(t) for t in outs),
                stream)
            kernels.check(lib, err, f"D2', {rays} rays a block")
            return outs

        out["shapes"] = {}
        for name, fn, want in (("L", run_l, (cos_fd, sel)), ("D2", run_d2, d2),
                               ("D2'", run_d2b, d2b)):
            equal = {r: all(torch.equal(a, b) for a, b in zip(fn(r), want)) for r in SHAPES}
            ok &= all(equal.values())
            times = {r: {"ms": [], "device_ms": []} for r in SHAPES}
            for _ in range(TURNS):
                for r in SHAPES:
                    times[r]["ms"].append(cs.time_ms(lambda r=r: fn(r), REPS, device))
                    times[r]["device_ms"].append(cs.device_ms(lambda r=r: fn(r), name, device,
                                                              reps=REPS, per_launch=True))
            res = {f"{r}_rays": {"ms": statistics.median(v["ms"]), "device_ms": v["device_ms"]}
                   for r, v in times.items()}
            out["shapes"][name] = {**res, "bit_equal_to_the_port": {f"{r}_rays": e
                                                                    for r, e in equal.items()}}
            print(f"[block shapes] {name}: " + ", ".join(
                f"{k} ms {v['ms']:.5f} device {v['device_ms']}" for k, v in res.items())
                + f"; bit equal to the port's launch: {equal}", flush=True)

    if "phases" in parts:
        lib = _phases_lib(kernels)
        load = kernels.load
        kernels.load = lambda name: lib
        try:
            calls = {"L": lambda: vr.train_lod_select_cuda(smp, sdf, inv_s, car, scores, K, E),
                     "D2": lambda: vr.neus_render_mixed_cuda(*margs),
                     "D2'": lambda: vr.neus_render_mixed_bwd_cuda(*margs, *cots)}
            out["phases"] = {}
            for name, fn in calls.items():
                stops = list(range(1, len(PHASES[name]) + 1)) + [0]
                ms = {n: [] for n in stops}
                for _ in range(2):
                    for n in stops:
                        if lib.psdf_set_lod_stop(n) != 0:
                            raise RuntimeError("lod_kernels: cannot set the phase stop")
                        ms[n].append(cs.device_ms(fn, name, device, reps=REPS, per_launch=True))
                names = [p for p, _ in PHASES[name]] + ["outputs stored (whole launch)"]
                out["phases"][name] = [{"through": p, "device_ms": statistics.median(ms[n])}
                                       for p, n in zip(names, stops)]
                print(f"[phases] {name}: {out['phases'][name]}", flush=True)
        finally:
            kernels.load = load
            lib.psdf_set_lod_stop(0)
    return _emit(out, args.out, ok)


def _emit(out, path, ok) -> int:
    line = json.dumps(out)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    print(line)
    if not ok:
        print("lod_kernels: a block shape differs from the port's launch", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
