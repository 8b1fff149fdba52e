#!/usr/bin/env python3
"""Kernel H0 alone, at the mask sizes of the port's paths, on one GPU: the
port's two launches, the one-launch cluster form measured against them at
each of its launch shapes, the fused second mask, and
``torch.nonzero_static``.

    python3 profiling/h0_designs.py [--turns 3] [--out FILE]

For each n of N_SIZES (the flagship step's sample budget, 49,152; the fast
sphere-traced frame's 400² chunk, 196,608; 786,432; a 1080p chunk,
2,097,152), on a mask made from a seed (a quarter true, the share of round
0's alive rays in the fast frame) and a second mask (half true), with the
bucket `pow2_bucket` gives the count:
- the one-launch (cluster) form of ``h0_variants.cu`` at every launch shape
  of SHAPES (threads a block, 16-byte vectors a thread a pass, blocks a
  cluster), each checked bit for bit against ``nonzero_static_plain``;
- the port's two launches, called directly (``psdf_compact``) and through
  its wrapper, checked the same way;
- the port's kernel on ``mask & ~other`` fused in its loads, beside the
  two elementwise ops and H0 that the tracer ran before;
- ``torch.nonzero_static(mask, size=bucket, fill_value=n)``;
CUDA-event ms per call over REPS calls and device ms per call among the
profiler's records (all device activities of a call for the unfused ops and
the library), each design in turns, ``--turns`` times; medians. Then the
cluster form's stage probe (``probe_stages``) at the fast frame's n. Builds
with the port's nvcc flags into the port's build directory. Prints one JSON
line, also written to ``--out``; exits 1 if a design's output differs.
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
VARIANTS = os.path.join(ROOT, "profiling", "h0_variants.cu")
N_SIZES = (49_152, 196_608, 786_432, 2_097_152)
SHAPES = [(t, v, c) for t in (256, 512, 1024) for v in (1, 2) for c in (8, 16)]
REPS = 50
# the stage probe's sets (h0_variants.cu): bits 1 loads, 2 scan, 4 positions
# to shared memory, 8 cluster barrier and totals, 16 stores, 32 fills
PROBE_STAGES = {0: "empty, no cluster", 8: "cluster barrier and totals only", 1: "loads",
                3: "loads, scan", 7: "loads, scan, positions", 23: "all but cluster and fills",
                55: "all but the cluster", 15: "loads, scan, positions, cluster",
                31: "all but the fills", 63: "all (the port's pass)"}


def _variants_lib(kernels):
    out = kernels.build_dir() / "libh0_variants.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(out), VARIANTS]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed on h0_variants.cu:\n" + res.stdout + res.stderr)
    lib = kernels.declare(ctypes.CDLL(str(out)), "compaction")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.psdf_compact_shape.argtypes = [I, I, I, I, P, P, I, I, L, P, P, P]
    lib.psdf_compact_probe.argtypes = [I, I, I, P, I, L, P, P, P]
    for fn in (lib.psdf_compact_shape, lib.psdf_compact_probe):
        fn.restype = I
    return lib


def probe_stages(cs, lib, kernels, device, rng, turns, n=196_608):
    """Device ms per launch of ``h0_variants.cu``'s stage probe (1024
    threads, 16 blocks, one pass) at n for each set of PROBE_STAGES."""
    import torch

    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops.sphere_trace import pow2_bucket

    mask = torch.from_numpy(rng.uniform(size=n) < 0.25).to(device)
    bucket = pow2_bucket(int(mask.sum()), lo=256, hi=n)
    idx = torch.empty((bucket,), dtype=torch.int64, device=device)
    cnt = torch.empty((1,), dtype=torch.int32, device=device)
    stream = kernels.current_stream(device)

    def run(stages):
        err = lib.psdf_compact_probe(stages, 16, n, kernels.ptr(mask), bucket, n,
                                     kernels.ptr(idx), kernels.ptr(cnt), stream)
        kernels.check(lib, err, f"H0 probe, stages {stages}")

    run(63)
    res = {"bit_equal_all_stages": bool(torch.equal(
        idx, compaction.nonzero_static_plain(mask, bucket, n)[0]))}
    times = {st: [] for st in PROBE_STAGES}
    for _ in range(turns):
        for st in PROBE_STAGES:
            times[st].append(cs.device_ms_all(lambda st=st: run(st), device, reps=REPS)[0])
    for st, label in PROBE_STAGES.items():
        v = [x for x in times[st] if x is not None]
        res[f"{st}: {label}"] = statistics.median(v) if v else None
    print(f"[H0 probe n={n}] {json.dumps(res)}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("h0_designs: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.ops import compaction
    from permuto_sdf_tpu_torch.ops.sphere_trace import pow2_bucket

    device = torch.device("cuda:0")
    kernels.build(("compaction",))
    lib = _variants_lib(kernels)
    stream = kernels.current_stream(device)
    rng = np.random.default_rng(cs.SEED + 21)
    out = {"card": cs.card_line(), "sizes": {}}
    ok = True
    for n in N_SIZES:
        mask = torch.from_numpy(rng.uniform(size=n) < 0.25).to(device)
        other = torch.from_numpy(rng.uniform(size=n) < 0.5).to(device)
        count = int(mask.sum())
        bucket = pow2_bucket(count, lo=256, hi=n)
        want = compaction.nonzero_static_plain(mask, bucket, n)
        idx = torch.empty((bucket,), dtype=torch.int64, device=device)
        cnt = torch.empty((1,), dtype=torch.int32, device=device)
        tiles = torch.empty((max(1, -(-n // 2048)),), dtype=torch.int32, device=device)

        def shape(t, v, c):
            err = lib.psdf_compact_shape(t, v, c, n, kernels.ptr(mask), None, 0, bucket, n,
                                         kernels.ptr(idx), kernels.ptr(cnt), stream)
            kernels.check(lib, err, f"H0 at {t} threads, {v} vectors, {c} blocks")

        def two_pass():
            err = lib.psdf_compact(n, kernels.ptr(mask), None, 0, bucket, n, kernels.ptr(tiles),
                                   kernels.ptr(idx), kernels.ptr(cnt), stream)
            kernels.check(lib, err, "H0, two launches")

        designs = {f"{t}x{v}x{c}": (lambda t=t, v=v, c=c: shape(t, v, c), 1)
                   for t, v, c in SHAPES}
        designs["two_launches"] = (two_pass, 2)
        designs["port"] = (lambda: compaction.nonzero_static_cuda(mask, bucket, n), 2)
        equal, refused = {}, {}
        for name, (fn, _) in list(designs.items()):
            idx.fill_(-1)
            try:
                if name == "port":
                    idx.copy_(fn()[0])
                else:
                    fn()
            except RuntimeError as e:  # a shape the card cannot schedule
                refused[name] = str(e)
                del designs[name]
                continue
            equal[name] = bool(torch.equal(idx, want[0]) and int(cnt) == int(want[1]))
        fused_want = compaction.nonzero_static_plain(mask, bucket, n, other=other,
                                                     negate_other=True)
        fused = compaction.nonzero_static_cuda(mask, bucket, n, other=other, negate_other=True)
        equal["fused"] = bool(torch.equal(fused[0], fused_want[0]))
        ok &= all(equal.values())
        designs["fused"] = (lambda: compaction.nonzero_static_cuda(
            mask, bucket, n, other=other, negate_other=True), 2)
        designs["ops_then_port"] = (lambda: compaction.nonzero_static_cuda(
            mask & ~other, bucket, n), None)
        designs["torch.nonzero_static"] = (lambda: torch.nonzero_static(
            mask, size=bucket, fill_value=n), None)
        times = {k: {"ms": [], "device_ms": []} for k in designs}
        for _ in range(args.turns):
            for name, (fn, launches) in designs.items():
                times[name]["ms"].append(cs.time_ms(fn, REPS, device))
                if launches is None:
                    dms = cs.device_ms_all(fn, device, reps=REPS)[0]
                else:
                    dms = cs.device_ms(fn, "H0", device, reps=REPS, per_launch=True,
                                       launches=launches)
                times[name]["device_ms"].append(dms)
        res = {}
        for name, v in times.items():
            dev = [x for x in v["device_ms"] if x is not None]
            res[name] = {"ms": statistics.median(v["ms"]),
                         "device_ms_per_call": statistics.median(dev) if dev else None}
        shapes = {f"{t}x{v}x{c}" for t, v, c in SHAPES}
        best = min((k for k in res if k in shapes and res[k]["device_ms_per_call"] is not None),
                   key=lambda k: res[k]["device_ms_per_call"], default=None)
        out["sizes"][str(n)] = {"count": count, "bucket": bucket, "designs": res,
                                "fastest_shape": best, "bit_equal": equal,
                                "refused": refused}
        print(f"[H0 n={n}] count {count} bucket {bucket}; fastest shape {best}; " + "; ".join(
            f"{k} {v['ms']:.4f} ms, device {v['device_ms_per_call']}" for k, v in res.items())
            + f"; bit equal {equal}; refused {refused}", flush=True)
    out["probe"] = probe_stages(cs, lib, kernels, device, rng, args.turns)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not ok:
        print("h0_designs: a design's output differs from nonzero_static_plain", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
