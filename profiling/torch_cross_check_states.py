#!/usr/bin/env python3
"""Run chip_smoke's flagship card-vs-CPU step comparison on several trained states.

    python3 profiling/torch_cross_check_states.py [--states 5] [--out FILE]

Each state is a fresh ``chip_smoke.train_phase`` (4 sphere-init steps, then
24 steps of ``train`` resumed past the SDF's ease-in): the states differ
from run to run by the order of the float atomics. On each, the draws of
the steps CHECK_ITER_OFFSETS past the resume point go through
``chip_smoke.train_cross_check(gate=False)``: the loss
and every leaf's gradient on the card against the CPU, with the colour
loss's L1 sign flips and the rays that hit the bound sphere on one side
only. Prints one JSON line per check, then a summary: how many checks
fail the gate (a leaf beyond ``TOL_GRAD_CROSS``), which leaves, and the
worst leaf of each check. One GPU; the CPU runs one step of the plain
path per check (~4 s).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CHECK_ITER_OFFSETS = (200, 300, 400, 500)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--states", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import torch

    if not torch.cuda.is_available():
        print("torch_cross_check_states: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    device = torch.device("cuda")
    cfg = tps.PermutoSDFTrainConfig()
    checks = []
    for state in range(args.states):
        params, grid, reel, _, _ = cs.train_phase(device, cfg)
        for off in CHECK_ITER_OFFSETS:
            it = cfg.nr_iter_sphere_fit + cs.TRAIN_FROM + off
            s = cs.train_cross_check(device, cfg, params, grid, reel, it=it, gate=False,
                                     label=f"state{state}_it{it}")
            errs = s["grad_rel_l2_err"]
            worst = max(errs, key=errs.get)
            checks.append({
                "state": state, "it": it, "loss_rel_err": s["loss_rel_err"],
                "l1_sign_flips": s["l1_sign_flips"],
                "l1_sign_flips_within_tie": s["l1_sign_flips_within_tie"],
                "l1_flip_max_abs_residual": s["l1_flip_max_abs_residual"],
                "ray_hit_flips": s["ray_hit_flips"],
                "failing": {k: v for k, v in errs.items() if v > cs.TOL_GRAD_CROSS},
                "worst_leaf": worst, "worst": errs[worst]})
    summary = {"card": cs.card_line(), "checks": len(checks),
               "failing_checks": sum(bool(c["failing"]) for c in checks),
               "with_l1_flips": sum(c["l1_sign_flips"] > 0 for c in checks),
               "with_ray_hit_flips": sum(c["ray_hit_flips"] > 0 for c in checks),
               "per_check": checks}
    line = json.dumps({"cross_check_states": summary})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
