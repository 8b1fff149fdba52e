#!/usr/bin/env python3
"""The flagship's training step on a DTU-sized reel beside the synthetic
reel, in turns, on one GPU.

    python3 profiling/torch_dtu_window.py [--pairs 4] [--out FILE]

Renders ``chip_smoke.py``'s DTU-layout scene (DTU_VIEWS views of DTU_WIDTH
x DTU_HEIGHT of the bench scene, fov 45, textured sky, masks), writes it
with ``export_dtu_scene`` into a temporary directory and reads it back
with ``create_reel("dtu", with_mask=True)``; beside it the synthetic reel
(24 views of 200²). Each reel gets a model at ``PermutoSDFTrainConfig()``
with random weights from chip_smoke's seed (colour calibration for its
own views), and both train on one all-occupied grid, so every step
renders the same number of valid samples. Then ``--pairs`` pairs of
chip_smoke's ``_train_window`` (TRAIN_STEPS steps of ``train`` resumed at
iteration nr_iter_sphere_fit + TRAIN_FROM, the first WARMUP_STEPS of them
warm-up), in the order D S, S D, D S, ...: each window's median ms/step,
the median over each reel's windows, their ratio, and in how many pairs
the DTU reel's window was the slower. Prints one JSON line, also written
to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("torch_dtu_window: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from permuto_sdf_tpu_torch import kernels
    from permuto_sdf_tpu_torch.datasets.dtu import export_dtu_scene
    from permuto_sdf_tpu_torch.datasets.factory import create_reel
    from permuto_sdf_tpu_torch.datasets.synthetic import bench_scene_sdf, make_synthetic_reel
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    device = torch.device("cuda")
    cfg = tps.PermutoSDFTrainConfig()
    with tempfile.TemporaryDirectory() as tmp:
        src = make_synthetic_reel(nr_views=cs.DTU_VIEWS, width=cs.DTU_WIDTH,
                                  height=cs.DTU_HEIGHT, sdf_fn=bench_scene_sdf, fov_deg=45.0,
                                  bg_mode="textured", device=device)
        export_dtu_scene(src, tmp)
        del src
        reels = {"dtu": create_reel("dtu", data_root=tmp, with_mask=True, device=device)}
    reels["synthetic"] = make_synthetic_reel(device=device)
    grid = tps.og.make_occupancy_grid(cfg.grid, device=device)
    params = {k: tps.init_params(cs.SEED, cfg, r.nr_images, device=device)
              for k, r in reels.items()}
    start = cfg.nr_iter_sphere_fit + cs.TRAIN_FROM
    order = []
    for i in range(args.pairs):
        order += ["dtu", "synthetic"] if i % 2 == 0 else ["synthetic", "dtu"]
    windows = []
    for label in order:
        _, run = cs._train_window(device, label, cfg, params[label], grid, reels[label], start,
                                  cs.TRAIN_STEPS)
        timed = [r["ms"] for r in run["per_step"][cs.WARMUP_STEPS:]]
        w = {"reel": label, "ms_per_step_median": statistics.median(timed),
             "ms_per_step_min": min(timed), "ms_per_step_max": max(timed),
             "valid_samples_per_step_mean": statistics.mean(
                 r["nr_samples"] for r in run["per_step"])}
        windows.append(w)
        print(f"[dtu window] {label}: {len(timed)} steps, median {w['ms_per_step_median']:.2f} "
              f"ms/step (min {w['ms_per_step_min']:.2f}, max {w['ms_per_step_max']:.2f}), "
              f"{w['valid_samples_per_step_mean']:.0f} valid samples a step", flush=True)
    med = {k: statistics.median(w["ms_per_step_median"] for w in windows if w["reel"] == k)
           for k in reels}
    pairs = [windows[i:i + 2] for i in range(0, len(windows), 2)]
    slower = sum(1 for p in pairs
                 if {w["reel"]: w["ms_per_step_median"] for w in p}["dtu"]
                 > {w["reel"]: w["ms_per_step_median"] for w in p}["synthetic"])
    out = {"card": card, "reels": {k: [r.nr_images, r.height, r.width] for k, r in reels.items()},
           "first_iter": start + 1, "steps": cs.TRAIN_STEPS, "warmup_steps": cs.WARMUP_STEPS,
           "order": order, "windows": windows, "median_of_window_medians": med,
           "dtu_over_synthetic": med["dtu"] / med["synthetic"],
           "pairs_dtu_slower": slower, "pairs": len(pairs)}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
