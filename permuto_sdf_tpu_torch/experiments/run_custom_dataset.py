"""Train PermutoSDF on a custom dataset of images, intrinsics and poses
(counterpart of ``permuto_sdf_tpu/experiments/run_custom_dataset.py``).
The scene scale and translation the user gives move the object of
interest into the r = 0.5 bound. Layout::

    <dir>/images/*.png
    <dir>/cameras.json   # {"frames": [{"file": ..., "K": 3x3,
                         #              "tf_world_cam": 4x4}, ...]}

or the IDR ``cameras.npz`` layout (the DTU loader reads it).

    python -m permuto_sdf_tpu_torch.experiments.run_custom_dataset --scene_dir DIR
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from permuto_sdf_tpu_torch.device import resolve_device


def load_custom_scene(scene_dir: str, scene_scale_multiplier: float = 1.0,
                      scene_translation=(0.0, 0.0, 0.0), subsample: int = 1, device=None):
    """-> TensorReel on ``device`` (None means the GPU)."""
    from permuto_sdf_tpu_torch.datasets.dtu import _load_image, load_dtu_scene
    from permuto_sdf_tpu_torch.datasets.tensor_reel import TensorReel

    device = resolve_device(device)
    cam_json = os.path.join(scene_dir, "cameras.json")
    if not os.path.exists(cam_json):
        return load_dtu_scene(scene_dir, scene_scale_multiplier=scene_scale_multiplier,
                              device=device)

    with open(cam_json) as f:
        meta = json.load(f)
    rgbs, Ks, tfs = [], [], []
    t = np.asarray(scene_translation, np.float32)
    for fr in meta["frames"]:
        img = _load_image(os.path.join(scene_dir, "images", fr["file"]))
        K = np.asarray(fr["K"], np.float32)
        if subsample > 1:
            img = img[::subsample, ::subsample]
            K = K.copy()
            K[:2] /= subsample
        tf = np.asarray(fr["tf_world_cam"], np.float32)
        tf[:3, 3] = (tf[:3, 3] + t) * scene_scale_multiplier
        rgbs.append(img)
        Ks.append(K)
        tfs.append(tf)

    return TensorReel(
        rgb=torch.from_numpy(np.stack(rgbs)).to(device), mask=None,
        K=torch.from_numpy(np.stack(Ks)).to(device),
        tf_world_cam=torch.from_numpy(np.stack(tfs)).to(device),
    )


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description="Train on a custom dataset")
    parser.add_argument("--scene_dir", required=True)
    parser.add_argument("--scene_scale_mult", type=float, default=1.0)
    parser.add_argument("--scene_translation", type=float, nargs=3,
                        default=[0.0, 0.0, 0.0])
    parser.add_argument("--subsample", type=int, default=1)
    parser.add_argument("--nr_iters", type=int, default=None)
    parser.add_argument("--checkpoint_path", default="./checkpoints")
    parser.add_argument("--exp_info", default="custom")
    args = parser.parse_args(argv)

    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    device = resolve_device(device)
    reel = load_custom_scene(args.scene_dir, args.scene_scale_mult,
                             tuple(args.scene_translation), args.subsample, device=device)
    return tps.train(reel, tps.PermutoSDFTrainConfig(), nr_iters=args.nr_iters,
                     checkpoint_path=args.checkpoint_path,
                     experiment_name=f"permuto_sdf_{args.exp_info}", device=device)


if __name__ == "__main__":
    main()
