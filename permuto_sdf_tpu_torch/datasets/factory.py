"""One entry point for every dataset family (counterpart of
``permuto_sdf_tpu/datasets/factory.py``): synthetic, dtu, bmvs (the DTU
loader at another root), multiface, and custom/phenorobcp1/easypbr (images
and ``cameras.json``, or IDR's ``cameras.npz``).
"""

from __future__ import annotations

import os

from permuto_sdf_tpu_torch.datasets.tensor_reel import TensorReel
from permuto_sdf_tpu_torch.device import resolve_device


def create_reel(dataset: str, scene: str | None = None,
                data_root: str | None = None, low_res: bool = False,
                with_mask: bool = False, mode: str = "train",
                crop_to_bound: bool | None = None, device=None) -> TensorReel:
    """-> TensorReel on ``device`` (None means the GPU) for any supported
    dataset family. ``crop_to_bound`` crops every frame to the projected
    bound sphere (:func:`crop_reel_to_sphere`); None means on for multiface
    and phenorobcp1, off elsewhere."""
    if crop_to_bound is None:
        crop_to_bound = dataset in ("multiface", "phenorobcp1")
    device = resolve_device(device)

    def _maybe_crop(reel: TensorReel) -> TensorReel:
        if not crop_to_bound:
            return reel
        from permuto_sdf_tpu_torch.datasets.tensor_reel import crop_reel_to_sphere

        return crop_reel_to_sphere(reel, radius=0.5)
    if dataset == "synthetic":
        from permuto_sdf_tpu_torch.datasets.synthetic import make_synthetic_reel

        return make_synthetic_reel(
            nr_views=24, width=100 if low_res else 200,
            height=100 if low_res else 200, device=device,
        )
    if dataset in ("dtu", "bmvs"):
        from permuto_sdf_tpu_torch.datasets.dtu import load_dtu_scene

        scene_dir = os.path.join(data_root, scene) if scene else data_root
        return load_dtu_scene(scene_dir, low_res=low_res, with_mask=with_mask, device=device)
    if dataset == "multiface":
        from permuto_sdf_tpu_torch.datasets.multiface import load_multiface_scene

        # the scene name is the subject preset id
        return _maybe_crop(load_multiface_scene(data_root, int(scene or 0), low_res=low_res,
                                                mode=mode, device=device))
    if dataset in ("custom", "phenorobcp1", "easypbr"):
        from permuto_sdf_tpu_torch.experiments.run_custom_dataset import load_custom_scene

        scene_dir = os.path.join(data_root, scene) if scene else data_root
        return _maybe_crop(load_custom_scene(scene_dir, subsample=4 if low_res else 1,
                                             device=device))
    raise ValueError(f"unknown dataset {dataset!r} - expected synthetic | dtu "
                     f"| bmvs | multiface | custom | phenorobcp1 | easypbr")
