"""Multiface captures (counterpart of ``permuto_sdf_tpu/datasets/multiface.py``).
The release layout is

    <root>/<subject_name>/KRT                      camera calibration
    <root>/<subject_name>/images/<sequence>/<camera>/<frame>.png

with the codec-avatar ``KRT`` text format per camera:

    <camera_id>
    k11 k12 k13          (3 intrinsics rows)
    ...
    d1 d2 d3 d4 d5       (distortion, ignored: the images are rectified)
    r11 r12 r13 t1       (3 extrinsics rows, WORLD-TO-CAMERA [R|t])
    ...
    <blank line>

The subject presets (a rotation, translation and scale that move the head
into the r = 0.5 bound; the capture is in millimetres, hence 0.0023) are
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from permuto_sdf_tpu_torch.datasets.dtu import _load_image
from permuto_sdf_tpu_torch.datasets.tensor_reel import TensorReel
from permuto_sdf_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MultifaceSubject:
    """One subject preset."""

    subject_name: str
    sequence: str
    test_cameras: tuple
    timestep: int = 0
    scene_rotate_x_angle: float = 0.0
    scene_translation: tuple = (0.0, 0.0, 0.0)
    scene_scale_multiplier: float = 0.0023


SUBJECTS = {
    0: MultifaceSubject(
        "m--20180105--0000--002539136--GHS", "E027_Scrunch_Face_Squeeze_Eyes",
        (400049, 400017, 400012, 400002), 0, 150.0, (0.07, 1.6, 2.3), 0.0023),
    1: MultifaceSubject(
        "m--20180226--0000--6674443--GHS", "E027_Scrunch_Face_Squeeze_Eyes",
        (400049, 400017, 400012, 400002), 0, 200.0, (-0.07, -0.65, 2.2), 0.0023),
    2: MultifaceSubject(
        "m--20180227--0000--6795937--GHS", "E057_Cheeks_Puffed",
        (400049, 400017, 400012, 400002), 0, -180.0, (0.0, 0.0, 2.4), 0.0023),
}


def parse_krt(path: str) -> dict:
    """KRT file -> {camera_id: (K [3,3], Rt_world_to_cam [3,4])}."""
    cameras = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        name = lines[i].split()[0]
        K = np.asarray([[float(x) for x in lines[i + j + 1].split()]
                        for j in range(3)], np.float64)
        # distortion row at i+4 (ignored), extrinsics at i+5..i+7
        Rt = np.asarray([[float(x) for x in lines[i + j + 5].split()]
                         for j in range(3)], np.float64)
        cameras[name] = (K, Rt)
        i += 8
    return cameras


def _rot_x(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _find_camera_image(subject_dir: str, sequence: str, cam: str, timestep: int):
    pats = [
        os.path.join(subject_dir, "images", sequence, cam, "*"),
        os.path.join(subject_dir, "images", sequence, f"cam{cam}", "*"),
        os.path.join(subject_dir, "images", cam, "*"),
    ]
    for pat in pats:
        files = sorted(p for p in glob.glob(pat)
                       if p.lower().endswith((".png", ".jpg", ".jpeg")))
        if files:
            return files[min(timestep, len(files) - 1)]
    return None


def load_multiface_scene(dataset_path: str, subject, low_res: bool = False,
                         mode: str = "train", subsample: int | None = None,
                         device=None) -> TensorReel:
    """One timestep of a multiface subject -> TensorReel on ``device``
    (None means the GPU). ``subject``: a preset id of :data:`SUBJECTS` or a
    :class:`MultifaceSubject`; ``mode`` "train" leaves out the preset's
    test cameras, "test" keeps only them."""
    device = resolve_device(device)
    if isinstance(subject, int):
        subject = SUBJECTS[subject]
    subject_dir = os.path.join(dataset_path, subject.subject_name)
    krt = parse_krt(os.path.join(subject_dir, "KRT"))
    sub = subsample or (4 if low_res else 1)

    # the world transform that moves the head into the r = 0.5 sphere
    Rx = _rot_x(subject.scene_rotate_x_angle)
    trans = np.asarray(subject.scene_translation, np.float64)
    scale = subject.scene_scale_multiplier
    test_set = {str(c) for c in subject.test_cameras}

    rgbs, Ks, tfs = [], [], []
    for cam, (K, Rt) in sorted(krt.items()):
        is_test = cam in test_set
        if (mode == "train") == is_test:
            continue
        img_path = _find_camera_image(subject_dir, subject.sequence, cam, subject.timestep)
        if img_path is None:
            continue
        img = _load_image(img_path)
        if sub > 1:
            img = img[::sub, ::sub]
            K = K.copy()
            K[:2] = K[:2] / sub

        # cam-to-world from the world-to-cam [R|t], then the scene
        # transform p' = scale * (Rx @ p + trans)
        R_wc, t_wc = Rt[:, :3], Rt[:, 3]
        C = -R_wc.T @ t_wc  # camera centre in the capture frame (mm)
        tf = np.eye(4, dtype=np.float32)
        tf[:3, :3] = Rx @ R_wc.T
        tf[:3, 3] = scale * (Rx @ C + trans)
        rgbs.append(img)
        Ks.append(K.astype(np.float32))
        tfs.append(tf)

    if not rgbs:
        raise FileNotFoundError(
            f"no {mode} images found for {subject.subject_name} under {dataset_path}")
    return TensorReel(
        rgb=torch.from_numpy(np.stack(rgbs)).to(device),
        mask=None,
        K=torch.from_numpy(np.stack(Ks)).to(device),
        tf_world_cam=torch.from_numpy(np.stack(tfs)).to(device),
    )
