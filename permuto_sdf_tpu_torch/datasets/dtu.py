"""DTU / BlendedMVS scenes in the IDR layout (counterpart of
``permuto_sdf_tpu/datasets/dtu.py``)::

    <scene>/image/%06d.png    rgb images
    <scene>/mask/%06d.png     optional binary masks
    <scene>/cameras.npz       world_mat_%d (P = K[R|t]), scale_mat_%d

``scale_mat`` normalizes the scene into the unit sphere, and
``scene_scale_multiplier`` (0.4, DTU's) shrinks it further into the r = 0.5
bound. The JAX loader reads images with ``imageio`` and decomposes P with
``cv2.decomposeProjectionMatrix``; the port reads PNGs with its own codec
(:mod:`permuto_sdf_tpu_torch.datasets.image_io`) and decomposes P as cv2
does (:func:`rq3`), signs included: for P = s K [R|t] with s < 0 the
decomposed K keeps negative focal entries and R is not the true rotation,
while the camera centre is the same.
"""

from __future__ import annotations

import concurrent.futures
import glob
import os

import numpy as np
import torch

from permuto_sdf_tpu_torch.datasets.image_io import read_png, read_pngs, write_png
from permuto_sdf_tpu_torch.datasets.tensor_reel import TensorReel
from permuto_sdf_tpu_torch.device import resolve_device


def _to_float_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> float32 [H, W, 3] in [0, 1] (grey
    repeated, alpha dropped)."""
    img = np.asarray(img, dtype=np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return img[..., :3]


def _load_image(path: str) -> np.ndarray:
    return _to_float_rgb(read_png(path))


def _load_images(paths) -> list:
    """:func:`_load_image` of each path, the files decoded together."""
    return [_to_float_rgb(img) for img in read_pngs(paths)]


def rq3(M: np.ndarray):
    """RQ decomposition of a 3x3 matrix by three Givens rotations, with
    OpenCV's sign rule (``cvRQDecomp3x3``): M = R Q, the first two diagonal
    entries of R non-negative, det Q = +1. -> (R, Q) float64."""
    M = np.array(M, np.float64)

    def givens(c, s):
        z = 1.0 / np.sqrt(c * c + s * s)
        return c * z, s * z

    c, s = givens(M[2, 2], M[2, 1])
    Qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    R = M @ Qx
    R[2, 1] = 0
    c, s = givens(R[2, 2], -R[2, 0])
    Qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    M = R @ Qy
    M[2, 0] = 0
    c, s = givens(M[1, 1], M[1, 0])
    Qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    R = M @ Qz
    R[1, 0] = 0
    # the decomposition's ambiguity: rotate R by 180 degrees so that its
    # first two diagonal entries are positive (OpenCV's order of cases)
    if R[0, 0] < 0:
        if R[1, 1] < 0:  # about z
            R[0, 0] *= -1
            R[0, 1] *= -1
            R[1, 1] *= -1
            Qz[:2, :2] *= -1
        else:  # about y
            R[0, 0] *= -1
            R[0, 2] *= -1
            R[1, 2] *= -1
            R[2, 2] *= -1
            Qz = Qz.T
            Qy[np.ix_((0, 2), (0, 2))] *= -1
    elif R[1, 1] < 0:  # about x
        R[0, 1] *= -1
        R[1, 1] *= -1
        R[1, 2] *= -1
        R[2, 2] *= -1
        Qz, Qy = Qz.T, Qy.T
        Qx[1:, 1:] *= -1
    return R, Qz.T @ Qy.T @ Qx.T


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection into (K [3,3], cam-to-world [4,4]), as
    the JAX loader does with ``cv2.decomposeProjectionMatrix``: K from the
    RQ decomposition of P's left 3x3 divided by its K[2, 2], the camera
    centre from P's null vector."""
    P = np.asarray(P, np.float64)
    K, R = rq3(P[:, :3])
    _, _, vt = np.linalg.svd(np.concatenate([P, np.zeros((1, 4))]))
    t = vt[3]  # the homogeneous camera centre, up to its sign
    K = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = t[:3] / t[3]
    return K.astype(np.float32), pose


def export_dtu_scene(reel: TensorReel, out_dir: str,
                     scene_scale_multiplier: float = 0.4,
                     scale: float = 2.0,
                     center=(0.03, -0.02, 0.05)) -> str:
    """Write a :class:`TensorReel` (float or uint8) to the DTU/IDR layout
    (``image/%06d.png``, ``mask/%06d.png``, ``cameras.npz`` with
    ``world_mat_%d``/``scale_mat_%d``) so that ``load_dtu_scene(out_dir,
    scene_scale_multiplier=...)`` gives the reel back (images to 8 bits,
    cameras to float precision). The cameras are stored in a "raw capture"
    frame behind a non-trivial ``scale_mat`` (``scale`` and ``center``), so
    a round trip runs the whole world_mat @ scale_mat decomposition and the
    ``scene_scale_multiplier`` shrink. The images are written on every host
    core (``zlib`` and numpy release the interpreter lock)."""
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    has_mask = reel.mask is not None
    if has_mask:
        os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)

    # scale_mat: normalized-world -> raw-world (x_raw = s * x_n + c)
    scale_mat = np.eye(4, dtype=np.float64)
    scale_mat[0, 0] = scale_mat[1, 1] = scale_mat[2, 2] = scale
    scale_mat[:3, 3] = np.asarray(center, np.float64)

    def to8(x: torch.Tensor) -> np.ndarray:
        if x.dtype == torch.uint8:  # quantize_reel storage
            return x.cpu().numpy()
        return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8).cpu().numpy()

    rgb8 = to8(reel.rgb)
    mask8 = None
    if has_mask:
        mask8 = (reel.mask[..., 0] > 0.5).to(torch.uint8).cpu().numpy() * 255
    Ks = reel.K.cpu().numpy()
    tfs = reel.tf_world_cam.cpu().numpy()
    cams = {}
    jobs = []
    for i in range(reel.nr_images):
        jobs.append((os.path.join(out_dir, "image", f"{i:06d}.png"), rgb8[i]))
        if has_mask:
            jobs.append((os.path.join(out_dir, "mask", f"{i:06d}.png"), mask8[i]))
        # the loader multiplies the decomposed camera centre by
        # scene_scale_multiplier: store poses in the pre-shrink frame
        pose_n = tfs[i].astype(np.float64).copy()
        pose_n[:3, 3] /= scene_scale_multiplier
        K4 = np.eye(4, dtype=np.float64)
        K4[:3, :3] = Ks[i]
        # world_mat @ scale_mat must equal K [R|t] of the normalized world
        world_mat = K4 @ np.linalg.inv(pose_n) @ np.linalg.inv(scale_mat)
        cams[f"world_mat_{i}"] = world_mat
        cams[f"scale_mat_{i}"] = scale_mat
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for fut in [pool.submit(write_png, p, img) for p, img in jobs]:
            fut.result()
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)
    return out_dir


def load_dtu_scene(scene_dir: str, low_res: bool = False, with_mask: bool = True,
                   scene_scale_multiplier: float = 0.4,
                   subsample: int | None = None, device=None) -> TensorReel:
    """A DTU/BMVS scene directory -> TensorReel on ``device`` (None means
    the GPU)."""
    device = resolve_device(device)
    cams = np.load(os.path.join(scene_dir, "cameras.npz"))
    img_paths = sorted(
        glob.glob(os.path.join(scene_dir, "image", "*.png"))
        + glob.glob(os.path.join(scene_dir, "image", "*.jpg"))
    )
    if not img_paths:
        raise FileNotFoundError(f"no images under {scene_dir}/image")
    n = len(img_paths)
    sub = subsample or (2 if low_res else 1)

    Ks, tfs = [], []
    for i in range(n):
        world_mat = cams[f"world_mat_{i}"]
        scale_mat = (cams[f"scale_mat_{i}"] if f"scale_mat_{i}" in cams
                     else np.eye(4, dtype=world_mat.dtype))
        P = (world_mat @ scale_mat)[:3, :4]
        K, pose = load_K_Rt_from_P(P)
        if sub > 1:
            K[:2] /= sub
        Ks.append(K)
        # scene_scale_multiplier shrinks the normalized scene into the
        # r = 0.5 bound (DTU: 0.4)
        pose[:3, 3] *= scene_scale_multiplier
        tfs.append(pose)
    rgbs = [img[::sub, ::sub] for img in _load_images(img_paths)]

    mask_arr = None
    mpaths = [os.path.join(scene_dir, "mask", os.path.basename(p)) for p in img_paths]
    if with_mask and all(os.path.exists(p) for p in mpaths):
        masks = [(m[::sub, ::sub, :1] > 0.5).astype(np.float32) for m in _load_images(mpaths)]
        mask_arr = torch.from_numpy(np.stack(masks)).to(device)

    return TensorReel(
        rgb=torch.from_numpy(np.stack(rgbs)).to(device),
        mask=mask_arr,
        K=torch.from_numpy(np.stack(Ks)).to(device),
        tf_world_cam=torch.from_numpy(np.stack(tfs)).to(device),
    )
