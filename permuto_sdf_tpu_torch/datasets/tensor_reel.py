"""The training image stack and ray generation (counterpart of
``permuto_sdf_tpu/datasets/tensor_reel.py``: ``TensorReel``,
``random_rays_from_reel``, ``rays_from_frame`` and
``look_at_cam_to_world``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class TensorReel:
    """Posed images on one device: rgb [N, H, W, 3] float32 in [0, 1], mask
    [N, H, W, 1] or None, K [N, 3, 3], tf_world_cam [N, 4, 4]
    camera-to-world."""

    rgb: torch.Tensor
    mask: Optional[torch.Tensor]
    K: torch.Tensor
    tf_world_cam: torch.Tensor

    @property
    def nr_images(self) -> int:
        return self.rgb.shape[0]

    @property
    def height(self) -> int:
        return self.rgb.shape[1]

    @property
    def width(self) -> int:
        return self.rgb.shape[2]

    def to(self, device) -> "TensorReel":
        return TensorReel(*(None if t is None else t.to(device) for t in
                            (self.rgb, self.mask, self.K, self.tf_world_cam)))


def draw_ray_indices(reel: TensorReel, nr_rays: int, generator: torch.Generator):
    """(image ids [R], pixel ids [R]) uniform over the reel, drawn on the CPU."""
    img = torch.randint(0, reel.nr_images, (nr_rays,), generator=generator)
    pix = torch.randint(0, reel.height * reel.width, (nr_rays,), generator=generator)
    return img, pix


def random_rays_from_reel(reel: TensorReel, nr_rays: int, generator=None, indices=None,
                          apply_mask: bool = True):
    """-> (ray_origins [R,3], ray_dirs [R,3], gt_rgb [R,3], gt_mask [R,1],
    img_indices [R]) for ``indices = (image ids, pixel ids)`` (JAX draws
    them with ``randint`` from the two halves of its key), else drawn from
    ``generator``. ``apply_mask`` multiplies gt_rgb by the mask; trainers
    pass ``cfg.with_mask``."""
    if indices is None:
        indices = draw_ray_indices(reel, nr_rays, generator)
    dev = reel.rgb.device
    img_idx, pix_idx = (torch.as_tensor(t).to(device=dev, dtype=torch.int64) for t in indices)
    w = reel.width
    px = (pix_idx % w).to(torch.float32) + 0.5
    py = torch.div(pix_idx, w, rounding_mode="floor").to(torch.float32) + 0.5
    K = reel.K[img_idx]
    fx, fy, cx, cy = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]
    cam = torch.stack([(px - cx) / fx, (py - cy) / fy, torch.ones_like(px)], dim=-1)
    tf = reel.tf_world_cam[img_idx]
    R_mat, t = tf[:, :3, :3], tf[:, :3, 3]
    world = (R_mat[:, :, 0] * cam[:, 0:1] + R_mat[:, :, 1] * cam[:, 1:2]
             + R_mat[:, :, 2] * cam[:, 2:3]) + t
    dirs = world - t
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    yi = (py - 0.5).to(torch.int64)
    xi = (px - 0.5).to(torch.int64)
    gt_rgb = reel.rgb[img_idx, yi, xi]
    if reel.mask is not None:
        gt_mask = reel.mask[img_idx, yi, xi]
        if apply_mask:
            gt_rgb = gt_rgb * gt_mask
    else:
        gt_mask = torch.ones((nr_rays, 1), dtype=gt_rgb.dtype, device=dev)
    return t.contiguous(), dirs, gt_rgb, gt_mask, img_idx


def rays_from_frame(K, tf_world_cam, width: int, height: int, device=None):
    """All-pixel rays -> (origins [H*W, 3], dirs [H*W, 3]), row-major pixel
    order (x fastest). ``K`` [3,3] and ``tf_world_cam`` [4,4] may be numpy
    or tensors; computed in float32 on ``device``."""
    K = torch.as_tensor(np.asarray(K, dtype=np.float32), device=device)
    tf = torch.as_tensor(np.asarray(tf_world_cam, dtype=np.float32), device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    cam = torch.stack([(px - cx) / fx, (py - cy) / fy, torch.ones_like(px)],
                      dim=-1).reshape(-1, 3)
    world = cam @ tf[:3, :3].T + tf[:3, 3]
    dirs = world - tf[:3, 3]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = tf[:3, 3].expand(dirs.shape).contiguous()
    return origins, dirs


def look_at_cam_to_world(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """Camera-to-world 4x4 (numpy float64) for a camera at ``eye`` looking at
    ``target`` (OpenCV convention: +z forward, +x right, +y down)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    tf = np.eye(4)
    tf[:3, 0] = right
    tf[:3, 1] = down
    tf[:3, 2] = fwd
    tf[:3, 3] = eye
    return tf
