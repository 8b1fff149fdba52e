"""The training image stack and ray generation (counterpart of
``permuto_sdf_tpu/datasets/tensor_reel.py``: ``TensorReel``,
``quantize_reel``, ``shard_reel``, ``random_rays_from_reel``,
``rays_from_reprojection_reel``, ``rays_from_frame``,
``look_at_cam_to_world`` and ``crop_reel_to_sphere``). The samplers take
their draws as ``indices`` (JAX draws them with ``randint`` from the two
halves of its key) or from a ``torch.Generator``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class TensorReel:
    """Posed images on one device: rgb [N, H, W, 3] float32 in [0, 1] or
    uint8 (:func:`quantize_reel`), mask [N, H, W, 1] (float32 or uint8) or
    None, K [N, 3, 3], tf_world_cam [N, 4, 4] camera-to-world. ``img_ids``
    [N] gives each row's global image id on a shard of a larger reel
    (:func:`shard_reel`); None means the rows are numbered globally."""

    rgb: torch.Tensor
    mask: Optional[torch.Tensor]
    K: torch.Tensor
    tf_world_cam: torch.Tensor
    img_ids: Optional[torch.Tensor] = None

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
        return TensorReel(**{f.name: None if getattr(self, f.name) is None
                             else getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def quantize_reel(reel: TensorReel) -> TensorReel:
    """The reel with uint8 pixels: 4x less device memory. The samplers
    dequantize after the gather (:func:`_dequant`), so a reel read from
    8-bit files gives the same rays and targets as its float copy."""
    q = lambda x: torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)  # noqa: E731
    return dataclasses.replace(
        reel,
        rgb=q(reel.rgb) if reel.rgb.dtype != torch.uint8 else reel.rgb,
        mask=(None if reel.mask is None else
              (q(reel.mask) if reel.mask.dtype != torch.uint8 else reel.mask)),
    )


def _dequant(x: torch.Tensor) -> torch.Tensor:
    """Post-gather dequantization: uint8 reels store pixels as 0..255. The
    divisor is a tensor: CUDA divides by a host scalar as a product with
    its reciprocal, which is not the loaders' correctly rounded u / 255."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / torch.full((), 255.0, device=x.device)
    return x


def shard_reel(reel: TensorReel, n_devices: int) -> TensorReel:
    """The reel's image axis padded by wrapping to ``n_devices * L``
    (L = ceil(N / n_devices)), with ``img_ids`` recording each row's global
    image id, so that each device's ``L`` rows form a reel of their own and
    its samplers report global ids."""
    n = reel.nr_images
    L = -(-n // n_devices)
    ids = torch.arange(n_devices * L, device=reel.rgb.device) % n
    take = lambda x: x[ids]  # noqa: E731
    return TensorReel(
        rgb=take(reel.rgb),
        mask=None if reel.mask is None else take(reel.mask),
        K=take(reel.K),
        tf_world_cam=take(reel.tf_world_cam),
        img_ids=take(reel.img_ids) if reel.img_ids is not None else ids,
    )


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
    return (t.contiguous(), dirs) + _targets(reel, img_idx, yi, xi, apply_mask)


def _targets(reel: TensorReel, img_idx, yi, xi, apply_mask: bool):
    """-> (gt_rgb [R,3] float32, gt_mask [R,1], global image ids [R]) of the
    pixels (img_idx, yi, xi): dequantized after the gather, the rgb times
    the mask with ``apply_mask``; a shard reports its rows' global ids."""
    gt_rgb = _dequant(reel.rgb[img_idx, yi, xi])
    if reel.mask is not None:
        gt_mask = _dequant(reel.mask[img_idx, yi, xi])
        if apply_mask:
            gt_rgb = gt_rgb * gt_mask
    else:
        gt_mask = torch.ones((img_idx.shape[0], 1), dtype=gt_rgb.dtype, device=gt_rgb.device)
    if reel.img_ids is not None:
        img_idx = reel.img_ids[img_idx]
    return gt_rgb, gt_mask, img_idx


def rays_from_reprojection_reel(reel: TensorReel, points_reprojected, generator=None,
                                indices=None, apply_mask: bool = True):
    """Rays that look at the given 3D points [N, 3] from random training
    cameras: each point is projected into the camera of its image id; a
    projection outside the image takes the pixel id's pixel centre instead.
    ``indices = (image ids [N], pixel ids [N])``, else drawn from
    ``generator``. -> (ray_origins [N,3], ray_dirs [N,3], gt_rgb [N,3],
    gt_mask [N,1], img_indices [N])."""
    dev = reel.rgb.device
    pts = torch.as_tensor(points_reprojected, dtype=torch.float32, device=dev)
    if indices is None:
        indices = draw_ray_indices(reel, pts.shape[0], generator)
    img_idx, rand_pix = (torch.as_tensor(t).to(device=dev, dtype=torch.int64) for t in indices)
    h, w = reel.height, reel.width
    tf = reel.tf_world_cam[img_idx]  # [N, 4, 4] cam->world
    R_wc, t_wc = tf[:, :3, :3], tf[:, :3, 3]
    q = pts - t_wc  # world->cam is the inverse rigid transform: R^T (p - t)
    cam_pts = R_wc[:, 0, :] * q[:, 0:1] + R_wc[:, 1, :] * q[:, 1:2] + R_wc[:, 2, :] * q[:, 2:3]
    K = reel.K[img_idx]
    fx, fy, cx, cy = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]
    sx = cam_pts[:, 0] * fx / cam_pts[:, 2] + cx
    sy = cam_pts[:, 1] * fy / cam_pts[:, 2] + cy
    in_bounds = ((torch.floor(sx) >= 0) & (torch.floor(sx) < w)
                 & (torch.floor(sy) >= 0) & (torch.floor(sy) < h))
    # out-of-bounds projections fall back to the pixel id's pixel centre
    sx = torch.where(in_bounds, sx, (rand_pix % w).to(sx.dtype) + 0.5)
    sy = torch.where(in_bounds, sy, torch.div(rand_pix, w, rounding_mode="floor").to(sy.dtype)
                     + 0.5)
    cam = torch.stack([(sx - cx) / fx, (sy - cy) / fy, torch.ones_like(sx)], dim=-1)
    world = (R_wc[:, :, 0] * cam[:, 0:1] + R_wc[:, :, 1] * cam[:, 1:2]
             + R_wc[:, :, 2] * cam[:, 2:3]) + t_wc
    dirs = world - t_wc
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    yi = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 1)
    xi = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 1)
    return (t_wc.contiguous(), dirs) + _targets(reel, img_idx, yi, xi, apply_mask)


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


def crop_reel_to_sphere(reel: TensorReel, radius: float = 0.5,
                        center=(0.0, 0.0, 0.0)) -> TensorReel:
    """Crop every frame to the projected bounding sphere, all to one size:
    per frame, project the sphere's extremes along the camera's x and y
    axes to a 2D box, clamp it into the image, grow every box to the
    largest one that fits every frame, and shift each principal point by
    its crop offset. A cropped pixel's ray equals the original pixel's.
    Runs once on the host at load time; the result lies on the reel's
    device."""
    dev = reel.rgb.device
    rgb = reel.rgb.cpu().numpy()
    mask = reel.mask.cpu().numpy() if reel.mask is not None else None
    Ks = reel.K.cpu().numpy().copy()
    tfs = reel.tf_world_cam.cpu().numpy()
    N, H, W = rgb.shape[:3]
    c = np.asarray(center, np.float64)

    def project(i, p_world):
        tf = tfs[i]
        R, t = tf[:3, :3], tf[:3, 3]
        cam = R.T @ (np.asarray(p_world, np.float64) - t)
        px = Ks[i] @ (cam / max(cam[2], 1e-9))
        return px[:2]

    crops = []
    max_w = max_h = 0
    for i in range(N):
        x_axis, y_axis = tfs[i][:3, 0], tfs[i][:3, 1]
        x_neg = project(i, c - x_axis * radius)
        x_pos = project(i, c + x_axis * radius)
        y_pos = project(i, c + y_axis * radius)  # +y is down in pixels
        y_neg = project(i, c - y_axis * radius)
        sx = int(np.floor(min(x_neg[0], x_pos[0])))
        sy = int(np.floor(min(y_pos[1], y_neg[1])))
        w = int(np.ceil(abs(x_pos[0] - x_neg[0])))
        h = int(np.ceil(abs(y_neg[1] - y_pos[1])))
        sx, sy = max(sx, 0), max(sy, 0)
        w, h = min(w, W - sx), min(h, H - sy)
        crops.append([sx, sy, w, h])
        max_w, max_h = max(max_w, w), max(max_h, h)
    max_w, max_h = min(max_w, W), min(max_h, H)

    out_rgb = np.empty((N, max_h, max_w, 3), rgb.dtype)
    out_mask = (np.empty((N, max_h, max_w, mask.shape[-1]), mask.dtype)
                if mask is not None else None)
    for i, (sx, sy, w, h) in enumerate(crops):
        # grow to (max_w, max_h) around the box, inside the image
        sx = min(max(0, sx - (max_w - w) // 2), W - max_w)
        sy = min(max(0, sy - (max_h - h) // 2), H - max_h)
        out_rgb[i] = rgb[i, sy:sy + max_h, sx:sx + max_w]
        if out_mask is not None:
            out_mask[i] = mask[i, sy:sy + max_h, sx:sx + max_w]
        Ks[i][0, 2] -= sx
        Ks[i][1, 2] -= sy

    return TensorReel(
        rgb=torch.from_numpy(out_rgb).to(dev),
        mask=torch.from_numpy(out_mask).to(dev) if out_mask is not None else None,
        K=torch.from_numpy(Ks).to(dev),
        tf_world_cam=reel.tf_world_cam,
    )
