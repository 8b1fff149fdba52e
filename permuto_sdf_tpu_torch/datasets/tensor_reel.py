"""Ray generation for one frame (counterpart of
``permuto_sdf_tpu/datasets/tensor_reel.py::rays_from_frame`` and
``look_at_cam_to_world``)."""

from __future__ import annotations

import numpy as np
import torch


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
