"""NeuS-style mask-based mesh cleaning for the DTU evaluation protocol
(counterpart of ``permuto_sdf_tpu/eval/mesh_cleaning.py``, numpy and scipy
on the host).

Meshes trained without mask supervision are cleaned before Chamfer by

1. projecting every vertex into every training view with the DTU world
   matrices (P = K @ [R|t], the ``world_mat_<i>`` entries of
   ``cameras_sphere.npz``),
2. keeping only vertices that fall inside the dilated object mask in all
   views (a 101x101 elliptical kernel, one iteration; border pixels padded
   to "inside" as NeuS does),
3. dropping faces with any culled vertex and keeping the largest
   connected component.

scipy's ``binary_dilation`` and csgraph connected components stand in for
OpenCV and trimesh.
"""

from __future__ import annotations

import numpy as np


def _ellipse_struct(size: int = 101) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (size, size)) equivalent."""
    r = size / 2.0
    y, x = np.mgrid[:size, :size]
    cy = cx = (size - 1) / 2.0
    # cv2's ellipse inclusion rule: |dy| <= ry and |dx| <= rx*sqrt(1-(dy/ry)^2)
    ry = rx = (size - 1) / 2.0
    dy = np.abs(y - cy)
    dx = np.abs(x - cx)
    with np.errstate(invalid="ignore"):
        lim = rx * np.sqrt(np.maximum(0.0, 1.0 - (dy / max(ry, 1e-9)) ** 2))
    return (dx <= lim + 1e-9).astype(bool)


def dilate_mask(mask: np.ndarray, kernel_size: int = 101) -> np.ndarray:
    """Binary dilation with the elliptical kernel the reference uses."""
    from scipy.ndimage import binary_dilation

    return binary_dilation(mask.astype(bool), structure=_ellipse_struct(kernel_size))


def clean_points_by_mask(points: np.ndarray, world_mats: np.ndarray,
                         masks: np.ndarray, dilate_kernel: int = 101,
                         already_dilated: bool = False) -> np.ndarray:
    """[V] bool — vertices inside every view's dilated mask.

    ``world_mats``: [N, 3, 4] (or [N, 4, 4]) projection matrices mapping
    world -> pixel homogeneous coordinates. ``masks``: [N, H, W] bool.
    Matches the reference pixel-for-pixel: rounded pixel coords get a +1
    offset and the mask is padded with an "inside" border, so vertices
    projecting just off-frame survive (evaluate_chamfer_distance.py:121-139).
    """
    points = np.asarray(points, np.float64).reshape(-1, 3)
    inside = np.ones(len(points), bool)
    for P, mask in zip(world_mats, masks):
        P = np.asarray(P, np.float64)
        pts = points @ P[:3, :3].T + P[:3, 3]
        pts = pts / pts[:, 2:3]
        pix = np.round(pts).astype(np.int64) + 1

        m = mask if already_dilated else dilate_mask(mask, dilate_kernel)
        H, W = m.shape
        padded = np.ones((H + 2, W + 2), bool)
        padded[1 : H + 1, 1 : W + 1] = m
        py = np.clip(pix[:, 1], 0, H + 1)
        px = np.clip(pix[:, 0], 0, W + 1)
        inside &= padded[py, px]
    return inside


def largest_connected_component(V: np.ndarray, F: np.ndarray):
    """Keep the largest face-connected component (trimesh.split equivalent)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(V)
    e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]], axis=0)
    adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    ncomp, labels = connected_components(adj, directed=False)
    if ncomp <= 1:
        return V, F
    # component with most faces (reference: argmax over len(mesh.faces))
    face_label = labels[F[:, 0]]
    best = np.bincount(face_label, minlength=ncomp).argmax()
    keep_v = labels == best
    return _reindex(V, F, keep_v)


def _reindex(V, F, keep_v):
    index = np.full(len(V), -1, np.int64)
    index[keep_v] = np.arange(keep_v.sum())
    keep_f = keep_v[F[:, 0]] & keep_v[F[:, 1]] & keep_v[F[:, 2]]
    F_new = index[F[keep_f]]
    return V[keep_v], F_new


def clean_mesh(V: np.ndarray, F: np.ndarray, world_mats: np.ndarray,
               masks: np.ndarray, dilate_kernel: int = 101):
    """Full reference cleaning pipeline: mask-cull + largest component.

    Returns (V_clean, F_clean)."""
    keep = clean_points_by_mask(V, world_mats, masks, dilate_kernel)
    V2, F2 = _reindex(np.asarray(V), np.asarray(F, np.int64), keep)
    if len(F2) == 0:
        return V2, F2
    return largest_connected_component(V2, F2)
