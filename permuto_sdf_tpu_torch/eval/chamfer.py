"""Chamfer distance evaluation, DTU protocol style (counterpart of
``permuto_sdf_tpu/eval/chamfer.py``, numpy and scipy on the host as there:
the nearest-neighbour queries run in scipy's cKDTree).

Point-to-surface distances with downsampling and a max-distance cap (the
DTU protocol uses downsample 0.2 and max_dist 20 in mm units; defaults here
are expressed in scene units and configurable). Meshes are numpy arrays: a
mesh from :func:`permuto_sdf_tpu_torch.ops.marching_cubes.extract_mesh_from_sdf_fn`
comes to the host with ``.cpu().numpy()``. The queries use every host
core (``workers=-1``); the distances are the JAX module's.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def _downsample(points: np.ndarray, cell: float) -> np.ndarray:
    """Keep one point per voxel of size ``cell`` (DTUeval's downsample)."""
    if cell <= 0:
        return points
    keys = np.floor(points / cell).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def chamfer_distance(points_a: np.ndarray, points_b: np.ndarray,
                     downsample: float = 0.0, max_dist: float = np.inf):
    """Symmetric point-cloud Chamfer: mean of capped nearest-neighbor
    distances both ways. Returns (mean_both, mean_a2b, mean_b2a)."""
    a = _downsample(np.asarray(points_a, np.float64), downsample)
    b = _downsample(np.asarray(points_b, np.float64), downsample)
    d_ab = cKDTree(b).query(a, k=1, workers=-1)[0]
    d_ba = cKDTree(a).query(b, k=1, workers=-1)[0]
    d_ab = np.minimum(d_ab, max_dist)
    d_ba = np.minimum(d_ba, max_dist)
    return (d_ab.mean() + d_ba.mean()) / 2.0, d_ab.mean(), d_ba.mean()


def sample_mesh_surface(V: np.ndarray, F: np.ndarray, nr_points: int,
                        seed: int = 0) -> np.ndarray:
    """Area-weighted surface samples for mesh-to-mesh Chamfer."""
    from permuto_sdf_tpu_torch.datasets.mesh_io import Mesh, sample_points_on_mesh

    rng = np.random.default_rng(seed)
    pts, _ = sample_points_on_mesh(Mesh(V.astype(np.float32), F), nr_points, rng)
    return pts


def dtueval_sample_mesh(V: np.ndarray, F: np.ndarray,
                        density: float = 0.2) -> np.ndarray:
    """DTUeval's deterministic mesh sampling (DTUeval-python/eval.py:9-72):
    all vertices + a barycentric grid on each triangle whose pitch is
    ``density`` (n1 x n2 grid points with k1/n1 + k2/n2 < 1). Vectorized by
    grouping triangles with equal (n1, n2)."""
    V = np.asarray(V, np.float64)
    F = np.asarray(F, np.int64)
    tri = V[F]  # [T, 3, 3]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    nz = area2 > 0
    v1, v2, base, l1, l2, area2 = v1[nz], v2[nz], tri[nz, 0], l1[nz], l2[nz], area2[nz]
    thr = density * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)

    out = [V]
    keys = n1 * 1_000_000 + n2
    for key in np.unique(keys):
        sel = keys == key
        a, b = int(n1[sel][0]), int(n2[sel][0])
        c = np.mgrid[: a + 1, : b + 1].astype(np.float64) + 0.5
        c[0] /= max(a, 1e-7)
        c[1] /= max(b, 1e-7)
        c = np.transpose(c, (1, 2, 0)).reshape(-1, 2)
        k = c[c.sum(-1) < 1]  # [m, 2]
        if len(k) == 0:
            continue
        pts = (v1[sel][:, None, :] * k[None, :, :1]
               + v2[sel][:, None, :] * k[None, :, 1:]
               + base[sel][:, None, :])
        out.append(pts.reshape(-1, 3))
    return np.concatenate(out, axis=0)


def radius_downsample(points: np.ndarray, radius: float,
                      seed: int = 0) -> np.ndarray:
    """Greedy radius-based downsampling (DTUeval's shuffled
    radius_neighbors pass, eval.py:81-97): keep a point, drop everything
    within ``radius`` of it. Implemented via voxel bucketing: exact greedy
    within a deterministic processing order, batched with cKDTree."""
    points = np.asarray(points, np.float64)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(points))
    pts = points[order]
    tree = cKDTree(pts)
    alive = np.ones(len(pts), bool)
    # process in chunks: for each still-alive point (in order), kill its
    # neighbors; chunking keeps the python loop at ~hundreds of iterations
    chunk = 4096
    for start in range(0, len(pts), chunk):
        idxs = [i for i in range(start, min(start + chunk, len(pts))) if alive[i]]
        if not idxs:
            continue
        balls = tree.query_ball_point(pts[idxs], r=radius, workers=-1)
        for i, ball in zip(idxs, balls):
            if alive[i]:
                alive[ball] = False
                alive[i] = True
    return pts[alive]


def dtu_chamfer(V_pred: np.ndarray, F_pred: np.ndarray, gt_points: np.ndarray,
                downsample_density: float = 0.2, max_dist: float = 20.0,
                obs_mask: np.ndarray | None = None,
                bb: np.ndarray | None = None, res: float | None = None,
                patch: float = 60.0,
                ground_plane: np.ndarray | None = None, seed: int = 0):
    """The DTUeval protocol (DTUeval-python/eval.py), faithfully:

    1. sample the predicted mesh deterministically at ``downsample_density``
       pitch (vertices + triangle grids), then greedy radius-downsample;
    2. optionally filter by the official observability mask volume
       (``ObsMask<scan>_10.mat``: obs_mask [X,Y,Z] uint8, bb [2,3], res
       scalar, patch margin 60) for the data->stl direction;
    3. d2s = NN distances pred->gt with distances >= max_dist DISCARDED
       (not clamped — eval.py:121);
    4. s2d = NN distances gt->pred (gt optionally filtered to above the
       official ground plane ``Plane<scan>.mat``), same discard;
    5. overall = (mean_d2s + mean_s2d) / 2.

    Units are the GT point cloud's (mm for DTU). Returns
    (overall, mean_d2s, mean_s2d)."""
    data_pcd = dtueval_sample_mesh(V_pred, F_pred, downsample_density)
    data_down = radius_downsample(data_pcd, downsample_density, seed=seed)

    gt_points = np.asarray(gt_points, np.float64)
    if obs_mask is not None and bb is not None and res is not None:
        bb = np.asarray(bb, np.float64)
        inbound = ((data_down >= bb[:1] - patch)
                   & (data_down < bb[1:] + patch * 2)).sum(-1) == 3
        data_in = data_down[inbound]
        grid = np.around((data_in - bb[:1]) / res).astype(np.int64)
        shape = np.asarray(obs_mask.shape)[None]
        grid_in = ((grid >= 0) & (grid < shape)).sum(-1) == 3
        gi = grid[grid_in]
        in_obs = obs_mask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
        data_in_obs = data_in[grid_in][in_obs]
    else:
        data_in = data_down
        data_in_obs = data_down

    d2s = cKDTree(gt_points).query(data_in_obs, k=1, workers=-1)[0]
    mean_d2s = float(d2s[d2s < max_dist].mean()) if len(d2s) else float("nan")

    stl = gt_points
    if ground_plane is not None:
        gp = np.asarray(ground_plane, np.float64).reshape(4)
        above = stl @ gp[:3] + gp[3] > 0
        stl = stl[above]
    s2d = cKDTree(data_in).query(stl, k=1, workers=-1)[0]
    mean_s2d = float(s2d[s2d < max_dist].mean()) if len(s2d) else float("nan")
    return (mean_d2s + mean_s2d) / 2.0, mean_d2s, mean_s2d


def point_mesh_chamfer(V_pred: np.ndarray, F_pred: np.ndarray,
                       V_gt: np.ndarray, F_gt: np.ndarray,
                       nr_samples: int = 200_000, downsample: float = 0.0,
                       max_dist: float = np.inf, seed: int = 0):
    """Mesh-to-mesh Chamfer via dense surface sampling on both meshes —
    the practical form of the DTU point-to-surface protocol for
    watertight extracted meshes."""
    pa = sample_mesh_surface(V_pred, F_pred, nr_samples, seed)
    pb = sample_mesh_surface(V_gt, F_gt, nr_samples, seed + 1)
    return chamfer_distance(pa, pb, downsample=downsample, max_dist=max_dist)
