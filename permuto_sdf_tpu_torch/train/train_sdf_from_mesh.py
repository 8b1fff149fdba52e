"""Supervised SDF fit from a known mesh (counterpart of
``permuto_sdf_tpu/train/train_sdf_from_mesh.py``).

Per iteration: 3000 surface points (+ normals) picked from a pool sampled
on the mesh, and 30000 uniform off-surface points in the bounding box, run
through ``sdf_with_gradient`` (kernels A and B forward; F and G for the
table in the backward), and ``sdf_loss / 30000`` minimised with Adam
(betas 0.9/0.99, eps 1e-15, lr 1e-3). The SDF model uses
``geom_feat_size_out=0`` and ``nr_iters_for_c2f=5000``.

JAX draws each step's surface indices and off-surface uniforms from the
step's key; the port takes them as tensors (:func:`train_step`), drawn by
:func:`draw_step` from a ``torch.Generator`` that :func:`train` derives
from ``(seed, iteration)`` as the flagship trainer does. The surface pool is sampled with numpy from
``seed`` exactly as JAX samples it. ``main`` extracts the fitted surface
with :func:`extract_mesh_from_sdf_fn` (kernel M on the card).

    python -m permuto_sdf_tpu_torch.train.train_sdf_from_mesh --smoke --out_mesh out.obj
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from permuto_sdf_tpu_torch.datasets.mesh_io import (
    Mesh,
    load_obj,
    make_uv_sphere,
    normalize_mesh_to_unit_sphere,
    sample_points_on_mesh,
    save_obj,
)
from permuto_sdf_tpu_torch.device import resolve_device
from permuto_sdf_tpu_torch.models.fields import SDFConfig, init_sdf, sdf_apply, sdf_with_gradient
from permuto_sdf_tpu_torch.ops.marching_cubes import extract_mesh_from_sdf_fn
from permuto_sdf_tpu_torch.ops.ray_primitives import AABB
from permuto_sdf_tpu_torch.train import checkpoint as ckpt
from permuto_sdf_tpu_torch.train.optimizers import ManualAdam
from permuto_sdf_tpu_torch.train.train_permuto_sdf import _grads_of, _with_grad, step_generators
from permuto_sdf_tpu_torch.utils.losses import sdf_loss

LR = 1e-3


def make_optimizer() -> ManualAdam:
    """Adam with betas 0.9/0.99, eps 1e-15 and no weight decay; the
    learning rate is given at each step."""
    return ManualAdam(b1=0.9, b2=0.99, eps=1e-15)


def draw_step(generator: torch.Generator, nr_surface: int, nr_offsurface: int,
              pool_size: int, dim: int = 3):
    """One step's draws on the CPU: (surface indices [nr_surface] int64 into
    the pool, off-surface uniforms u [nr_offsurface, dim] in [0, 1))."""
    idx = torch.randint(0, pool_size, (nr_surface,), generator=generator)
    u = torch.rand((nr_offsurface, dim), generator=generator)
    return idx, u


def loss_and_grads(params, idx, u, gt_points, gt_normals, iter_nr, cfg: SDFConfig,
                   aabb_lo, aabb_hi):
    """The fit loss of one step and the gradient of every leaf (a tree like
    ``params``) on the draws ``idx`` and ``u``."""
    device = gt_points.device
    idx, u = idx.to(device), u.to(device)
    nr_surface = idx.shape[0]
    surface_normals = gt_normals[idx]
    points = torch.cat([gt_points[idx], aabb_lo + u * (aabb_hi - aabb_lo)], dim=0)
    p = _with_grad(params)
    sdf, grads, _ = sdf_with_gradient(p, points, iter_nr, cfg)
    # the SIREN-style fit loss, scaled by 1/30000 to keep the backward's
    # magnitudes in float range
    loss = sdf_loss(sdf[:nr_surface], grads[:nr_surface], sdf[nr_surface:],
                    grads[nr_surface:], surface_normals) / 30000.0
    return loss.detach(), _grads_of(loss, p)


def train_step(params, opt_state, idx, u, gt_points, gt_normals, iter_nr, cfg: SDFConfig,
               optimizer: ManualAdam, aabb_lo, aabb_hi, lr: float = LR):
    """One fit step on the draws ``idx`` (surface indices into the pool)
    and ``u`` (off-surface uniforms) -> (params, opt_state, loss); the
    parameters and moments are updated in place."""
    loss, grads = loss_and_grads(params, idx, u, gt_points, gt_normals, iter_nr, cfg,
                                 aabb_lo, aabb_hi)
    params, opt_state = optimizer.update(grads, opt_state, params, lr)
    return params, opt_state, loss


def train(
    mesh: Mesh,
    nr_iters: int = 20000,
    lr: float = LR,
    nr_surface: int = 3000,
    nr_offsurface: int = 30000,
    surface_pool_size: int = 300_000,
    cfg: SDFConfig | None = None,
    seed: int = 0,
    log_every: int = 500,
    checkpoint_path: str | None = None,
    experiment_name: str = "sdf_from_mesh",
    save_every: int = 5000,
    device=None,
):
    """Returns (params, cfg, history), history a list of (iteration, loss).
    ``mesh`` should already be normalized into the [-0.5, 0.5] bounding box.
    ``device`` None means the GPU."""
    device = resolve_device(device)
    if cfg is None:
        cfg = SDFConfig(geom_feat_size_out=0, nr_iters_for_c2f=5000)

    rng = np.random.default_rng(seed)
    pool_pts, pool_nrm = sample_points_on_mesh(mesh, surface_pool_size, rng)
    gt_points = torch.from_numpy(pool_pts).to(device)
    gt_normals = torch.from_numpy(pool_nrm).to(device)

    aabb = AABB()
    aabb_lo = torch.tensor(aabb.min_corner, dtype=torch.float32, device=device)
    aabb_hi = torch.tensor(aabb.max_corner, dtype=torch.float32, device=device)

    params = init_sdf(torch.Generator().manual_seed(seed), cfg, device)
    optimizer = make_optimizer()
    opt_state = optimizer.init(params)

    history = []
    t0 = time.perf_counter()
    for it in range(nr_iters):
        idx, u = draw_step(step_generators(seed, it)[0], nr_surface, nr_offsurface,
                           surface_pool_size)
        params, opt_state, loss = train_step(params, opt_state, idx, u, gt_points, gt_normals,
                                             it, cfg, optimizer, aabb_lo, aabb_hi, lr)
        if it % log_every == 0 or it == nr_iters - 1:
            lv = float(loss)
            history.append((it, lv))
            print(f"iter {it:6d}  loss {lv:.6f}  ({time.perf_counter() - t0:.1f}s)")
        if checkpoint_path and save_every and it > 0 and it % save_every == 0:
            ckpt.save_model(checkpoint_path, experiment_name, it, "sdf_model", params)
    if checkpoint_path:
        ckpt.save_model(checkpoint_path, experiment_name, nr_iters, "sdf_model", params)
    return params, cfg, history


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train SDF from a mesh")
    parser.add_argument("--mesh", default=None, help="OBJ file (default: synthetic sphere)")
    parser.add_argument("--nr_iters", type=int, default=20000)
    parser.add_argument("--smoke", action="store_true",
                        help="tiny lattice + few iters; asserts loss decreases")
    parser.add_argument("--out_mesh", default=None, help="extract mesh to this OBJ")
    parser.add_argument("--mc_res", type=int, default=196)
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--exp_info", default="")
    args = parser.parse_args(argv)

    if args.mesh:
        mesh = normalize_mesh_to_unit_sphere(load_obj(args.mesh))
    else:
        mesh = make_uv_sphere(radius=0.3)

    if args.smoke:
        cfg = SDFConfig(geom_feat_size_out=0, nr_iters_for_c2f=200,
                        capacity=2 ** 12, nr_levels=8)
        params, cfg, history = train(
            mesh, nr_iters=400, cfg=cfg, nr_surface=512, nr_offsurface=2048,
            surface_pool_size=20000, log_every=50,
        )
        assert history[-1][1] < history[0][1] * 0.5, (
            f"smoke: loss did not decrease: {history[0][1]} -> {history[-1][1]}"
        )
        print("SMOKE OK: loss", history[0][1], "->", history[-1][1])
    else:
        exp = "sdf_from_mesh" + (f"_{args.exp_info}" if args.exp_info else "")
        params, cfg, history = train(
            mesh, nr_iters=args.nr_iters,
            checkpoint_path=args.checkpoint_path, experiment_name=exp,
        )

    if args.out_mesh:
        def sdf_fn(pts):
            return sdf_apply(params, pts, 9_999_999, cfg)[0]

        V, F = extract_mesh_from_sdf_fn(sdf_fn, args.mc_res, -0.5, 0.5)
        save_obj(args.out_mesh, Mesh(V.cpu().numpy(), F.cpu().numpy()))
        print(f"extracted mesh: {V.shape[0]} verts, {F.shape[0]} faces -> {args.out_mesh}")
    return params, cfg, history


if __name__ == "__main__":
    main()
