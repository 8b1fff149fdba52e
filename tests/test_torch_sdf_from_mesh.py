"""Port parity of the SDF-from-mesh slice on the CPU: the trainer
(``permuto_sdf_tpu_torch.train.train_sdf_from_mesh``), the numpy copies of
``mesh_io``, ``eval.chamfer`` and ``eval.mesh_cleaning``, ``AABB`` and the
losses, against the JAX package's functions on the same numpy inputs.

One ``train_step`` runs at the JAX smoke lattice (capacity 2^12, 8 levels)
on JAX's own draws, replayed from its key splits (``jax.random.split``,
then ``randint``/``uniform``): loss within 1e-5 relative, every updated
leaf within 1e-4 relative L2. The numpy copies must give the same numbers
(the same code on the same inputs; the float64 sums agree to 1e-12).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from permuto_sdf_tpu.datasets import mesh_io as jmio
from permuto_sdf_tpu.eval import chamfer as jch
from permuto_sdf_tpu.eval import mesh_cleaning as jmc
from permuto_sdf_tpu.models import fields as jf
from permuto_sdf_tpu.ops.ray_primitives import AABB as JAABB
from permuto_sdf_tpu.train import train_sdf_from_mesh as jt
from permuto_sdf_tpu.utils import losses as jl
from permuto_sdf_tpu_torch.convert import params_from_jax
from permuto_sdf_tpu_torch.datasets import mesh_io as tmio
from permuto_sdf_tpu_torch.eval import chamfer as tch
from permuto_sdf_tpu_torch.eval import mesh_cleaning as tmc
from permuto_sdf_tpu_torch.models import fields as tf
from permuto_sdf_tpu_torch.ops.ray_primitives import AABB
from permuto_sdf_tpu_torch.train import train_sdf_from_mesh as tt
from permuto_sdf_tpu_torch.utils import losses as tl

_SMOKE = dict(geom_feat_size_out=0, nr_iters_for_c2f=200, capacity=2 ** 12, nr_levels=8)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _named_leaves(tree, prefix=""):
    """{path: numpy leaf} of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _named_leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _named_leaves(v, f"{prefix}/{i}").items()}
    return {prefix: _np(tree)}


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def test_train_step_matches_jax():
    """One step at iteration 150 of the c2f ease-in (200): the window half
    open, 512 surface and 2048 off-surface points from a pool of 4000,
    JAX's draws replayed. Both step from one warmed Adam state (count 10,
    moments at each leaf's gradient scale): from a fresh state Adam's first
    step moves every entry by lr sign(g), so entries whose gradient is at
    float noise would flip and the comparison would measure that noise."""
    from permuto_sdf_tpu.train.optimizers import AdamState
    from permuto_sdf_tpu_torch.convert import opt_state_from_jax

    cfg_j, cfg_t = jf.SDFConfig(**_SMOKE), tf.SDFConfig(**_SMOKE)
    nr_surface, nr_off, pool, it = 512, 2048, 4000, 150
    pts, nrm = jmio.sample_points_on_mesh(jmio.make_uv_sphere(0.3), pool,
                                          np.random.default_rng(0))
    key = jax.random.PRNGKey(0)
    params_j = jax.tree_util.tree_map(np.asarray, jf.init_sdf(jax.random.fold_in(key, 1), cfg_j))
    sub = jax.random.split(key)[1]
    k_sel, k_off = jax.random.split(sub)
    idx = torch.from_numpy(np.array(jax.random.randint(k_sel, (nr_surface,), 0, pool)))
    u = torch.from_numpy(np.array(jax.random.uniform(k_off, (nr_off, 3))))
    lo, hi = torch.tensor(AABB().min_corner), torch.tensor(AABB().max_corner)
    gt_pts, gt_nrm = torch.from_numpy(pts), torch.from_numpy(nrm)

    # the warmed state, at the scale of the port's own gradients
    _, g = tt.loss_and_grads(params_from_jax(params_j, "cpu"), idx, u, gt_pts, gt_nrm, it,
                             cfg_t, lo, hi)
    # (the frozen per-level shifts get no gradient, so zero moments)
    rng = np.random.default_rng(1)
    g = jax.tree_util.tree_map(lambda p, x: np.zeros(p.shape, np.float32) if x is None
                               else _np(x), params_j, g, is_leaf=lambda x: x is None)
    rms = lambda x: float(np.sqrt(np.mean(x ** 2)))  # noqa: E731
    mu = jax.tree_util.tree_map(
        lambda x: (0.1 * rms(x) * rng.normal(size=x.shape)).astype(np.float32), g)
    nu = jax.tree_util.tree_map(
        lambda x: (rms(x) ** 2 * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32), g)
    state_j = AdamState(mu=mu, nu=nu, count=np.array([10], np.int32))

    opt_j = jt.make_optimizer(1e-3)
    aabb = JAABB()
    new_j, _, loss_j = jt.train_step(
        params_j, state_j, sub, jnp.asarray(pts), jnp.asarray(nrm), it, cfg_j,
        nr_surface, nr_off, opt_j, jnp.asarray(aabb.min_corner), jnp.asarray(aabb.max_corner))

    params_t = params_from_jax(params_j, "cpu")
    opt_t = tt.make_optimizer()
    new_t, state_t, loss_t = tt.train_step(
        params_t, opt_state_from_jax(state_j, "cpu"), idx.to(torch.int64), u, gt_pts, gt_nrm,
        it, cfg_t, opt_t, lo, hi)
    assert int(state_t.count[0]) == 11
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    before, after, want = (_named_leaves(t) for t in (params_j, new_t, new_j))
    assert after.keys() == want.keys() and len(want) == 10
    for name, w in want.items():
        frozen = name == "/encoding/shift_per_level"
        assert np.array_equal(after[name], before[name]) == frozen, name
        rel = np.linalg.norm(after[name] - w) / np.linalg.norm(w)
        assert rel <= 1e-4, (name, rel)


def test_train_loss_falls():
    cfg = tf.SDFConfig(geom_feat_size_out=0, nr_iters_for_c2f=50, capacity=2 ** 10,
                       nr_levels=4)
    params, cfg, hist = tt.train(tmio.make_uv_sphere(radius=0.3), nr_iters=41, cfg=cfg,
                                 nr_surface=256, nr_offsurface=512, surface_pool_size=5000,
                                 log_every=20, device="cpu")
    losses = [v for _, v in hist]
    assert [i for i, _ in hist] == [0, 20, 40]
    assert all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0]
    assert params["mlp_sdf"][-1]["w"].shape == (32, 1)  # geom_feat_size_out=0


def test_train_writes_checkpoints(tmp_path):
    cfg = tf.SDFConfig(geom_feat_size_out=0, capacity=2 ** 10, nr_levels=2)
    params, _, _ = tt.train(tmio.make_uv_sphere(0.3, 8, 16), nr_iters=3, cfg=cfg,
                            nr_surface=16, nr_offsurface=32, surface_pool_size=100,
                            checkpoint_path=str(tmp_path), save_every=2, device="cpu")
    from permuto_sdf_tpu.train import checkpoint as jckpt

    for it in (2, 3):
        d = os.path.join(tmp_path, "sdf_from_mesh", str(it), "models")
        assert os.path.isfile(os.path.join(d, "sdf_model.npz"))
    back = _named_leaves(jckpt.load_model(os.path.join(tmp_path, "sdf_from_mesh", "3", "models"),
                                          "sdf_model"))
    mine = _named_leaves(params)
    assert back.keys() == mine.keys()
    for name, leaf in mine.items():
        np.testing.assert_array_equal(back[name], leaf)


def test_converted_sdf_without_geometry_features_matches_jax():
    """``params_from_jax`` carries an ``init_sdf`` tree with
    ``geom_feat_size_out=0`` (the trainer's model) into the port."""
    cfg_j, cfg_t = jf.SDFConfig(**_SMOKE), tf.SDFConfig(**_SMOKE)
    pj = jax.tree_util.tree_map(np.asarray, jf.init_sdf(jax.random.PRNGKey(2), cfg_j))
    pt = params_from_jax(pj, "cpu")
    assert len(pt["mlp_sdf"]) == len(pj["mlp_sdf"]) and pt["mlp_sdf"][-1]["w"].shape[1] == 1
    pts = np.random.default_rng(0).uniform(-0.5, 0.5, (500, 3)).astype(np.float32)
    s_j, g_j = jf.sdf_apply(pj, jnp.asarray(pts), 9_999_999, cfg_j)
    s_t, g_t = tf.sdf_apply(pt, torch.from_numpy(pts), 9_999_999, cfg_t)
    assert g_j is None and g_t is None
    np.testing.assert_allclose(_np(s_t), np.asarray(s_j), atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# mesh_io, AABB, losses
# ---------------------------------------------------------------------------

def test_mesh_io_matches_jax(tmp_path):
    for make in ("make_uv_sphere", "make_torus"):
        a, b = getattr(jmio, make)(), getattr(tmio, make)()
        for x, y in ((a.V, b.V), (a.F, b.F), (a.NV, b.NV)):
            np.testing.assert_array_equal(x, y)
    m = jmio.make_torus(n_u=12, n_v=6)
    m.V = m.V * np.float32([1.5, 1.0, 0.7]) + np.float32([0.2, -0.1, 0.05])
    np.testing.assert_array_equal(tmio.compute_vertex_normals(m.V, m.F),
                                  jmio.compute_vertex_normals(m.V, m.F))
    nj = jmio.normalize_mesh_to_unit_sphere(jmio.Mesh(m.V, m.F))
    nt = tmio.normalize_mesh_to_unit_sphere(tmio.Mesh(m.V, m.F))
    np.testing.assert_array_equal(nt.V, nj.V)
    pj = jmio.sample_points_on_mesh(jmio.Mesh(m.V, m.F), 3000, np.random.default_rng(4))
    pt = tmio.sample_points_on_mesh(tmio.Mesh(m.V, m.F), 3000, np.random.default_rng(4))
    for x, y in zip(pt, pj):
        np.testing.assert_array_equal(x, y)
    path = str(tmp_path / "m.obj")
    tmio.save_obj(path, tmio.Mesh(m.V, m.F, m.NV))
    back_j, back_t = jmio.load_obj(path), tmio.load_obj(path)
    for x, y in ((back_t.V, back_j.V), (back_t.F, back_j.F), (back_t.NV, back_j.NV)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(back_t.F, m.F)


def test_aabb_matches_jax():
    rng = np.random.default_rng(1)
    o = rng.normal(size=(400, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.2
    d = (rng.uniform(-0.3, 0.3, (400, 3)).astype(np.float32) - o) * np.float32(1.5)
    d[:5, 0] = 0.0  # rays parallel to a slab
    for kw in (dict(), dict(scaling=0.6, translation=(0.1, -0.2, 0.05))):
        bj = JAABB.from_scaling_and_translation(**kw) if kw else JAABB()
        bt = AABB.from_scaling_and_translation(**kw) if kw else AABB()
        assert bt.min_corner == bj.min_corner and bt.max_corner == bj.max_corner
        assert bt.radius == bj.radius and bt.center == bj.center
        got = bt.ray_intersection(torch.from_numpy(o), torch.from_numpy(d))
        want = bj.ray_intersection(jnp.asarray(o), jnp.asarray(d))
        assert 50 < np.asarray(want[4]).sum() < 400
        for x, y in zip(got, want):
            np.testing.assert_allclose(_np(x), np.asarray(y), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(
            _np(bt.check_point_inside_primitive(torch.from_numpy(o * 0.4))),
            np.asarray(bj.check_point_inside_primitive(jnp.asarray(o * 0.4))))
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (100, 3)))
    np.testing.assert_array_equal(_np(AABB().rand_points_inside(100, u=u)),
                                  np.asarray(JAABB().rand_points_inside(key, 100)))


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    s_sdf, s_g, o_sdf, o_g, nrm = f(300, 1), f(300, 3), f(700, 1) * 0.02, f(700, 3), f(300, 3)
    got = tl.sdf_loss(*map(torch.from_numpy, (s_sdf, s_g, o_sdf, o_g, nrm)))
    want = jl.sdf_loss(*map(jnp.asarray, (s_sdf, s_g, o_sdf, o_g, nrm)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    pts, sdf, g = f(500, 3) * 0.3, f(500, 1) * 0.1, f(500, 3)
    spheres = [(0.2, (0.0, 0.1, 0.0)), (0.15, (0.2, -0.1, 0.05))]
    for x, y in zip(tl.sdf_loss_spheres(*map(torch.from_numpy, (pts, sdf, g)), spheres, 1.5),
                    jl.sdf_loss_spheres(*map(jnp.asarray, (pts, sdf, g)), spheres, 1.5)):
        np.testing.assert_allclose(float(x), float(y), rtol=1e-6)
    a, b, m = f(200, 3), f(200, 3), (f(200, 1) > 0).astype(np.float32)
    np.testing.assert_allclose(float(tl.rgb_loss(*map(torch.from_numpy, (a, b, m)))),
                               float(jl.rgb_loss(*map(jnp.asarray, (a, b, m)))), rtol=1e-6)
    for grads in (f(300, 3), f(300, 2, 3)):
        np.testing.assert_allclose(float(tl.eikonal_loss(torch.from_numpy(grads))),
                                   float(jl.eikonal_loss(jnp.asarray(grads))), rtol=1e-6)


# ---------------------------------------------------------------------------
# Chamfer and mesh cleaning (numpy/scipy on the host in both packages)
# ---------------------------------------------------------------------------

def test_chamfer_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2000, 3))
    b = a[:1500] + rng.normal(scale=0.01, size=(1500, 3))
    for kw in (dict(), dict(downsample=0.05, max_dist=0.02)):
        np.testing.assert_allclose(tch.chamfer_distance(a, b, **kw),
                                   jch.chamfer_distance(a, b, **kw), rtol=1e-12)
    s = jmio.make_uv_sphere(0.3, 12, 24)
    t = jmio.make_torus(n_u=16, n_v=8)
    np.testing.assert_array_equal(tch.sample_mesh_surface(s.V, s.F, 500, 3),
                                  jch.sample_mesh_surface(s.V, s.F, 500, 3))
    np.testing.assert_array_equal(tch.dtueval_sample_mesh(t.V * 100, t.F, 2.0),
                                  jch.dtueval_sample_mesh(t.V * 100, t.F, 2.0))
    np.testing.assert_array_equal(tch.radius_downsample(a, 0.3, seed=1),
                                  jch.radius_downsample(a, 0.3, seed=1))
    gt = jch.sample_mesh_surface(s.V * 100, s.F, 3000, 7)
    np.testing.assert_allclose(tch.dtu_chamfer(s.V * 101, s.F, gt, 1.0, 20.0),
                               jch.dtu_chamfer(s.V * 101, s.F, gt, 1.0, 20.0), rtol=1e-12)
    np.testing.assert_allclose(tch.point_mesh_chamfer(t.V, t.F, s.V, s.F, 4000),
                               jch.point_mesh_chamfer(t.V, t.F, s.V, s.F, 4000), rtol=1e-12)


def test_mesh_cleaning_matches_jax():
    rng = np.random.default_rng(6)
    mask = np.zeros((40, 50), bool)
    mask[10:25, 15:30] = True
    np.testing.assert_array_equal(tmc.dilate_mask(mask, 7), jmc.dilate_mask(mask, 7))
    s = jmio.make_uv_sphere(0.3, 10, 20)
    V = np.concatenate([s.V, s.V[:30] * 0.2 + 0.4]).astype(np.float32)
    F = np.concatenate([s.F, np.array([[len(s.V), len(s.V) + 1, len(s.V) + 2]])])
    K = np.array([[60.0, 0, 25], [0, 60.0, 20], [0, 0, 1]])
    mats = np.stack([K @ np.hstack([np.eye(3), np.array([[0.0], [0.0], [2.0 + k]])])
                     for k in range(2)])
    masks = rng.uniform(size=(2, 40, 50)) < 0.9
    np.testing.assert_array_equal(tmc.clean_points_by_mask(V, mats, masks, 5),
                                  jmc.clean_points_by_mask(V, mats, masks, 5))
    for x, y in zip(tmc.largest_connected_component(V, F), jmc.largest_connected_component(V, F)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tmc.clean_mesh(V, F, mats, masks, 5), jmc.clean_mesh(V, F, mats, masks, 5)):
        np.testing.assert_array_equal(x, y)
