"""Port parity of sampling without the occupancy grid and of the NeRF
trainer on the CPU: ``compute_samples_fg`` (kernel C2's plain version),
the flagship's grid-free eval render and training step, and
``train/train_nerf.py`` (``nerf_hash_density``, the density refresh with
kernel I2's plain version, ``_render_rays``, one step with its Adam
update, ``render_image``, ``train`` and ``_save``), each against the JAX
package on the same inputs at a small config (capacity 2^10, 4 levels, 32
rays, 16 fg and 4 bg samples, a 16^3 grid).

The draws come from the JAX step's key splits, replayed with
``jax.random``. The JAX references run eagerly (``jax.disable_jit``:
under ``jit`` XLA contracts ``o + z d`` into a fused multiply-add) and are
built once per test session by the process that builds the other step
fixtures (``tests/torch_shared_steps.py``), so their eager primitives
compile once.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.ops import ray_sampler as jrs
from permuto_sdf_tpu.ops.ray_primitives import Sphere as JSphere
from permuto_sdf_tpu.datasets import tensor_reel as jreel
from permuto_sdf_tpu.models import fields as jfields
from permuto_sdf_tpu.train import checkpoint as jckpt
from permuto_sdf_tpu.train import train_nerf as jn
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.convert import opt_state_from_jax, params_from_jax
from permuto_sdf_tpu_torch.models import fields as tfields
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops import ray_sampler as trs
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
from permuto_sdf_tpu_torch.train import train_nerf as tn
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt
from test_torch_train import (
    _STEP, _STEP_ITER, _assert_tree_close, _leaves, _level_rtol, jax_numpy, jax_step_draws,
    make_reels,
)
from test_torch_render_image import _K, _TF, _plant_plane
from torch_shared_steps import nerf_steps

_NERF = dict(capacity=2 ** 10, nr_levels=4, nr_rays=32, max_nr_samples_per_ray=16,
             nr_samples_bg=4, grid_nr_voxels_per_dim=16, grid_nr_random_samples=512)
_NERF_ITER = 50
_GRIDFREE = dict(_STEP, use_occupancy_grid=False)


def jax_nerf_draws(key, cfg, reel_j) -> tn.NerfDraws:
    """The draws of JAX's NeRF ``compute_loss_and_grads(key)``, replayed
    from its key splits (train_nerf.py:185 and :121, tensor_reel.py:122,
    ray_sampler.py:46 or occupancy_grid.py:268, ray_sampler.py:72)."""
    R = cfg.nr_rays
    k_rays, k_render = jax.random.split(key)
    k_img, k_pix = jax.random.split(k_rays)
    k_fg, k_bg = jax.random.split(k_render)
    t = lambda a, dtype=torch.float32: torch.from_numpy(np.array(a)).to(dtype)  # noqa: E731
    return tn.NerfDraws(
        ray_indices=(t(jax.random.randint(k_img, (R,), 0, reel_j.nr_images), torch.int64),
                     t(jax.random.randint(k_pix, (R,), 0, reel_j.height * reel_j.width),
                       torch.int64)),
        fg_start=t(jax.random.uniform(k_fg, (R, 1))),
        bg_rand=t(jax.random.uniform(k_bg, (R, cfg.nr_samples_bg))))


def _eval_rays(reel_j):
    """32 rays of view 1 (every 32nd pixel): the step's ray count, so the
    eager JAX references reuse the step's compiled primitives."""
    o, d = jreel.rays_from_frame(reel_j.K[1], reel_j.tf_world_cam[1], 32, 32)
    return o[::32], d[::32]


def _nerf_params(cfg_j, nr_cams):
    pj = jax_numpy(jn.init_params(jax.random.PRNGKey(3), cfg_j, nr_cams))
    rng = np.random.default_rng(0)
    # colour calibration away from identity, so its gradient is not trivial
    pj["colorcal"] = {k: rng.normal(0, 0.05, v.shape).astype(np.float32)
                      for k, v in pj["colorcal"].items()}
    return pj, rng.uniform(size=16 ** 3) < 0.6


def _jgrid(occ, values=None):
    return jog.OccupancyGridState(values=jnp.asarray(values if values is not None
                                                     else np.zeros(occ.size, np.float32)),
                                  occupancy=jnp.asarray(occ))


def _tgrid(occ, values=None):
    return tog.OccupancyGridState(
        values=torch.from_numpy(np.array(values if values is not None
                                          else np.zeros(occ.size, np.float32))),
        occupancy=torch.from_numpy(np.array(occ)))


def _nerf_steps():
    """Every eager JAX result the NeRF and grid-free tests read (numpy)."""
    reel_j, _ = make_reels()
    out = {}
    with jax.disable_jit():
        for grid_on in (True, False):
            cfg_j = jn.NerfTrainConfig(**_NERF, use_occupancy_grid=grid_on)
            pj, occ = _nerf_params(cfg_j, reel_j.nr_images)
            grid = _jgrid(occ) if grid_on else None
            p = jax.tree_util.tree_map(jnp.asarray, pj)
            key = jax.random.PRNGKey(11)
            loss, loss_rgb, grads = jn.compute_loss_and_grads(p, grid, reel_j, key, _NERF_ITER,
                                                              cfg_j)
            opt = jn.make_optimizer(cfg_j)
            new_p, new_st = opt.update(grads, opt.init(p), p)
            o, d = _eval_rays(reel_j)
            rgb, ws = jn.render_rays_eval(p, grid, o, d, _NERF_ITER, cfg_j)
            img = jn.render_image(p, grid, reel_j, 2, _NERF_ITER, cfg_j, chunk=_NERF["nr_rays"])
            out[grid_on] = dict(pj=pj, occ=occ, loss=float(loss), loss_rgb=float(loss_rgb),
                                grads=jax_numpy(grads), new_params=jax_numpy(new_p),
                                new_state=jax_numpy(new_st), eval=jax_numpy((rgb, ws)),
                                image=jax_numpy(img))
        cfg_j = jn.NerfTrainConfig(**_NERF)
        pj, occ = out[True]["pj"], out[True]["occ"]
        p = jax.tree_util.tree_map(jnp.asarray, pj)
        values = np.random.default_rng(1).uniform(0, 4e-3, occ.size).astype(np.float32)
        refreshed = jn.occupancy_update(p, _jgrid(occ, values), jax.random.PRNGKey(5), 16, cfg_j)
        pts = np.random.default_rng(2).uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
        density = jfields.nerf_hash_density(p["model"], jnp.asarray(pts), _NERF_ITER,
                                            cfg_j.fg_model)
        out["refresh"] = dict(values=values, grid=jax_numpy(refreshed), pts=pts,
                              density=np.asarray(density))
        # the flagship's grid-free step on JAX's own samples, its sampling
        # stage and its eval render
        cfg_g = jt.PermutoSDFTrainConfig(**_GRIDFREE)
        pg = jax_numpy(jt.init_params(jax.random.PRNGKey(3), cfg_g, reel_j.nr_images))
        pgj = jax.tree_util.tree_map(jnp.asarray, pg)
        key = jax.random.PRNGKey(12)
        loss_g, aux_g, grads_g = jt.compute_loss_and_grads(pgj, None, reel_j, key, _STEP_ITER,
                                                           cfg_g)
        origins, dirs, _, _, img_idx = jreel.random_rays_from_reel(
            reel_j, jax.random.split(key, 4)[0], cfg_g.nr_rays, apply_mask=False)
        it_anneal = _STEP_ITER - cfg_g.nr_iter_sphere_fit
        samples = jt.run_net(pgj, None, jax.random.split(key, 4)[1], origins, dirs, img_idx,
                             it_anneal, 0.0, 0.3, cfg_g, jitter=True)[4]
        # the eval render on the planted plane (a surface, so the normals are
        # well defined), 32 rays of its 16x12 view (the step's shapes)
        pe = _plant_plane(jax_numpy(jt.init_params(jax.random.PRNGKey(0), cfg_g, 2)))
        o, d = (a[::6] for a in jreel.rays_from_frame(_K, _TF, 16, 12))
        ev = jt.render_rays_eval(jax.tree_util.tree_map(jnp.asarray, pe), None, o, d, 20000, 1.0,
                                 0.8, cfg_g)
        out["gridfree"] = dict(pj=pg, loss=float(loss_g), aux=jax_numpy(aux_g),
                               grads=jax_numpy(grads_g), samples=jax_numpy(samples),
                               rays=jax_numpy((origins, dirs)), eval=jax_numpy(ev),
                               eval_pj=pe, eval_rays=jax_numpy((o, d)))
    return out


@pytest.fixture(scope="module")
def steps(request, tmp_path_factory):
    return nerf_steps(request, tmp_path_factory)


@pytest.fixture(scope="module")
def reels():
    return make_reels()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_rays_close(got, want, grid_on):
    """Per ray (the last axis): to 1e-5 of JAX's. Through the grid the
    samples sit a rounding apart (kernel C's cumulative occupied length is
    count x seg_len, JAX's an f32 cumsum; ROADMAP Queue 3), which the finest
    level's lattice (coordinates ~1e4) turns into ~1e-3 relative changes of
    its features: there all but 1% of the rays to 1e-5, every ray to 1e-3.
    Without the grid the samples are JAX's exactly."""
    err = np.max([np.abs(a.numpy() - np.asarray(b)).reshape(-1, a.shape[-1]).max(axis=1)
                  for a, b in zip(got, want)], axis=0)
    if grid_on:
        assert (err > 1e-5).sum() <= 0.01 * err.size and err.max() <= 1e-3, err.max()
    else:
        assert err.max() <= 1e-5, err.max()


# ---------------------------------------------------------------------------
# Sampling without the grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_dist,S", [(1e-4, 64), (0.05, 16), (0.3, 8)])
@pytest.mark.parametrize("jitter", [False, True])
def test_compute_samples_fg_matches_jax(min_dist, S, jitter):
    """Kernel C2's plain version: z, dt, mask and ray_fixed_dt exactly
    (the same float operations), on rays that miss the bound (no sample),
    rays whose count falls to <= 2 and is discarded (min_dist 0.3) and
    rays capped at S (min_dist 1e-4)."""
    rng = np.random.default_rng(S)
    R = 300
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.2
    d = rng.uniform(-0.6, 0.6, (R, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    _, te, _, tx, _ = JSphere().ray_intersection(jnp.asarray(o), jnp.asarray(d))
    key = jax.random.PRNGKey(1)
    with jax.disable_jit():
        want = jrs.compute_samples_fg(jnp.asarray(o), jnp.asarray(d), te, tx, min_dist, S,
                                      key=key, jitter=jitter)
    start = torch.from_numpy(np.array(jax.random.uniform(key, (R, 1)))) if jitter else None
    to = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = trs.compute_samples_fg(to(o), to(d), to(te), to(tx), min_dist, S, start=start)
    for f in ("z", "dt", "mask", "ray_fixed_dt"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    counts = np.asarray(want.mask).sum(1)
    assert (counts == 0).sum() > 5 and (counts > 0).sum() > 5
    if min_dist == 1e-4:
        assert (counts == S).sum() == (counts > 0).sum()


def test_gridfree_sampling_stage_matches_jax(steps, reels):
    """The flagship's jittered sampling stage without the grid (C2, then
    two importance rounds) on the replayed draws places JAX's samples: the
    masks are equal and z agrees to 1e-4 on all but 2% of the valid
    samples (the importance stage inverts a CDF a rounding apart)."""
    g = steps["gridfree"]
    cfg_t = tt.PermutoSDFTrainConfig(**_GRIDFREE)
    draws = jax_step_draws(jax.random.PRNGKey(12), jt.PermutoSDFTrainConfig(**_GRIDFREE),
                           reels[0])
    o, d = (torch.from_numpy(np.array(a)) for a in g["rays"])
    got = tt._create_fg_samples(params_from_jax(g["pj"], "cpu"), None, o, d,
                                _STEP_ITER - cfg_t.nr_iter_sphere_fit, cfg_t, draws)[0]
    mask = np.asarray(g["samples"].mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    assert mask.sum() > 100
    far = (np.abs(got.z.numpy() - np.asarray(g["samples"].z)) > 1e-4) & mask
    assert far.sum() <= 0.02 * mask.sum(), far.sum()


def test_gridfree_step_matches_jax(steps, reels):
    """One flagship step with ``use_occupancy_grid=False`` on JAX's own
    samples: the loss (no offsurface term) and its rgb, eikonal and
    curvature terms to 1e-4 relative, every leaf's gradient as in
    ``test_torch_train.test_gradients_match_jax``."""
    g = steps["gridfree"]
    cfg_t = tt.PermutoSDFTrainConfig(**_GRIDFREE)
    cfg_j = jt.PermutoSDFTrainConfig(**_GRIDFREE)
    draws = jax_step_draws(jax.random.PRNGKey(12), cfg_j, reels[0])
    fields = ("origins", "dirs", "z", "dt", "mask", "ray_fixed_dt")
    fg = RaySamples(*(torch.from_numpy(np.array(getattr(g["samples"], f))) for f in fields))
    loss, aux, grads = tt.compute_loss_and_grads(params_from_jax(g["pj"], "cpu"), None, reels[1],
                                                 draws, _STEP_ITER, cfg_t, fg_samples=fg)
    assert float(loss) == pytest.approx(g["loss"], rel=1e-4)
    for k in ("loss_rgb", "loss_eikonal", "loss_curvature"):
        assert float(aux[k]) == pytest.approx(float(g["aux"][k]), rel=1e-4, abs=1e-7), k
    for group in ("sdf", "rgb", "bg", "colorcal"):
        level_rtol = None
        if group != "colorcal":
            spec = getattr(cfg_j, {"sdf": "sdf_model", "rgb": "rgb_model",
                                   "bg": "bg_model"}[group]).encoding
            level_rtol = _level_rtol(2e-3, spec, g["pj"][group]["encoding"]["shift_per_level"])
        _assert_tree_close(grads[group], g["grads"][group], 2e-3, group, level_rtol)


def test_gridfree_render_rays_eval_matches_jax(steps):
    """The flagship's exact eval render without the grid (C2 without
    jitter, the importance stage, the fields, NeuS and the background) of
    32 rays of the planted plane's view: rgb, normals and weights_sum to
    1e-4, as ``test_torch_render_image.test_render_image_matches_jax`` holds
    the render through the grid."""
    g = steps["gridfree"]
    cfg_t = tt.PermutoSDFTrainConfig(**_GRIDFREE)
    o, d = (torch.from_numpy(np.array(a)) for a in g["eval_rays"])
    got = tt.render_rays_eval(params_from_jax(g["eval_pj"], "cpu"), None, o, d, 20000, 1.0, 0.8,
                              cfg_t)
    assert 0.1 < (np.asarray(g["eval"][2]) > 0.5).mean() < 0.9  # the plane crosses the view
    for a, b in zip(got, g["eval"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_gridfree_train_and_render(tiny_reel_t):
    """``train`` with ``use_occupancy_grid=False`` keeps no grid and runs
    (finite losses, the sphere init falls); ``render_image`` renders
    without one."""
    cfg = tt.PermutoSDFTrainConfig(**dict(_STEP, use_occupancy_grid=False,
                                          nr_iter_sphere_fit=10, warmup_iters=10,
                                          forced_variance_finish_iter=20))
    params, grid, hist = tt.train(tiny_reel_t, cfg, nr_iters=16, log_every=2, device="cpu")
    assert grid is None and all(np.isfinite(h[1]) for h in hist)
    K = tiny_reel_t.K[0].numpy()
    rgb, nrm, alpha = tt.render_image(params, None, K, tiny_reel_t.tf_world_cam[0].numpy(), 8, 8,
                                      6, cfg, device="cpu")
    assert rgb.shape == (8, 8, 3) and torch.isfinite(rgb).all()


# ---------------------------------------------------------------------------
# The NeRF trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_reel_t():
    from permuto_sdf_tpu_torch.datasets import synthetic as tsyn

    return tsyn.make_synthetic_reel(nr_views=3, width=32, height=32, device="cpu")


def test_nerf_config_matches_jax():
    """The same fields with the same defaults, and the same derived model
    and grid configs."""
    jf = {f.name: f.default for f in dataclasses.fields(jn.NerfTrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tn.NerfTrainConfig)}
    assert tf == jf
    for prop in ("fg_model", "bg_model"):
        j, t = getattr(jn.NerfTrainConfig(), prop), getattr(tn.NerfTrainConfig(), prop)
        for f in ("in_channels", "nr_iters_for_c2f", "capacity", "nr_levels", "nr_feat_for_rgb",
                  "sh_degree"):
            assert getattr(t, f) == getattr(j, f), (prop, f)
    assert tn.NerfTrainConfig().grid == tog.OccupancyGridConfig(64)
    assert (tn.BOUND.radius, tn.BOUND.center) == (jn.BOUND.radius, jn.BOUND.center)


def test_nerf_hash_density_matches_jax(steps):
    r = steps["refresh"]
    cfg = tn.NerfTrainConfig(**_NERF)
    pt = params_from_jax(steps[True]["pj"], "cpu")
    got = tfields.nerf_hash_density(pt["model"], torch.from_numpy(r["pts"]), _NERF_ITER,
                                    cfg.fg_model)
    assert got.shape == (512, 1)
    np.testing.assert_allclose(got.numpy(), r["density"], rtol=1e-5, atol=1e-7)


def test_density_update_matches_jax():
    """Kernel I2's plain version against ``update_with_density_random_sample``
    on the stratified probes of one update: values and occupancy exactly."""
    cfg_j, cfg_t = jog.OccupancyGridConfig(16), tog.OccupancyGridConfig(16)
    rng = np.random.default_rng(3)
    _, lin = tog.compute_stratified_sample_of_grid_points(cfg_t, 1500, 7, None, "cpu")
    density = rng.exponential(2e-3, (1500, 1)).astype(np.float32)
    values = rng.uniform(0, 4e-3, 16 ** 3).astype(np.float32)
    occ = values > 1e-3
    want = jog.update_with_density_random_sample(cfg_j, _jgrid(occ, values),
                                                 jnp.asarray(lin.numpy()), jnp.asarray(density))
    grid = _tgrid(occ, values)
    got = tog.update_with_density_random_sample(cfg_t, grid, lin, torch.from_numpy(density))
    assert got is grid  # in place
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.occupancy.numpy(), np.asarray(want.occupancy))
    flips = np.asarray(want.occupancy) != occ
    assert (flips & occ).sum() > 10 and (flips & ~occ).sum() > 10


def test_occupancy_update_matches_jax(steps):
    """``occupancy_update`` at iteration 16 (update 2) on the replayed
    jitter: the values within 1e-5 relative of JAX's (the density, an MLP's
    sum in another order); the occupancy equal but where the value lies
    within that of the threshold."""
    r = steps["refresh"]
    cfg = tn.NerfTrainConfig(**_NERF)
    jitter = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(5), (cfg.grid_nr_random_samples, 3), minval=-0.5, maxval=0.5)))
    grid = _tgrid(steps[True]["occ"], r["values"])
    got = tn.occupancy_update(params_from_jax(steps[True]["pj"], "cpu"), grid, jitter, 16, cfg)
    want_v, want_o = np.asarray(r["grid"].values), np.asarray(r["grid"].occupancy)
    np.testing.assert_allclose(got.values.numpy(), want_v, rtol=1e-5, atol=1e-9)
    near = np.abs(want_v - cfg.grid_occupancy_thresh) <= 1e-5 * cfg.grid_occupancy_thresh
    np.testing.assert_array_equal(got.occupancy.numpy()[~near], want_o[~near])
    assert (want_v != r["values"]).sum() == cfg.grid_nr_random_samples


@pytest.mark.parametrize("grid_on", [True, False])
def test_nerf_render_rays_eval_matches_jax(steps, grid_on):
    """``render_rays_eval`` (``_render_rays`` without jitter or colorcal)
    through the grid (kernel C, D in NeRF mode, the background) and
    without it (kernel C2): rgb and weights_sum per ray as
    :func:`_assert_rays_close`."""
    s = steps[grid_on]
    cfg = tn.NerfTrainConfig(**_NERF, use_occupancy_grid=grid_on)
    o, d = (torch.from_numpy(np.array(a)) for a in _eval_rays(make_reels()[0]))
    grid = _tgrid(s["occ"]) if grid_on else None
    got = tn.render_rays_eval(params_from_jax(s["pj"], "cpu"), grid, o, d, _NERF_ITER, cfg)
    _assert_rays_close(got, s["eval"], grid_on)
    assert float(np.asarray(s["eval"][1]).max()) > 0.1


@pytest.mark.parametrize("grid_on", [True, False])
def test_nerf_step_matches_jax(steps, reels, grid_on):
    """One NeRF step (the whole path: the fg sampler with its jitter, both
    fields with colorcal, D in NeRF mode, the background) on the replayed
    draws: the loss to 1e-5 relative, every leaf's gradient to 1e-3
    relative L2 (the finest level's barycentric weights, ROADMAP Queue 3),
    and the Adam update (one step moves an entry by ~lr sign(g): equal
    where the gradient is clearly away from zero on both sides; the
    moments carry across)."""
    s = steps[grid_on]
    cfg = tn.NerfTrainConfig(**_NERF, use_occupancy_grid=grid_on)
    draws = jax_nerf_draws(jax.random.PRNGKey(11), jn.NerfTrainConfig(**_NERF), reels[0])
    pt = params_from_jax(s["pj"], "cpu")
    grid = _tgrid(s["occ"]) if grid_on else None
    loss, loss_rgb, grads = tn.compute_loss_and_grads(pt, grid, reels[1], draws, _NERF_ITER, cfg)
    assert float(loss) == pytest.approx(s["loss"], rel=1e-5)
    assert float(loss_rgb) == pytest.approx(s["loss_rgb"], rel=1e-5)
    g_t, g_j = _leaves(grads), _leaves(s["grads"])
    assert g_t.keys() == g_j.keys()
    for k, want in g_j.items():
        got = np.zeros_like(want) if g_t[k] is None else g_t[k]
        assert _rel_l2(got, want) <= 1e-3 or not np.abs(want).max() > 0, k
    opt = tn.make_optimizer(cfg)
    new_p, new_st = opt.update(grads, opt.init(pt), pt, cfg.lr)
    p_t, p_j = _leaves(new_p), _leaves(s["new_params"])
    for k, gj in g_j.items():
        gt = np.zeros_like(gj) if g_t[k] is None else g_t[k]
        clear = (np.abs(gj) > 1e-2 * np.abs(gj).max()) & (np.sign(gt) == np.sign(gj))
        np.testing.assert_allclose(p_t[k][clear], p_j[k][clear], atol=1e-9, rtol=1e-6,
                                   err_msg=k)
    st_j = opt_state_from_jax(s["new_state"], "cpu")
    assert int(new_st.count[0]) == int(st_j.count[0]) == 1
    mu_t, mu_j = _leaves(new_st.mu), _leaves(st_j.mu)
    for k in mu_j:
        assert _rel_l2(mu_t[k], mu_j[k]) <= 1e-3 or not np.abs(mu_j[k]).max() > 0, k


def test_nerf_render_image_matches_jax(steps, reels):
    """``render_image`` of view 2 (chunk 32) through the grid:
    rgb and alpha per pixel as :func:`_assert_rays_close`; the port's are
    tensors on the device."""
    s = steps[True]
    cfg = tn.NerfTrainConfig(**_NERF)
    rgb, alpha = tn.render_image(params_from_jax(s["pj"], "cpu"), _tgrid(s["occ"]), reels[1], 2,
                                 _NERF_ITER, cfg, chunk=_NERF["nr_rays"], device="cpu")
    assert rgb.shape == (32, 32, 3) and alpha.shape == (32, 32, 1)
    _assert_rays_close((rgb.reshape(-1, 3), alpha.reshape(-1, 1)),
                       (s["image"][0].reshape(-1, 3), s["image"][1].reshape(-1, 1)), True)


def test_nerf_train_loss_falls_and_saves(tiny_reel_t, tmp_path):
    """A 24-iteration ``train`` (3 grid refreshes) on the CPU: finite
    losses that fall, a refreshed grid, and a checkpoint in the JAX
    layout (``nerf_hash_model``, ``nerf_hash_model_bg``, ``colorcal_model``,
    ``occupancy_grid``) that the JAX loader reads, leaf for leaf."""
    cfg = tn.NerfTrainConfig(**dict(_NERF, lr=1e-2))
    params, grid, hist = tn.train(tiny_reel_t, cfg, nr_iters=24, log_every=4, device="cpu",
                                  checkpoint_path=str(tmp_path), experiment_name="nerf")
    assert all(np.isfinite(h[1]) for h in hist)
    assert hist[-1][1] < hist[0][1]
    assert float(grid.occupancy.float().mean()) < 1.0  # the refreshes emptied space
    d = os.path.join(str(tmp_path), "nerf", "24", "models")
    assert sorted(os.listdir(d)) == ["colorcal_model.npz", "nerf_hash_model.npz",
                                     "nerf_hash_model_bg.npz", "occupancy_grid.npz"]
    for name, key in (("nerf_hash_model", "model"), ("nerf_hash_model_bg", "model_bg"),
                      ("colorcal_model", "colorcal")):
        saved, want = _leaves(jckpt.load_model(d, name)), _leaves(params[key])
        assert saved.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(saved[k], want[k], err_msg=k)
    g = jckpt.load_model(d, "occupancy_grid")
    assert isinstance(g, jog.OccupancyGridState)
    np.testing.assert_array_equal(np.asarray(g.occupancy), grid.occupancy.numpy())


def test_nerf_entry_points_need_cuda_and_main_flags_raise(tiny_reel_t, monkeypatch, tmp_path):
    """device=None means the GPU (``train``, ``render_image`` and ``main``
    raise without one); ``main``'s ``--config`` and ``--set`` reach the
    config ``train`` gets, also under ``--smoke``, and an unknown key
    raises ``KeyError``."""
    cfg = tn.NerfTrainConfig(**_NERF)
    calls = []

    def record(reel, cfg_, **kw):
        calls.append(cfg_)
        return None, None, [(0, 1.0), (299, 0.5)]

    path = str(tmp_path / "n.cfg")
    with open(path, "w") as f:
        f.write("{\n  grid_decay: 0.5, // a comment\n  nr_levels: 6,\n}\n")
    with monkeypatch.context() as m:
        m.setattr(tn, "train", record)
        tn.main(["--smoke", "--config", path, "--set", "lr=0.25", "--set", "with_mask=true"],
                device="cpu")
        assert (calls[0].grid_decay, calls[0].nr_levels, calls[0].lr) == (0.5, 6, 0.25)
        assert calls[0].with_mask is True and calls[0].nr_rays == 256  # the smoke config
        with pytest.raises(KeyError, match="unknown config key 'nope'"):
            tn.main(["--smoke", "--set", "nope=1"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        tn.train(tiny_reel_t, cfg, nr_iters=1)
    params = tn.init_params(0, cfg, 3, "cpu")
    with pytest.raises(RuntimeError, match="GPU"):
        tn.render_image(params, None, tiny_reel_t, 0, 0, cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        tn.main(["--smoke"])
