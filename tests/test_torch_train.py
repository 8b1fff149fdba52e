"""Port parity of the training slice: one ``sphere_init_step`` and one
``compute_loss_and_grads`` + ``apply_updates`` of ``permuto_sdf_tpu_torch``
against the JAX package's, on the CPU at a tiny config (capacity 2^10, 4
levels, 32 rays, 8 + 4 + 4 samples, 4 background samples, 16^3 grid);
the grid refresh (kernel I's plain version) against JAX's; and the port's
``train`` loop: a smoke run, resume equivalence and checkpoints.

The draws come from :func:`jax_step_draws`, which replays the JAX step's
key splits with ``jax.random``. The JAX reference runs eagerly
(``jax.disable_jit``): under ``jit`` XLA contracts ``o + z d`` into a fused
multiply-add, which moves sample positions by a rounding and, at the finest
level, now and then across a simplex face (ROADMAP Queue 3). The step
comparison feeds the port JAX's own fg samples for the same reason; the
port's sampling stage is held against JAX's separately.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.datasets import synthetic as jsyn
from permuto_sdf_tpu.datasets import tensor_reel as jreel
from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.ops.ray_samples import RaySamples as JRaySamples
from permuto_sdf_tpu.train import optimizers as jopt
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.convert import opt_state_from_jax, params_from_jax
from permuto_sdf_tpu_torch.datasets import synthetic as tsyn
from permuto_sdf_tpu_torch.datasets.tensor_reel import TensorReel
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
from permuto_sdf_tpu_torch.train import checkpoint as tckpt
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt
from torch_shared_steps import dense_step

_TINY = dict(capacity=2 ** 10, nr_levels=4, nr_rays=32, grid_nr_voxels_per_dim=16,
             max_nr_samples_per_ray=8, nr_samples_imp_sampling=4, nr_samples_bg=4,
             imp_sampling_max_levels=2, sphere_init_points=512,
             grid_nr_random_samples=512)
# one step past sphere init where every term is on: all SDF levels open,
# curvature, eikonal (reduced), offsurface, Lipschitz, colorcal, the rgb
# table's weight decay, and the lr in its warm-up
_STEP = dict(_TINY, nr_iter_sphere_fit=20, sdf_nr_iters_for_c2f=100,
             iter_start_reduce_curv=100, warmup_iters=200,
             forced_variance_finish_iter=400)
_STEP_ITER = 20 + 150
# the same step with hit-ray compaction, compacted after sampling (the
# bucket of 64 rays holds all 32: every hit ray fits, the misses go to
# fill slots); the SDF's coarse-to-fine window still closes its finest
# levels, whose gradient the two packages round ~1e-3 apart (ROADMAP
# Queue 3), which the few samples of this step would not average out
_HIT_STEP = dict(_STEP, hit_ray_frac=0.5, hit_ray_compact_early=False, sdf_nr_iters_for_c2f=1000)


def jax_numpy(tree):
    """A JAX pytree with numpy leaves (picklable)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_step_draws(key, cfg, reel_j) -> tt.TrainDraws:
    """The draws of JAX's ``compute_loss_and_grads(key)``, replayed from its
    key splits (train_permuto_sdf.py:852, tensor_reel.py:122,
    train_permuto_sdf.py:502 and :390, importance_sampling.py:63,
    ray_sampler.py:78, fields.py:204, ray_primitives.py:55)."""
    R, n = cfg.nr_rays, cfg.nr_samples_imp_sampling
    k_rays, k_render, k_curv, k_off = jax.random.split(key, 4)
    k_img, k_pix = jax.random.split(k_rays)
    img = jax.random.randint(k_img, (R,), 0, reel_j.nr_images)
    pix = jax.random.randint(k_pix, (R,), 0, reel_j.height * reel_j.width)
    k_samp, k_bg, _ = jax.random.split(k_render, 3)
    k_uni, k_imp = jax.random.split(k_samp)
    k1, k2 = jax.random.split(k_imp)
    mov = 1.0 / (n + 1) / 2.0
    M = R * (cfg.max_nr_samples_per_ray + 2 * n)
    cb = min(cfg.curvature_sample_budget, M)
    ko = jax.random.split(k_off, 3)
    t = lambda a, dtype=torch.float32: torch.from_numpy(np.array(a)).to(dtype)  # noqa: E731
    return tt.TrainDraws(
        ray_indices=(t(img, torch.int64), t(pix, torch.int64)),
        fg_start=t(jax.random.uniform(k_uni, (R, 1))),
        imp_jitter=(t(jax.random.uniform(k1, (R, n), minval=-mov, maxval=mov)),
                    t(jax.random.uniform(k2, (R, n), minval=-mov, maxval=mov))),
        bg_rand=t(jax.random.uniform(k_bg, (R, cfg.nr_samples_bg))),
        curv_dirs=t(jax.random.normal(k_curv, (cb, 3))),
        off_points=(t(jax.random.uniform(ko[0], (1024,), minval=0.0, maxval=2 * jnp.pi)),
                    t(jax.random.uniform(ko[1], (1024,), minval=-1.0, maxval=1.0)),
                    t(jax.random.uniform(ko[2], (1024,)))),
    )


def _leaves(tree, prefix=""):
    """{path: array} of a params tree (dicts and lists)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    if tree is None:
        return {prefix: None}
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def _level_rtol(rtol, spec, shift):
    """Per-level tolerance of a hash-table gradient: the gradient of a slot
    is a sum of barycentric weight x cotangent, and the two packages'
    weights differ by up to ~2 d ulp of the lattice coordinates (|p| <= 1
    here), which reach ~1e4 at the finest level (sigma = 1e-4), where an
    ulp is ~1e-3 (see test_torch_encoding._feature_tol)."""
    d = spec.pos_dim
    lat = 1.0 / spec.scales + np.abs(shift).max(axis=1)
    return rtol + 4 * d * np.spacing(lat.astype(np.float32))


def _assert_tree_close(got, want, rtol, what, level_rtol=None):
    """Every leaf within ``rtol`` of the leaf's largest |value| (a None
    port gradient stands for zeros); a hash table per level, within
    ``level_rtol[l]`` of that level's largest |value|."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        ref = w[k]
        val = np.zeros_like(ref) if g[k] is None else g[k]
        assert np.all(np.isfinite(val)), (what, k)
        if k.endswith("lattice_values"):
            for lvl, tol in enumerate(level_rtol):
                err = float(np.abs(val[lvl] - ref[lvl]).max())
                scale = float(np.abs(ref[lvl]).max())
                assert err <= tol * scale + 1e-12, (what, k, lvl, err, scale, tol)
            continue
        scale = float(np.abs(ref).max())
        err = float(np.abs(val - ref).max())
        assert err <= rtol * scale + 1e-12, (what, k, err, scale)


def make_reels():
    reel_j = jsyn.make_synthetic_reel(nr_views=3, width=32, height=32)
    reel_t = TensorReel(*(torch.from_numpy(np.array(a)) for a in
                          (reel_j.rgb, reel_j.mask, reel_j.K, reel_j.tf_world_cam)))
    return reel_j, reel_t


@pytest.fixture(scope="module")
def reels():
    return make_reels()


@pytest.fixture(scope="module")
def step(request, tmp_path_factory):
    """One training step on both sides from the same params, grid and draws
    (and the hit-ray step of ``tests/test_torch_hit_rays.py``), built once
    per session (``torch_shared_steps``): the eager JAX steps are the
    costliest setup of the port's tests."""
    return dense_step(request, tmp_path_factory)


def _step(reels):
    reel_j, reel_t = reels
    cfg_j = jt.PermutoSDFTrainConfig(**_STEP)
    cfg_t = tt.PermutoSDFTrainConfig(**_STEP)
    pj = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(3), cfg_j,
                                                           reel_j.nr_images))
    # colour calibration away from identity, so its gradient is not trivial
    rng = np.random.default_rng(0)
    pj["colorcal"] = {k: rng.normal(0, 0.05, v.shape).astype(np.float32)
                      for k, v in pj["colorcal"].items()}
    occ = rng.uniform(size=16 ** 3) < 0.6
    grid_j = jog.OccupancyGridState(values=jnp.zeros(occ.size), occupancy=jnp.asarray(occ))
    grid_t = tog.OccupancyGridState(values=torch.zeros(occ.size), occupancy=torch.from_numpy(occ))
    key = jax.random.PRNGKey(11)
    draws = jax_step_draws(key, cfg_j, reel_j)
    cfg_hj = jt.PermutoSDFTrainConfig(**_HIT_STEP)
    with jax.disable_jit():
        loss_j, aux_j, grads_j = jt.compute_loss_and_grads(
            jax.tree_util.tree_map(jnp.asarray, pj), grid_j, reel_j, key, _STEP_ITER, cfg_j)
        origins, dirs, _, _, img = jreel.random_rays_from_reel(
            reel_j, jax.random.split(key, 4)[0], cfg_j.nr_rays, apply_mask=False)
        it_anneal = _STEP_ITER - cfg_j.nr_iter_sphere_fit
        samples_j = jt.run_net(jax.tree_util.tree_map(jnp.asarray, pj), grid_j,
                               jax.random.split(key, 4)[1], origins, dirs, img, it_anneal,
                               0.0, 0.3, cfg_j, jitter=True)[4]
        opt = jt.make_optimizer(cfg_j)
        st = opt.init(jax.tree_util.tree_map(jnp.asarray, pj))
        new_pj, new_st = jt.apply_updates(jax.tree_util.tree_map(jnp.asarray, pj), st,
                                          grads_j, _STEP_ITER, cfg_j, opt)
        # the hit-ray step (late compaction) on a grid that only the x < -0.1
        # slab occupies, so some rays carry no sample (the same shapes as the
        # dense step: its eager ops are compiled already)
        slab = np.asarray(tog.lin_idx_to_voxel_center(
            cfg_t.grid, torch.arange(cfg_t.grid.nr_voxels))[:, 0] < -0.1)
        slab_j = jog.OccupancyGridState(values=jnp.zeros(slab.size), occupancy=jnp.asarray(slab))
        loss_hj, aux_hj, grads_hj = jt.compute_loss_and_grads(
            jax.tree_util.tree_map(jnp.asarray, pj), slab_j, reel_j, key, _STEP_ITER, cfg_hj)
        samples_hj = jt.run_net(jax.tree_util.tree_map(jnp.asarray, pj), slab_j,
                                jax.random.split(key, 4)[1], origins, dirs, img, it_anneal,
                                0.0, 0.3, dataclasses.replace(cfg_hj, hit_ray_frac=None),
                                jitter=True)[4]
    pt = params_from_jax(pj, "cpu")
    fields = ("origins", "dirs", "z", "dt", "mask", "ray_fixed_dt")
    fg = RaySamples(*(torch.from_numpy(np.array(getattr(samples_j, f))) for f in fields))
    loss_t, aux_t, grads_t = tt.compute_loss_and_grads(pt, grid_t, reel_t, draws, _STEP_ITER,
                                                       cfg_t, fg_samples=fg)
    opt_t = tt.make_optimizer(cfg_t)
    st_t = opt_t.init(pt)
    new_pt, new_st_t = tt.apply_updates(pt, st_t, grads_t, _STEP_ITER, cfg_t, opt_t)
    fg_slab = RaySamples(*(torch.from_numpy(np.array(getattr(samples_hj, f))) for f in fields))
    slab_t = tog.OccupancyGridState(values=torch.zeros(slab.size),
                                    occupancy=torch.from_numpy(slab))
    hit_t = tt.compute_loss_and_grads(params_from_jax(pj, "cpu"), slab_t, reel_t, draws,
                                      _STEP_ITER, tt.PermutoSDFTrainConfig(**_HIT_STEP),
                                      fg_samples=fg_slab)  # pt was updated in place
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, pj=pj, grid_t=grid_t, draws=draws,
                hit=(hit_t, (float(loss_hj), jax_numpy(aux_hj), jax_numpy(grads_hj))),
                loss=(loss_t, float(loss_j)), aux=(aux_t, jax_numpy(aux_j)),
                grads=(grads_t, jax_numpy(grads_j)), samples_j=jax_numpy(samples_j),
                rays_j=jax_numpy((origins, dirs)),
                new_params=(new_pt, jax_numpy(new_pj)), new_state=(new_st_t, jax_numpy(new_st)))


def test_replayed_draws_give_jax_rays(step, reels):
    """The replay of JAX's key splits is right: the port's rays from the
    replayed image and pixel ids are JAX's rays."""
    o_t, d_t, _, _, _ = tt.random_rays_from_reel(reels[1], step["cfg_t"].nr_rays,
                                                indices=step["draws"].ray_indices)
    o_j, d_j = step["rays_j"]
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-7)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)


def test_sampling_stage_with_jitter_matches_jax(step, reels):
    """The port's jittered sampling stage (occupancy sampler + two rounds
    of importance sampling) on the replayed draws places JAX's samples: the
    masks are equal and z agrees to 1e-4 on all but 2% of the valid
    samples (kernel C's integer cumulative length puts a sample on a probe
    boundary across a gap where JAX's f32 cumsum does not; the importance
    stage then inverts a CDF a rounding apart)."""
    cfg_t, draws = step["cfg_t"], step["draws"]
    o, d = (torch.from_numpy(np.array(a)) for a in step["rays_j"])
    pt = params_from_jax(step["pj"], "cpu")
    got, hit, _, _ = tt._create_fg_samples(pt, step["grid_t"], o, d,
                                           _STEP_ITER - cfg_t.nr_iter_sphere_fit, cfg_t, draws)
    assert hit is None
    want = step["samples_j"]
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    assert mask.sum() > 100
    far = (np.abs(got.z.numpy() - np.asarray(want.z)) > 1e-4) & mask
    assert far.sum() <= 0.02 * mask.sum(), far.sum()


def test_loss_matches_jax(step):
    """The total loss and its rgb, eikonal and curvature terms to 1e-4
    relative (float32 sums in another order; NeuS at inv_s ~ 20)."""
    (loss_t, loss_j), (aux_t, aux_j) = step["loss"], step["aux"]
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    for k in ("loss_rgb", "loss_eikonal", "loss_curvature"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=1e-4, abs=1e-7), k
    assert float(aux_j["loss_curvature"]) > 0
    assert int(aux_t["nr_samples"]) == int(aux_j["nr_samples"])


@pytest.mark.parametrize("group", ["sdf", "rgb", "bg", "colorcal", "variance"])
def test_gradients_match_jax(step, group):
    """Every leaf's gradient (tables through kernels F and G, MLPs through
    the double backward, colorcal) to 2e-3 of the leaf's largest |grad|
    (float32 sums in another order), the tables per level within
    :func:`_level_rtol` (the fine levels' barycentric weights)."""
    grads_t, grads_j = step["grads"]
    want = jax.tree_util.tree_map(np.asarray, grads_j[group])
    if group == "variance":  # inv_s comes from the forced variance: no gradient
        assert np.all(want["variance"] == 0) and grads_t[group]["variance"] is None
        return
    level_rtol = None
    if group != "colorcal":
        spec = getattr(step["cfg_j"], {"sdf": "sdf_model", "rgb": "rgb_model",
                                      "bg": "bg_model"}[group]).encoding
        level_rtol = _level_rtol(2e-3, spec, step["pj"][group]["encoding"]["shift_per_level"])
    _assert_tree_close(grads_t[group], want, 2e-3, group, level_rtol)


def test_apply_updates_matches_jax(step):
    """Params after ManualAdam + the per-group weight decay: the first Adam
    step moves each entry by ~lr sign(g), so the params agree to 1e-6 of
    lr wherever |g| is not at the float noise of the gradient comparison,
    and the Adam count and moments carry across."""
    new_pt, new_pj = step["new_params"]
    (grads_t, grads_j) = step["grads"]
    st_t, st_j = step["new_state"]
    assert int(st_t.count[0]) == int(np.asarray(st_j.count)[0]) == 1
    lr = float(tt.lr_schedule(step["cfg_t"], _STEP_ITER))
    assert lr == pytest.approx(float(jt.lr_schedule(step["cfg_j"], _STEP_ITER)), rel=1e-7)
    g_t, g_j = _leaves(grads_t), _leaves(jax.tree_util.tree_map(np.asarray, grads_j))
    p_t, p_j = _leaves(new_pt), _leaves(jax.tree_util.tree_map(np.asarray, new_pj))
    for k in p_j:
        gj = g_j[k]
        gt = np.zeros_like(gj) if g_t[k] is None else g_t[k]
        # entries whose gradient is clearly away from zero on both sides
        clear = np.abs(gj) > 1e-2 * np.abs(gj).max()
        clear &= np.sign(gt) == np.sign(gj)
        np.testing.assert_allclose(p_t[k][clear], p_j[k][clear], atol=1e-6 * lr + 1e-7,
                                   rtol=1e-6, err_msg=k)
    mu_t, mu_j = _leaves(st_t.mu), _leaves(jax.tree_util.tree_map(np.asarray, st_j.mu))
    k = "/sdf/mlp_sdf/0/w"
    np.testing.assert_allclose(mu_t[k], mu_j[k], atol=2e-3 * np.abs(mu_j[k]).max())


def test_sphere_init_step_matches_jax():
    """One sphere-init step from the same params and points: the loss, the
    SDF's gradients and the params after Adam."""
    cfg_j = jt.PermutoSDFTrainConfig(**_TINY)
    cfg_t = tt.PermutoSDFTrainConfig(**_TINY)
    pj = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(5), cfg_j, 1))
    key = jax.random.PRNGKey(6)
    k = jax.random.split(key, 3)
    n = cfg_j.sphere_init_points
    draws = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k[0], (n,), minval=0.0, maxval=2 * jnp.pi),
        jax.random.uniform(k[1], (n,), minval=-1.0, maxval=1.0),
        jax.random.uniform(k[2], (n,))))
    opt_j = jt.make_optimizer(cfg_j)
    with jax.disable_jit():
        pj_dev = jax.tree_util.tree_map(jnp.asarray, pj)
        new_pj, st_j, loss_j = jt.sphere_init_step(pj_dev, opt_j.init(pj_dev), key, 7, cfg_j,
                                                   opt_j)
    pt = params_from_jax(pj, "cpu")
    opt_t = tt.make_optimizer(cfg_t)
    new_pt, st_t, loss_t = tt.sphere_init_step(pt, opt_t.init(pt), draws, 7, cfg_t, opt_t)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    want = _leaves(jax.tree_util.tree_map(np.asarray, new_pj))
    got = _leaves(new_pt)
    mu = _leaves(st_t.mu)
    mu_j = _leaves(jax.tree_util.tree_map(np.asarray, st_j.mu))
    for name in mu_j:
        # the first moment is 0.1 x the gradient: every leaf's to 2e-4 of its max
        np.testing.assert_allclose(mu[name], mu_j[name],
                                   atol=2e-4 * np.abs(mu_j[name]).max() + 1e-30, err_msg=name)
        # one Adam step moves an entry by lr sign(g): equal where the gradient
        # is clearly away from zero on both sides, unmoved where it is zero
        clear = (np.abs(mu_j[name]) > 1e-3 * np.abs(mu_j[name]).max()) & (
            np.sign(mu[name]) == np.sign(mu_j[name]))
        np.testing.assert_allclose(got[name][clear], want[name][clear], atol=2e-9,
                                   rtol=1e-6, err_msg=name)
        zero = mu_j[name] == 0
        np.testing.assert_array_equal(got[name][zero & (mu[name] == 0)],
                                      want[name][zero & (mu[name] == 0)], err_msg=name)


def test_grid_refresh_matches_jax():
    """Kernel I's plain version: the stratified probe ids equal JAX's, the
    centers agree to 1e-6, and given the same sdf the update writes the
    same values and occupancy."""
    cfg_j, cfg_t = jog.OccupancyGridConfig(16), tog.OccupancyGridConfig(16)
    n = 512
    key = jax.random.PRNGKey(2)
    for update_idx in (0, 5, 2 ** 23 + 3):  # the last wraps the uint32 index
        c_j, lin_j = jog.compute_stratified_sample_of_grid_points(
            cfg_j, key, n, jnp.asarray(update_idx, jnp.uint32), jitter=True)
        jit = torch.from_numpy(np.array(jax.random.uniform(key, (n, 3), minval=-0.5,
                                                           maxval=0.5)))
        c_t, lin_t = tog.compute_stratified_sample_of_grid_points(cfg_t, n, update_idx, jit,
                                                                  "cpu")
        np.testing.assert_array_equal(lin_t.numpy(), np.asarray(lin_j))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)
    rng = np.random.default_rng(1)
    sdf = rng.normal(0, 0.01, n).astype(np.float32)
    occ0 = rng.uniform(size=16 ** 3) < 0.5
    vals0 = rng.normal(size=16 ** 3).astype(np.float32)
    want = jog.update_with_sdf_random_sample(
        cfg_j, jog.OccupancyGridState(values=jnp.asarray(vals0), occupancy=jnp.asarray(occ0)),
        lin_j, jnp.asarray(sdf), jnp.float32(400.0), 1e-4)
    grid_t = tog.OccupancyGridState(values=torch.from_numpy(vals0.copy()),
                                    occupancy=torch.from_numpy(occ0.copy()))
    got = tog.update_with_sdf_random_sample(cfg_t, grid_t, lin_t, torch.from_numpy(sdf), 400.0,
                                            1e-4)
    assert got is grid_t  # in place
    np.testing.assert_array_equal(got.occupancy.numpy(), np.asarray(want.occupancy))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values), atol=1e-6)
    changed = np.asarray(want.occupancy) != occ0
    assert changed.sum() > 10


def test_occupancy_update_matches_jax():
    """The flagship refresh ``occupancy_update`` (on the CPU: entry 1's
    plain version, the SDF on grid_update_max_levels = 3 of 4 levels under
    an active c2f window, entry 2's plain version) against JAX's from the
    same parameters and jitter (replayed from JAX's key): the probed values
    within 2e-6 (float32 sums in another order; the SDF reaches ~0.2 here),
    the flags equal but where the threshold lies between the two values'
    densities, the other voxels unchanged."""
    cfg_kw = dict(_TINY, grid_update_max_levels=3, sdf_nr_iters_for_c2f=1000)
    cfg_j, cfg_t = jt.PermutoSDFTrainConfig(**cfg_kw), tt.PermutoSDFTrainConfig(**cfg_kw)
    pj = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(7), cfg_j, 1))
    pj["sdf"]["encoding"]["lattice_values"] = pj["sdf"]["encoding"]["lattice_values"] * 1e4
    it, inv_s, n = 101, 400.0, cfg_t.grid_nr_random_samples
    assert _c2f_window_active(it, cfg_t)
    key = jax.random.PRNGKey(8)
    rng = np.random.default_rng(3)
    occ0 = rng.uniform(size=16 ** 3) < 0.5
    vals0 = rng.normal(size=16 ** 3).astype(np.float32)
    want = jt.occupancy_update(
        jax.tree_util.tree_map(jnp.asarray, pj),
        jog.OccupancyGridState(values=jnp.asarray(vals0), occupancy=jnp.asarray(occ0)), key, it,
        inv_s, cfg_j)
    jitter = torch.from_numpy(np.array(jax.random.uniform(key, (n, 3), minval=-0.5,
                                                          maxval=0.5)))
    grid_t = tog.OccupancyGridState(values=torch.from_numpy(vals0.copy()),
                                    occupancy=torch.from_numpy(occ0.copy()))
    got = tt.occupancy_update(params_from_jax(pj, "cpu"), grid_t, jitter, it, inv_s, cfg_t)
    assert got is grid_t  # in place
    _, lin = tog.grid_points_plain(cfg_t.grid, n, it // cfg_t.grid_update_every)
    probed = np.zeros(16 ** 3, dtype=bool)
    probed[lin.numpy()] = True
    v_t, v_j = got.values.numpy(), np.asarray(want.values)
    o_t, o_j = got.occupancy.numpy(), np.asarray(want.occupancy)
    np.testing.assert_array_equal(v_t[~probed], vals0[~probed])
    np.testing.assert_array_equal(o_t[~probed], occ0[~probed])
    np.testing.assert_array_equal(o_j[~probed], occ0[~probed])
    np.testing.assert_allclose(v_t[probed], v_j[probed], atol=2e-6, rtol=0)
    x = lambda v: np.clip(np.abs(v) - cfg_t.grid.half_diagonal, 0.0, 1e10)  # noqa: E731
    d_t, d_j = (tog._logistic_density(torch.from_numpy(x(v[probed])), torch.tensor(inv_s))
                for v in (v_t, v_j))
    thresh = cfg_t.grid_occupancy_thresh
    between = ((torch.minimum(d_t, d_j) <= thresh) & (thresh <= torch.maximum(d_t, d_j))).numpy()
    differ = o_t[probed] != o_j[probed]
    assert not (differ & ~between).any()
    assert 20 < int(o_j[probed].sum()) < n - 20


def _c2f_window_active(it, cfg):
    """Whether the SDF's coarse-to-fine window still closes a level."""
    from permuto_sdf_tpu_torch.models.fields import _c2f_t
    from permuto_sdf_tpu_torch.ops.permuto_encoding import coarse2fine_window

    return coarse2fine_window(_c2f_t(it, cfg.sdf_nr_iters_for_c2f), cfg.nr_levels).min() < 1.0


def test_synthetic_reel_matches_jax():
    """The port's sphere-traced sphere+torus views equal JAX's: the masks
    agree but for a few silhouette pixels, the colours within 1e-3
    elsewhere."""
    want = jsyn.make_synthetic_reel(nr_views=2, width=24, height=24)
    got = tsyn.make_synthetic_reel(nr_views=2, width=24, height=24, device="cpu")
    mask_j = np.asarray(want.mask)
    agree = got.mask.numpy() == mask_j
    assert agree.mean() > 0.98 and mask_j.mean() > 0.05
    np.testing.assert_allclose(got.K.numpy(), np.asarray(want.K))
    np.testing.assert_allclose(got.tf_world_cam.numpy(), np.asarray(want.tf_world_cam), atol=1e-6)
    ok = np.broadcast_to(agree, got.rgb.shape)
    np.testing.assert_allclose(got.rgb.numpy()[ok], np.asarray(want.rgb)[ok], atol=1e-3)


_SMOKE = dict(_TINY, nr_iter_sphere_fit=20, warmup_iters=20, sdf_nr_iters_for_c2f=50,
              forced_variance_finish_iter=100)


@pytest.fixture(scope="module")
def tiny_reel_t():
    return tsyn.make_synthetic_reel(nr_views=3, width=32, height=32, device="cpu")


def test_train_smoke(tiny_reel_t):
    """40 iterations (20 of sphere init, then 20 steps with 5 grid
    refreshes, the forced variance annealed over the first 20), logged
    every 2: finite losses, a falling sphere-init loss and grid refreshes
    that empty space."""
    cfg = tt.PermutoSDFTrainConfig(**dict(_SMOKE, forced_variance_finish_iter=20,
                                          grid_update_every=4))
    params, grid, hist = tt.train(tiny_reel_t, cfg, nr_iters=40, log_every=2,
                                  device="cpu")
    assert all(np.isfinite(h[1]) for h in hist)
    sphere_init = [h for h in hist if h[2] is None]
    assert sphere_init[-1][1] < sphere_init[0][1]  # sphere init fits
    post = [h for h in hist if h[2] is not None]
    assert len(post) >= 8
    assert 0.05 < float(grid.occupancy.float().mean()) < 0.95


def test_resume_equals_uninterrupted_run(tiny_reel_t, tmp_path):
    """Training 40 iterations straight and 25 + resume to 40 give the same
    params bit for bit (the draws depend on (seed, iteration) only, and the
    train state carries the Adam moments, grid, counters and lr state); the
    checkpoint a port run writes loads with the port's
    ``load_from_checkpoint``, leaf for leaf, and with the JAX loader."""
    cfg = tt.PermutoSDFTrainConfig(**_SMOKE)
    full, grid_full, _ = tt.train(tiny_reel_t, cfg, nr_iters=40, log_every=100, device="cpu",
                                  dynamic_nr_rays=False)
    d = str(tmp_path)
    tt.train(tiny_reel_t, cfg, nr_iters=25, log_every=100, device="cpu",
             dynamic_nr_rays=False, checkpoint_path=d, experiment_name="exp")
    resume_dir = tckpt.latest_checkpoint_dir(d, "exp")
    assert resume_dir.endswith(os.path.join("25", "models"))
    res, grid_res, _ = tt.train(tiny_reel_t, cfg, nr_iters=40, log_every=100, device="cpu",
                                dynamic_nr_rays=False, resume_from=resume_dir)
    a, b = _leaves(full), _leaves(res)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(grid_full.occupancy.numpy(), grid_res.occupancy.numpy())

    params, grid = tt.load_from_checkpoint(resume_dir, cfg, device="cpu")
    st = tckpt.load_train_state(resume_dir)
    saved = _leaves(params_from_jax(st["params"], "cpu"))
    loaded = _leaves(params)
    assert saved.keys() == loaded.keys()
    for k in saved:
        np.testing.assert_array_equal(loaded[k], saved[k], err_msg=k)
    assert int(st["iter"]) == 24
    adam = opt_state_from_jax(st["opt_state"], "cpu")
    assert int(adam.count[0]) == 25
    jst = jt.ckpt.load_train_state(resume_dir)  # the JAX loader resolves its classes
    assert isinstance(jst["opt_state"], jopt.AdamState)
    assert isinstance(jst["grid"], jog.OccupancyGridState)


def test_unported_training_knobs_raise(tiny_reel_t):
    """``data_parallel`` waits for Queue 1 item 8 and raises;
    ``use_occupancy_grid=False`` is ported and trains without a grid."""
    cfg = tt.PermutoSDFTrainConfig(**dict(_SMOKE, use_occupancy_grid=False))
    _, grid, hist = tt.train(tiny_reel_t, cfg, nr_iters=1, device="cpu")
    assert grid is None and np.isfinite(hist[-1][1])
    with pytest.raises(NotImplementedError, match="data_parallel"):
        tt.train(tiny_reel_t, tt.PermutoSDFTrainConfig(**_SMOKE), nr_iters=1, device="cpu",
                 data_parallel=True)


def test_sample_budget_compaction_matches_the_dense_path(tiny_reel_t):
    """With more samples than ``render_sample_budget`` the fields run on the
    first ``budget`` valid samples (sync-free compaction glue); with a
    budget that holds them all the result equals the uncompacted step."""
    # no curvature: its random directions go to the i-th evaluated sample,
    # which the compaction renumbers
    cfg = tt.PermutoSDFTrainConfig(**dict(_SMOKE, render_sample_budget=None,
                                          enable_curvature=False))
    params = tt.init_params(0, cfg, tiny_reel_t.nr_images, "cpu")
    grid = tog.make_occupancy_grid(cfg.grid, device="cpu")
    centers = tog.lin_idx_to_voxel_center(cfg.grid, torch.arange(cfg.grid.nr_voxels))
    grid.occupancy[:] = torch.linalg.norm(centers, dim=-1) < 0.25  # rays past it get none
    gen = torch.Generator().manual_seed(4)
    draws = tt.draw_train_step(gen, cfg, tiny_reel_t)
    it = cfg.nr_iter_sphere_fit + 60
    dense = tt.compute_loss_and_grads(params, grid, tiny_reel_t, draws, it, cfg)
    nvalid = int(dense[1]["nr_samples"])
    assert nvalid < cfg.nr_rays * cfg.samples_per_ray
    roomy = dataclasses.replace(cfg, render_sample_budget=nvalid + 3)
    comp = tt.compute_loss_and_grads(params, grid, tiny_reel_t, draws, it, roomy)
    assert float(comp[0]) == pytest.approx(float(dense[0]), rel=1e-5)
    tight = dataclasses.replace(cfg, render_sample_budget=nvalid // 2)
    cut = tt.compute_loss_and_grads(params, grid, tiny_reel_t, draws, it, tight)
    assert int(cut[1]["nr_samples_rendered"]) == nvalid // 2
    assert np.isfinite(float(cut[0]))
