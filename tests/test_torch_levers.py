"""Port parity of the recommended training profile's levers on the CPU: the
train-time LOD (``train_lod_top_k`` + ``train_lod_rand_extra``: the
finite-difference cos, kernel L's selection, the mixed chain of kernels D2
and D2'), alternating-level table gradients (``table_grad_parity``) and the
gate that holds both back (``lever_start_iter``), each against the JAX
package at a tiny size (capacity 2^10, 4 levels, 32-64 rays).

The selection and the mixed chain are held against JAX's own lines of
``run_net`` (train_permuto_sdf.py:536-560 and :608-622) run on the same
arrays; the LOD branch of ``render_samples`` against JAX's ``run_net`` on
JAX's samples; one whole step (LOD, parity and hit-ray compaction) against
JAX's eager step; ``train``'s gate against JAX's ``train``, step cfg by step
cfg, with the steps themselves replaced by recorders.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.datasets import tensor_reel as jreel
from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.ops import volume_rendering as jvr
from permuto_sdf_tpu.ops.ray_samples import RaySamples as JRaySamples
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.convert import params_from_jax
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops import volume_rendering as vr
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask
from permuto_sdf_tpu_torch.train import checkpoint as tckpt
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt
from test_torch_train import (
    _HIT_STEP, _STEP_ITER, _assert_tree_close, _leaves, _level_rtol, jax_numpy,
    jax_step_draws, make_reels,
)
from torch_shared_steps import lever_step

_FIELDS = ("origins", "dirs", "z", "dt", "mask", "ray_fixed_dt")


def _np(t):
    return np.asarray(t)


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _lod_arrays(seed, R, S):
    """A carried-sdf batch (numpy): prefix masks with empty, full, one-sample
    and short rays, a prefix ending before S, a ray inside the surface (its
    weights underflow to exact ties at 0), a ray whose scores all tie, a
    last sample with dt 0, and carried sdf at the invalid slots as the merge
    leaves it."""
    rng = np.random.default_rng(seed)
    nr = rng.integers(0, S + 1, R)
    nr[:6] = (0, S, 1, 3, S, S - 5)
    mask = np.arange(S)[None, :] < nr[:, None]
    z = np.sort(rng.uniform(0.5, 1.5, (R, S)), axis=1).astype(np.float32)
    dt = np.where(mask, rng.uniform(0.002, 0.02, (R, S)), 0.0).astype(np.float32)
    dt[5, nr[5] - 1] = 0.0
    sdf = (0.05 - 0.1 * rng.uniform(size=(R, 1)) - (z - 1.0) * 0.2
           + rng.normal(0, 0.003, (R, S))).astype(np.float32)
    sdf[4] = -1.0
    sdf = np.where(mask, sdf, rng.uniform(-5, 1e3, (R, S))).astype(np.float32)
    scores = rng.uniform(size=(R, S)).astype(np.float32)
    scores[6] = 0.5
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dict(mask=mask, z=z, dt=dt, sdf=sdf, scores=scores, dirs=dirs)


def _samples(a):
    R = a["mask"].shape[0]
    kw = dict(origins=np.zeros((R, 3), np.float32), dirs=a["dirs"], z=a["z"], dt=a["dt"],
              mask=a["mask"], ray_fixed_dt=np.full(R, 0.01, np.float32))
    return (RaySamples(**{k: _t(v) for k, v in kw.items()}),
            JRaySamples(**{k: jnp.asarray(v) for k, v in kw.items()}))


def _jax_select(smp_j, sdf, inv_s, car, scores, K, E):
    """JAX's selection, train_permuto_sdf.py:538-560."""
    R = sdf.shape[0]
    cos_fd = jvr.finite_difference_cos(smp_j, sdf)
    w_rank, _, _ = jvr.neus_compute_weights_from_cos(smp_j, sdf, cos_fd, inv_s, car)
    rows = jnp.arange(R)[:, None]
    _, ik = jax.lax.top_k(jnp.where(smp_j.mask, w_rank, -1.0), K)
    if E == 0:
        return cos_fd, ik
    scores = scores.at[rows, ik].set(-1.0)
    scores = jnp.where(smp_j.mask, scores, -1.0)
    _, ie = jax.lax.top_k(scores, E)
    return cos_fd, jnp.concatenate([ik, ie], axis=1)


def _jax_mixed(smp_j, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c, inv_s, car):
    """JAX's mixed chain, train_permuto_sdf.py:566-569 and :608-622."""
    R, S = smp_j.mask.shape
    KE = sel.shape[1]
    idx = (jnp.arange(R)[:, None] * S + sel).reshape(-1)
    vc = jnp.take(smp_j.flat_mask(), idx)
    dirs_c = smp_j.flat_dirs()[idx]
    sdf_flat = sdf_carried.reshape(-1).at[idx].set(
        jnp.where(vc, sdf_c.reshape(-1), sdf_carried.reshape(-1)[idx]))
    cos_sel = jnp.sum(dirs_c * grads_c, axis=-1)
    cos_flat = cos_fd.reshape(-1).at[idx].set(jnp.where(vc, cos_sel, cos_fd.reshape(-1)[idx]))
    weights, weights_sum, bg_T = jvr.neus_compute_weights_from_cos(
        smp_j, sdf_flat.reshape(R, S), cos_flat.reshape(R, S), inv_s, car)
    w_sel = jnp.where(vc.reshape(R, KE), jnp.take(weights.reshape(-1), idx).reshape(R, KE), 0.0)
    pred_rgb = jnp.sum(w_sel[..., None] * rgb_c.reshape(R, KE, 3), axis=1)
    grad_int = jnp.sum(w_sel[..., None] * grads_c.reshape(R, KE, 3), axis=1)
    return weights, weights_sum, bg_T, pred_rgb, grad_int


@pytest.mark.parametrize("S,K,E", [(24, 6, 3), (24, 4, 0), (20, 12, 8)])
def test_selection_matches_jax_top_k(S, K, E):
    """``finite_difference_cos`` and kernel L's plain version against JAX's
    fd cos, ranking weights and ``lax.top_k`` selection: cos_fd bit for bit
    and the selected slots exactly, on ties, rays with fewer valid samples
    than K+E (which select slots twice, as top_k does over the tied -1s),
    all-invalid rays and prefixes ending before S."""
    a = _lod_arrays(S + K + E, 48, S)
    smp_t, smp_j = _samples(a)
    inv_s, car = 400.0, 0.6
    cos_j, sel_j = _jax_select(smp_j, jnp.asarray(a["sdf"]), jnp.float32(inv_s),
                               jnp.float32(car), jnp.asarray(a["scores"]), K, E)
    np.testing.assert_array_equal(vr.finite_difference_cos(smp_t, _t(a["sdf"])).numpy(),
                                  _np(cos_j))
    cos_t, sel_t = vr.train_lod_select(smp_t, _t(a["sdf"]), inv_s, car,
                                       _t(a["scores"]) if E else None, K, E)
    np.testing.assert_array_equal(cos_t.numpy(), _np(cos_j))
    np.testing.assert_array_equal(sel_t.numpy(), _np(sel_j))
    short = a["mask"].sum(1) < K + E
    assert short.any() and (~short).any()
    if E:
        assert any(len(set(r)) < K + E for r in sel_t.numpy()[short].tolist())


def test_mixed_chain_matches_jax():
    """Kernel D2's plain version and its backward (kernel D2''s, autograd of
    the plain forward) against JAX's mixed chain and ``jax.vjp``: weights,
    weights_sum, bg_T and the integrals to 1e-6; the cotangents of the fine
    set's sdf, gradient and rgb to 1e-5 of their largest |value|, including
    slots selected twice (the chain takes the last fine row, as JAX's
    scatter, and the integration counts both)."""
    S, K, E = 24, 6, 3
    a = _lod_arrays(7, 48, S)
    smp_t, smp_j = _samples(a)
    inv_s, car = 400.0, 0.6
    cos_t, sel_t = vr.train_lod_select(smp_t, _t(a["sdf"]), inv_s, car, _t(a["scores"]), K, E)
    rng = np.random.default_rng(8)
    n = 48 * (K + E)
    ins = [rng.uniform(-0.05, 0.05, (n, 1)), rng.normal(size=(n, 3)), rng.uniform(size=(n, 3))]
    ins = [x.astype(np.float32) for x in ins]
    # a slot selected twice holds the same point: equal fine values
    sel_np = sel_t.numpy()
    for r, row in enumerate(sel_np):
        for k in range(K + E):
            first = int(np.argmax(row == row[k]))
            for x in ins:
                x[r * (K + E) + k] = x[r * (K + E) + first]

    def jax_fn(sdf_c, grads_c, rgb_c):
        return _jax_mixed(smp_j, jnp.asarray(a["sdf"]), jnp.asarray(_np(cos_t)),
                          jnp.asarray(sel_np), sdf_c, grads_c, rgb_c, jnp.float32(inv_s),
                          jnp.float32(car))

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in ins))
    leaves = [_t(x).requires_grad_(True) for x in ins]
    got = vr.neus_render_mixed(smp_t, _t(a["sdf"]), cos_t, sel_t, *leaves, inv_s, car)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), _np(w).reshape(g.shape), atol=1e-6,
                                   rtol=0)
    cots = [rng.normal(size=_np(w).shape).astype(np.float32) for w in want]
    want_d = vjp(tuple(jnp.asarray(c) for c in cots))
    got_d = torch.autograd.grad(got, leaves, [_t(c).reshape(g.shape) for c, g in zip(cots, got)])
    for g, w in zip(got_d, want_d):
        w = _np(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


_LOD_BASE = dict(capacity=2 ** 10, nr_levels=4, nr_rays=64, grid_nr_voxels_per_dim=16,
                 max_nr_samples_per_ray=16, nr_samples_imp_sampling=4, nr_samples_bg=4,
                 render_sample_budget=None, curvature_sample_budget=None)


@pytest.fixture(scope="module")
def lod_scene():
    cfg_j = jt.PermutoSDFTrainConfig(**_LOD_BASE)
    pj = jax_numpy(jt.init_params(jax.random.PRNGKey(0), cfg_j, 1))
    ang = np.linspace(-0.4, 0.4, 64, dtype=np.float32)
    dirs = np.stack([np.sin(ang), np.zeros(64, np.float32), np.cos(ang)], -1)
    origins = np.tile(np.asarray([[0.0, 0.0, -1.2]], np.float32), (64, 1))
    return pj, origins, dirs


def test_full_selection_equals_the_exact_path(lod_scene):
    """With K = S and no extras every valid sample is in the fine set and
    the carried proxy sdf is the full SDF (12 >= 4 levels), so the LOD
    render equals the exact one (tests/test_pipelines.py:202)."""
    pj, o, d = lod_scene
    cfg = tt.PermutoSDFTrainConfig(**_LOD_BASE)
    S = cfg.samples_per_ray
    params = params_from_jax(pj, "cpu")
    grid = tog.make_occupancy_grid(cfg.grid, device="cpu")
    exact = tt.run_net(params, grid, _t(o), _t(d), 100, 1.0, 0.8, cfg)
    lod = tt.run_net(params, grid, _t(o), _t(d), 100, 1.0, 0.8,
                     dataclasses.replace(cfg, train_lod_top_k=S, train_lod_rand_extra=0))
    assert lod[3]["compact"]["pos"].shape[0] == 64 * S
    for i, tol in ((0, 1e-5), (1, 1e-4), (2, 1e-5)):
        np.testing.assert_allclose(lod[i].detach().numpy(), exact[i].detach().numpy(),
                                   rtol=1e-4, atol=tol)


# the whole profile in one step: LOD (K 4, E 2), the parity-1 levels' table
# gradients and hit-ray compaction after sampling (the _HIT_STEP step of
# tests/test_torch_train.py: the SDF's finest levels closed by its window)
_PROFILE_STEP = dict(_HIT_STEP, train_lod_top_k=4, train_lod_rand_extra=2, table_grad_parity=1)


def lever_step_draws(key, cfg_j, reel_j):
    """JAX's draws of the step (test_torch_train.jax_step_draws) with the
    LOD's scores (k_sel, train_permuto_sdf.py:502, :549) and the curvature
    directions sized by the fine set."""
    draws = jax_step_draws(key, cfg_j, reel_j)
    _, k_render, k_curv, _ = jax.random.split(key, 4)
    k_sel = jax.random.split(k_render, 3)[2]
    S = cfg_j.max_nr_samples_per_ray + 2 * cfg_j.nr_samples_imp_sampling
    K = min(cfg_j.train_lod_top_k, S)
    fine = jt._hit_ray_budget(cfg_j.nr_rays, cfg_j.hit_ray_frac) * min(
        K + cfg_j.train_lod_rand_extra, S)
    cb = min(cfg_j.curvature_sample_budget, fine)
    return dataclasses.replace(
        draws, curv_dirs=_t(jax.random.normal(k_curv, (cb, 3))),
        lod_scores=_t(jax.random.uniform(k_sel, (cfg_j.nr_rays, S))))


def _profile_step():
    reel_j, reel_t = make_reels()
    cfg_j = jt.PermutoSDFTrainConfig(**_PROFILE_STEP)
    cfg_t = tt.PermutoSDFTrainConfig(**_PROFILE_STEP)
    pj = jax_numpy(jt.init_params(jax.random.PRNGKey(3), cfg_j, reel_j.nr_images))
    rng = np.random.default_rng(0)
    pj["colorcal"] = {k: rng.normal(0, 0.05, v.shape).astype(np.float32)
                      for k, v in pj["colorcal"].items()}
    # a grid that only the x < -0.1 slab occupies: some rays carry no sample
    slab = np.asarray(tog.lin_idx_to_voxel_center(
        cfg_t.grid, torch.arange(cfg_t.grid.nr_voxels))[:, 0] < -0.1)
    grid_j = jog.OccupancyGridState(values=jnp.zeros(slab.size), occupancy=jnp.asarray(slab))
    key = jax.random.PRNGKey(11)
    draws = lever_step_draws(key, cfg_j, reel_j)
    it_anneal = _STEP_ITER - cfg_j.nr_iter_sphere_fit
    with jax.disable_jit():
        pj_dev = jax.tree_util.tree_map(jnp.asarray, pj)
        loss_j, aux_j, grads_j = jt.compute_loss_and_grads(pj_dev, grid_j, reel_j, key,
                                                          _STEP_ITER, cfg_j)
        origins, dirs, _, _, img = jreel.random_rays_from_reel(
            reel_j, jax.random.split(key, 4)[0], cfg_j.nr_rays, apply_mask=False)
        # the step's run_net without hit-ray compaction: its samples (with the
        # carried sdf) are the ones the compacted step starts from
        net_j = jt.run_net(pj_dev, grid_j, jax.random.split(key, 4)[1], origins, dirs, img,
                           it_anneal, 0.0, 0.3, dataclasses.replace(cfg_j, hit_ray_frac=None),
                           jitter=True)
        samples_j = net_j[4]
        opt = jt.make_optimizer(cfg_j)
        new_pj, new_st = jt.apply_updates(pj_dev, opt.init(pj_dev), grads_j, _STEP_ITER, cfg_j,
                                          opt)
    pt = params_from_jax(pj, "cpu")
    fg = RaySamples(*(_t(getattr(samples_j, f)) for f in _FIELDS), sdf=_t(samples_j.sdf))
    grid_t = tog.OccupancyGridState(values=torch.zeros(slab.size),
                                    occupancy=torch.from_numpy(slab))
    with torch.no_grad():
        o_t, d_t = _t(origins), _t(dirs)
        net_t = tt.render_samples(pt, fg, tt.BOUND.ray_intersection(o_t, d_t)[3], it_anneal,
                                  0.0, 0.3, dataclasses.replace(cfg_t, hit_ray_frac=None),
                                  img_indices=_t(img), bg_rand=draws.bg_rand, rays=(o_t, d_t),
                                  lod_scores=draws.lod_scores)
    loss_t, aux_t, grads_t = tt.compute_loss_and_grads(pt, grid_t, reel_t, draws, _STEP_ITER,
                                                       cfg_t, fg_samples=fg)
    opt_t = tt.make_optimizer(cfg_t)
    new_pt, new_st_t = tt.apply_updates(pt, opt_t.init(pt), grads_t, _STEP_ITER, cfg_t, opt_t)
    compact = lambda c: {k: _np(c[k]) for k in ("pos", "sdf", "grads", "valid")}  # noqa: E731
    net = [(tuple(_np(x) for x in net_t[:3]), compact(net_t[3]["compact"])),
           (tuple(_np(x) for x in (net_j[0], net_j[1], net_j[3])), compact(net_j[2]))]
    return dict(cfg_j=cfg_j, pj=pj, net=net, loss=(loss_t, float(loss_j)),
                aux=({k: v for k, v in aux_t.items() if k != "samples"}, jax_numpy(aux_j)),
                grads=(grads_t, jax_numpy(grads_j)), new_params=(new_pt, jax_numpy(new_pj)),
                new_state=(new_st_t, jax_numpy(new_st)))


@pytest.fixture(scope="module")
def profile_step(request, tmp_path_factory):
    """Built once per session (an eager JAX step; ``torch_shared_steps``)."""
    return lever_step(request, tmp_path_factory)


def test_lod_run_net_matches_jax(profile_step):
    """JAX's ``run_net`` with the LOD (K = 4, E = 2; jitter, colour
    calibration, no compaction) against the port's ``render_samples`` on
    JAX's samples (with the carried sdf) and scores (replayed from its
    ``k_sel``): the colour, normals and weights_sum, and the fine set
    (positions, sdf, gradients, validity) the losses read."""
    (out_t, fine_t), (out_j, fine_j) = profile_step["net"]
    assert fine_t["pos"].shape == (32 * 6, 3)
    assert 0 < fine_j["valid"].sum() < 32 * 6
    for g, w, tol in zip(out_t, out_j, (1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(g, w.reshape(g.shape), rtol=1e-4, atol=tol)
    for k, tol in (("pos", 1e-7), ("sdf", 1e-6), ("grads", 1e-4)):
        np.testing.assert_allclose(fine_t[k].reshape(-1), fine_j[k].reshape(-1), atol=tol,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(fine_t["valid"], fine_j["valid"])


def test_profile_step_loss_matches_jax(profile_step):
    """The whole profile's step: the loss and its terms to 1e-4 relative,
    the sample counts, and the fine set (32 rays x 6) that the eikonal and
    curvature terms read."""
    (loss_t, loss_j), (aux_t, aux_j) = profile_step["loss"], profile_step["aux"]
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-4)
    for k in ("loss_rgb", "loss_eikonal", "loss_curvature"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=1e-4, abs=1e-7), k
    assert float(aux_j["loss_curvature"]) > 0
    for k in ("nr_samples", "nr_samples_rendered", "nr_hit_rays"):
        assert int(aux_t[k]) == int(aux_j[k]), k
    assert 0 < int(aux_j["nr_hit_rays"]) < profile_step["cfg_j"].nr_rays


@pytest.mark.parametrize("group", ["sdf", "rgb", "bg", "colorcal"])
def test_profile_step_gradients_match_jax(profile_step, group):
    """Every leaf's gradient to 2e-3 of its largest |grad| (the tables per
    level, :func:`_level_rtol`); the tables' frozen levels (even levels
    under parity 1) exactly zero on both sides and never None."""
    grads_t, grads_j = profile_step["grads"]
    cfg_j = profile_step["cfg_j"]
    level_rtol = None
    if group != "colorcal":
        spec = getattr(cfg_j, {"sdf": "sdf_model", "rgb": "rgb_model",
                               "bg": "bg_model"}[group]).encoding
        shift = profile_step["pj"][group]["encoding"]["shift_per_level"]
        level_rtol = _level_rtol(2e-3, spec, shift)
        got = grads_t[group]["encoding"]["lattice_values"].numpy()
        want = grads_j[group]["encoding"]["lattice_values"]
        for lvl in range(0, cfg_j.nr_levels, 2):
            assert np.all(got[lvl] == 0) and np.all(want[lvl] == 0), (group, lvl)
        assert np.abs(want[1]).max() > 0
    _assert_tree_close(grads_t[group], grads_j[group], 2e-3, group, level_rtol)


def test_profile_step_adam_update_matches_jax(profile_step):
    """The Adam update after the profile's step: entries with a clear
    gradient agree to 1e-6 of lr; a frozen level's entries get a zero
    gradient (Adam's moments decay and the rgb table's weight decay still
    applies), so they agree on both sides too."""
    new_pt, new_pj = profile_step["new_params"]
    grads_t, grads_j = profile_step["grads"]
    cfg_j = profile_step["cfg_j"]
    lr = float(jt.lr_schedule(cfg_j, _STEP_ITER))
    g_t, g_j = _leaves(grads_t), _leaves(grads_j)
    p_t, p_j = _leaves(new_pt), _leaves(new_pj)
    for k in p_j:
        gj = g_j[k]
        gt = np.zeros_like(gj) if g_t[k] is None else g_t[k]
        clear = (np.abs(gj) > 1e-2 * np.abs(gj).max()) & (np.sign(gt) == np.sign(gj))
        np.testing.assert_allclose(p_t[k][clear], p_j[k][clear], atol=1e-6 * lr + 1e-7,
                                   rtol=1e-6, err_msg=k)
        if k.endswith("lattice_values"):
            frozen = p_t[k][0::2]
            np.testing.assert_allclose(frozen, p_j[k][0::2], rtol=1e-6, atol=0, err_msg=k)
    st_t, st_j = profile_step["new_state"]
    assert int(st_t.count[0]) == int(np.asarray(st_j.count)[0]) == 1
    mu_t = _leaves(st_t.mu)["/rgb/encoding/lattice_values"]
    assert np.all(mu_t[0::2] == 0) and np.abs(mu_t[1::2]).max() > 0


# ---------------------------------------------------------------------------
# train()'s lever gate against JAX's, with the steps replaced by recorders
# ---------------------------------------------------------------------------

_GATE = dict(capacity=2 ** 10, nr_levels=4, nr_rays=32, nr_iter_sphere_fit=3,
             sphere_init_points=64, grid_nr_voxels_per_dim=16, grid_nr_random_samples=64,
             max_nr_samples_per_ray=8, nr_samples_imp_sampling=4, nr_samples_bg=4,
             grid_update_every=4, forced_variance_finish_iter=9, train_lod_top_k=4,
             train_lod_rand_extra=2, table_grad_alternate=True, table_grad_period=3)


def _record_train(module, monkeypatch, reel, cfg, nr_iters, **kw):
    """``module.train`` with its sphere-init, step and grid-refresh calls
    replaced by recorders -> [(kind, it, lod, alternate, parity)]."""
    log = []

    def step(params, opt_state, grid, reel, key, it, cfg, optimizer):
        log.append(("step", it, cfg.train_lod_top_k, cfg.table_grad_alternate,
                    cfg.table_grad_parity))
        aux = {"inv_s": 20.0, "nr_samples": 1, "nr_hit_rays": 1, "loss_rgb": 0.0,
               "loss_eikonal": 0.0}
        return params, opt_state, 0.0, aux

    def sphere_init(params, opt_state, key, it, cfg, optimizer):
        log.append(("sphere_init", it, None, None, None))
        return params, opt_state, 0.0

    def refresh(params, grid, key, it_anneal, inv_s, cfg):
        log.append(("grid", it_anneal + cfg.nr_iter_sphere_fit, cfg.train_lod_top_k,
                    cfg.table_grad_alternate, cfg.table_grad_parity))
        return grid

    monkeypatch.setattr(module, "train_step", step)
    monkeypatch.setattr(module, "sphere_init_step", sphere_init)
    monkeypatch.setattr(module, "occupancy_update", refresh)
    module.train(reel, cfg, nr_iters=nr_iters, log_every=1000, dynamic_nr_rays=False, **kw)
    return log


@pytest.mark.parametrize("gate", [dict(), dict(lever_start_iter=5),
                                  dict(lever_start_iter=None, with_mask=True),
                                  dict(lever_start_iter=0)])
def test_lever_gate_matches_jax(monkeypatch, gate, tmp_path):
    """The step cfgs of ``train`` iteration by iteration against JAX's: the
    levers stripped before the gate (AUTO: forced_variance_finish_iter
    without a mask, 0 with one; an explicit value; 0), restored at it, the
    parity ``it % period`` per step and never in the grid refresh's cfg;
    and a run resumed past the gate keeps them on (tests/test_pipelines.py:929)."""
    reel_j, reel_t = make_reels()
    kw = dict(_GATE, **gate)
    # data_parallel=False: JAX's train goes data parallel over the CPU
    # test devices otherwise
    log_j = _record_train(jt, monkeypatch, reel_j, jt.PermutoSDFTrainConfig(**kw), 20,
                          data_parallel=False)
    log_t = _record_train(tt, monkeypatch, reel_t, tt.PermutoSDFTrainConfig(**kw), 20,
                          device="cpu")
    assert log_t == log_j
    steps = [e for e in log_t if e[0] == "step"]
    always_on = gate.get("with_mask") or gate.get("lever_start_iter") == 0
    assert {e[2] for e in steps} == ({4} if always_on else {None, 4})
    assert all(e[4] is None for e in log_t if e[0] == "grid")
    # resumed past the gate: the levers stay on from the first step
    cfg_t = tt.PermutoSDFTrainConfig(**kw)
    params = tt.init_params(0, cfg_t, reel_t.nr_images, "cpu")
    tt._save(str(tmp_path), "exp", 15, params, tog.make_occupancy_grid(cfg_t.grid, device="cpu"),
             opt_state=tt.make_optimizer(cfg_t).init(params), cfg=cfg_t, last_inv_s=20.0)
    resume = tckpt.models_dir(str(tmp_path), "exp", 15)
    log_j = _record_train(jt, monkeypatch, reel_j, jt.PermutoSDFTrainConfig(**kw), 20,
                          resume_from=resume, data_parallel=False)
    log_t = _record_train(tt, monkeypatch, reel_t, cfg_t, 20, device="cpu", resume_from=resume)
    assert log_t == log_j and all(e[2] == 4 for e in log_t if e[0] == "step")
