"""Port parity of the hit-ray compaction (``hit_ray_frac``, ROADMAP Queue 2
row H): the ray take and scatter (kernels H1 and H2's plain versions) with
the scatter's gradient, the bucket sizes and the rebalancer's ladder, and
``run_net`` with early and late compaction against the JAX package's and
against the port's own dense path, on the CPU at a tiny config (capacity
2^10, 4 levels, a 16x16 frame, 8 + 4 + 4 samples, a 16^3 grid of which only
a slab is occupied, so some rays carry no sample); and one training step
with late compaction against JAX's, from the shared step fixture of
``tests/test_torch_train.py`` (its first user in collection order, so the
session builds it early).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.datasets.tensor_reel import rays_from_frame
from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.ops.ray_samples import RaySamples as JRaySamples
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.convert import params_from_jax
from permuto_sdf_tpu_torch.datasets import synthetic as tsyn
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops.compaction import scatter_rows
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt
from test_torch_render_image import _BASE, _K, _TF, _plant_plane
from test_torch_train import _assert_tree_close, _level_rtol
from torch_shared_steps import dense_step

_W = _H = 16


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def step(request, tmp_path_factory):
    return dense_step(request, tmp_path_factory)


@pytest.mark.parametrize("group", ["loss", "sdf", "rgb", "bg", "colorcal"])
def test_hit_ray_step_matches_jax(step, group):
    """One step with hit-ray compaction (late: the rays with a sample are
    listed into the bucket after sampling, kernels H0-H2's plain versions)
    on a grid that some rays miss, fed JAX's fg samples: the loss, the
    sample and hit counts and every leaf's gradient at the dense step's
    tolerances."""
    (loss_t, aux_t, grads_t), (loss_j, aux_j, grads_j) = step["hit"]
    if group == "loss":
        assert float(loss_t) == pytest.approx(loss_j, rel=1e-4)
        for k in ("loss_rgb", "loss_eikonal", "loss_curvature"):
            assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), rel=1e-4, abs=1e-7), k
        R = step["cfg_t"].nr_rays
        assert 0 < int(aux_t["nr_hit_rays"]) == int(aux_j["nr_hit_rays"]) < R
        assert int(aux_t["nr_samples"]) == int(aux_j["nr_samples"]) > 0
        return
    level_rtol = None
    if group != "colorcal":
        spec = getattr(step["cfg_j"], {"sdf": "sdf_model", "rgb": "rgb_model",
                                      "bg": "bg_model"}[group]).encoding
        level_rtol = _level_rtol(2e-3, spec, step["pj"][group]["encoding"]["shift_per_level"])
    _assert_tree_close(grads_t[group], grads_j[group], 2e-3, group, level_rtol)


def test_hit_ray_budget_and_ladder_match_jax():
    """``_hit_ray_budget`` and the rebalancer's ``_hit_frac_bucket`` over a
    grid of ray counts, measured fractions and current rungs: equal."""
    assert tt._HIT_FRAC_LADDER == jt._HIT_FRAC_LADDER
    for R in (1, 32, 64, 65, 100, 128, 512, 1000, 4096):
        for frac in (0.01, 0.25, 0.3, 0.5, 0.62, 0.75, 0.9, 1.0):
            assert tt._hit_ray_budget(R, frac) == jt._hit_ray_budget(R, frac), (R, frac)
    for hf in np.linspace(0.0, 1.0, 41):
        for current in jt._HIT_FRAC_LADDER:
            assert tt._hit_frac_bucket(float(hf), current) == jt._hit_frac_bucket(
                float(hf), current), (hf, current)


def test_take_and_scatter_rays_match_jax():
    """``_take_rays`` (with t_exit and image ids) and ``scatter_rows`` on a
    bucket that holds fill slots, and one that overflows: the same arrays
    as JAX's, exactly; the scatter's gradient equals JAX's VJP."""
    rng = np.random.default_rng(0)
    R, S = 40, 6
    nr = rng.integers(0, S + 1, R)
    nr[:12] = 0  # miss rays
    mask = np.arange(S)[None, :] < nr[:, None]
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    arrays = dict(origins=f32(R, 3), dirs=f32(R, 3), z=f32(R, S), dt=f32(R, S), mask=mask,
                  ray_fixed_dt=f32(R), sdf=f32(R, S))
    t_exit, img = f32(R, 1), rng.integers(0, 5, R)
    smp_j = JRaySamples(**{k: jnp.asarray(v) for k, v in arrays.items()})
    smp_t = RaySamples(**{k: _t(v) for k, v in arrays.items()})
    hits = int(mask.any(axis=1).sum())
    for budget in (hits + 7, hits - 5):
        idx_j, valid_j = jt._compact_idx(smp_j.valid_rays(), budget)
        idx_t, _ = tt._compact_idx(smp_t.valid_rays(), budget)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        want = jt._take_rays(smp_j, idx_j, valid_j)
        got, te, im = tt._take_rays(smp_t, idx_t, _t(t_exit), _t(img))
        for f in arrays:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(te.numpy(), np.asarray(jt._pad_one(t_exit)[idx_j]))
        np.testing.assert_array_equal(im.numpy(), np.asarray(jt._pad_one(img, 0)[idx_j]))

        xs = [f32(budget, 3), f32(budget, 1), f32(budget)]
        fills = (0.0, 0.0, 1.0)
        cots = [f32(R, 3), f32(R, 1), f32(R)]
        leaves = [_t(x).requires_grad_(True) for x in xs]
        outs = scatter_rows(leaves, idx_t, R, fills)
        torch.autograd.backward(outs, [_t(c) for c in cots])
        for x, fill, out, leaf, c in zip(xs, fills, outs, leaves, cots):
            y, vjp = jax.vjp(lambda v, fill=fill: jt._scatter_rays(v, idx_j, R, fill), x)
            np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
            np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(vjp(c)[0]))


@pytest.fixture(scope="module")
def scene():
    """Planted-plane params with a non-identity colour calibration, a grid
    whose x < -0.05 slab alone is occupied, and the 16x16 frame's rays with
    image ids."""
    cfg_j = jt.PermutoSDFTrainConfig(**_BASE)
    pj = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), cfg_j, 3))
    pj = _plant_plane(pj)
    rng = np.random.default_rng(1)
    pj["colorcal"] = {k: rng.normal(0, 0.05, v.shape).astype(np.float32)
                      for k, v in pj["colorcal"].items()}
    centers = tog.lin_idx_to_voxel_center(tog.OccupancyGridConfig(16), torch.arange(16 ** 3))
    occ = (centers[:, 0] < -0.05).numpy()
    o, d = (np.array(a) for a in rays_from_frame(_K, _TF, _W, _H))
    img = rng.integers(0, 3, o.shape[0]).astype(np.int32)
    return pj, occ, o, d, img


def _jax_run_net(cfg, pj, occ, o, d, img, key, jitter):
    grid = jog.OccupancyGridState(values=jnp.zeros(occ.size), occupancy=jnp.asarray(occ))
    fn = jax.jit(lambda p, g, k, o, d, i: jt.run_net(p, g, k, o, d, i, 20000, 1.0, 0.8, cfg,
                                                     jitter=jitter))
    out = fn(jax.tree_util.tree_map(jnp.asarray, pj), grid, key, o, d, img)
    return [np.asarray(out[i]) for i in (0, 1, 3)], out[2]


def _run_net_draws(key, cfg, R):
    """The jitter of JAX's ``run_net(key)``, replayed (the importance jitter
    at the bucket's shape with early compaction)."""
    n = cfg.nr_samples_imp_sampling
    k_samp, k_bg, _ = jax.random.split(key, 3)
    k_uni, k_imp = jax.random.split(k_samp)
    k1, k2 = jax.random.split(k_imp)
    mov = 1.0 / (n + 1) / 2.0
    R_imp = jt._hit_ray_budget(R, cfg.hit_ray_frac) if cfg.hit_ray_compact_early else R
    return tt.TrainDraws(
        ray_indices=None, curv_dirs=None, off_points=None,
        fg_start=_t(jax.random.uniform(k_uni, (R, 1))),
        imp_jitter=tuple(_t(jax.random.uniform(k, (R_imp, n), minval=-mov, maxval=mov))
                         for k in (k1, k2)),
        bg_rand=_t(jax.random.uniform(k_bg, (R, cfg.nr_samples_bg))))


@pytest.mark.parametrize("early,jitter,frac", [(True, False, 0.5), (False, True, 0.5),
                                               (True, True, 0.25)])
def test_run_net_with_hit_rays_matches_jax(scene, early, jitter, frac):
    """``run_net`` with hit-ray compaction on 256 rays of which some hit the
    slab: early compaction (the importance stage on the bucket) and late
    compaction (after sampling), each with a bucket that holds every hit
    ray, and an early one that overflows (the last hit rays drop). Against
    JAX's ``run_net`` on the same params, grid and (replayed) jitter: rgb,
    normals and weights_sum to 1e-4 (as the exact render's test), the hit
    and sample counts equal. Where the bucket holds every hit ray, against
    the port's own dense path with the same draws: 1e-6."""
    pj, occ, o, d, img = scene
    R = o.shape[0]
    base = dict(_BASE, hit_ray_frac=frac, hit_ray_compact_early=early)
    cfg_j, cfg_t = jt.PermutoSDFTrainConfig(**base), tt.PermutoSDFTrainConfig(**base)
    key = jax.random.PRNGKey(5)
    want, compact_j = _jax_run_net(cfg_j, pj, occ, o, d, img, key, jitter)
    pt = params_from_jax(pj, "cpu")
    grid = tog.OccupancyGridState(values=torch.zeros(occ.size), occupancy=_t(occ))
    draws = _run_net_draws(key, cfg_j, R) if jitter else None
    args = (pt, grid, _t(o), _t(d), 20000, 1.0, 0.8)
    with torch.no_grad():
        got = tt.run_net(*args, cfg_t, draws=draws, img_indices=_t(img, torch.int64))
    hits = int(got[3]["nr_hit_rays"])
    bucket = tt._hit_ray_budget(R, frac)
    assert 0.2 * R < hits < R and (hits > bucket) == (frac == 0.25)
    assert hits == int(compact_j["nr_hit_rays"])
    assert int(got[3]["nr_samples_total"]) == int(compact_j["nr_samples_total"])
    for g, w in zip(got[:3], want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)
    if hits <= bucket:
        dense_cfg = dataclasses.replace(cfg_t, hit_ray_frac=None)
        if early and jitter:
            return  # the importance jitter is drawn at another shape
        with torch.no_grad():
            dense = tt.run_net(*args, dense_cfg, draws=draws, img_indices=_t(img, torch.int64))
        for g, w in zip(got[:3], dense[:3]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)


def test_train_moves_the_hit_frac_along_the_ladder(monkeypatch):
    """``train`` with ``hit_ray_frac``: the rebalancer (every 50 iterations,
    here at iteration 0) moves the bucket fraction to the rung that
    ``_hit_frac_bucket`` gives for the measured hit fraction, and the
    next step runs on it."""
    reel = tsyn.make_synthetic_reel(nr_views=2, width=24, height=24, device="cpu")
    cfg = tt.PermutoSDFTrainConfig(**dict(_BASE, nr_rays=128, nr_iter_sphere_fit=0,
                                          enable_curvature=False, hit_ray_frac=1.0))
    seen, real_step = [], tt.train_step

    def spy(params, opt_state, grid, reel, draws, it, cfg, optimizer):
        out = real_step(params, opt_state, grid, reel, draws, it, cfg, optimizer)
        seen.append((cfg.hit_ray_frac, float(out[3]["nr_hit_rays"]), cfg.nr_rays))
        return out

    monkeypatch.setattr(tt, "train_step", spy)
    # a grid of which only the x < -0.3 cap is occupied, kept as it is
    grid0 = tog.make_occupancy_grid(cfg.grid, device="cpu")
    grid0.occupancy[:] = tog.lin_idx_to_voxel_center(cfg.grid, torch.arange(16 ** 3))[:, 0] < -0.3
    monkeypatch.setattr(tog, "make_occupancy_grid", lambda *a, **k: grid0)
    monkeypatch.setattr(tt, "occupancy_update", lambda params, grid, *a: grid)
    tt.train(reel, cfg, nr_iters=2, log_every=100, device="cpu")
    (frac0, hits0, rays0), (frac1, _, _) = seen
    assert frac0 == 1.0 and 0 < hits0 < rays0
    assert frac1 == jt._hit_frac_bucket(hits0 / rays0, 1.0) < 1.0
