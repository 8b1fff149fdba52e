"""Port parity of the whole slice: ``render_image`` of
``permuto_sdf_tpu_torch`` against the JAX package's on a 16x12 frame at a
tiny config (capacity 2^10, 4 levels, 16^3 grid), on the CPU; plus the
port's import hygiene, device rule and checkpoint reading.

The SDF gets a planted plane (hidden unit 0 carries n.p through GELU at
+10, the two coarse levels add a small bump, the fine levels get no
weight in the SDF) so the frame has a surface and well-conditioned
normals; everything else keeps its random init. One test plants all
levels instead, so the fine levels' gradient reaches the normals.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from permuto_sdf_tpu.datasets.tensor_reel import look_at_cam_to_world
from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.convert import params_from_jax
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt

_BASE = dict(capacity=2 ** 10, nr_levels=4, grid_nr_voxels_per_dim=16,
             max_nr_samples_per_ray=8, nr_samples_imp_sampling=4, nr_samples_bg=4,
             imp_sampling_max_levels=2)
_K = np.array([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1]], np.float32)
_TF = look_at_cam_to_world((0.3, 0.5, 1.1)).astype(np.float32)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plant_plane(params, normal=(0.3, 1.0, 0.2), offset=-0.05, smooth_levels=2):
    mlp = params["sdf"]["mlp_sdf"]
    n = np.asarray(normal, np.float32)
    n /= np.linalg.norm(n)
    w0 = np.array(mlp[0]["w"])
    w0[:2 * smooth_levels, 0] *= 0.05
    w0[2 * smooth_levels:-3, 0] = 0.0
    w0[-3:, 0] = n * 1e3
    mlp[0] = {"w": w0, "b": np.array(mlp[0]["b"])}
    mlp[0]["b"][0] = 10.0
    for i in range(1, len(mlp)):
        w, b = np.array(mlp[i]["w"]), np.array(mlp[i]["b"])
        w[:, 0] = 0.0
        w[0, 0] = 1.0
        b[0] = 0.0 if i < len(mlp) - 1 else -10.0 - offset
        mlp[i] = {"w": w, "b": b}
    return params


@pytest.fixture(scope="module")
def setup():
    cfg_j = jt.PermutoSDFTrainConfig(**_BASE)
    cfg_t = tt.PermutoSDFTrainConfig(**_BASE)
    pj = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), cfg_j, 2))
    pj = _plant_plane(pj)
    rng = np.random.default_rng(0)
    occ = rng.uniform(size=16 ** 3) < 0.6
    return cfg_j, cfg_t, pj, params_from_jax(pj, "cpu"), occ


def _jax_render(cfg, params, occ, it):
    grid = jog.OccupancyGridState(values=jax.numpy.zeros(occ.size),
                                  occupancy=jax.numpy.asarray(occ))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("rays",))  # single device path
    return [np.asarray(a) for a in jt.render_image(params, grid, _K, _TF, 16, 12, it, cfg,
                                                    chunk=64, mesh=mesh)]


@pytest.mark.parametrize("iter_nr,sparse", [(20000, False), (20000, True), (1500, True)])
def test_render_image_matches_jax(setup, iter_nr, sparse):
    """Whole eval render: rgb, normals and alpha (weights_sum) to 1e-4.
    Float32 differences (MLP sums, sigmoid, CDF inversion) are amplified by
    NeuS at inv_s = exp(8) ~ 3e3."""
    cfg_j, cfg_t, pj, pt, occ = setup
    occ = occ if sparse else np.ones_like(occ)
    want = _jax_render(cfg_j, pj, occ, iter_nr)
    grid_t = tog.OccupancyGridState(values=torch.zeros(occ.size),
                                    occupancy=torch.from_numpy(occ))
    got = tt.render_image(pt, grid_t, _K, _TF, 16, 12, iter_nr, cfg_t, chunk=64, device="cpu")
    alpha = want[2]
    assert 0.1 < (alpha > 0.5).mean() < 0.9  # the plane crosses the frame
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)


def test_all_levels_render_agrees_with_jax_on_the_same_samples():
    """Every level in the SDF, so the finest level's gradient (which jumps
    at lattice-cell boundaries) reaches the normals and the colour. Fed
    JAX's own fg samples, the port's fields, NeuS weights and background
    give JAX's rgb and normals to 5e-4 and alpha to 1e-4 on every ray
    whose samples lie in the same simplex at every level in both packages
    (the slot ids of the vertices agree). They may not: XLA contracts
    o + z d into a fused multiply-add, so JAX's sample positions sit a
    rounding away from the port's and now and then across a simplex face.
    The rounding also moves the sdf by ~1e-7, which NeuS (inv_s ~ 3e3)
    turns into ~3e-4 relative changes of single weights; the random fine
    levels make neighbouring samples' gradients differ by O(1), so rgb and
    normals (which take the gradients) move by up to a few 1e-4 where the
    planted-plane render above moves by under 1e-4. On the whole path a
    ray may differ by more only where its samples differ from JAX's (the
    importance stage places them a float rounding apart) or a simplex
    differs."""
    import dataclasses

    from permuto_sdf_tpu.datasets.tensor_reel import rays_from_frame
    from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
    from test_torch_encoding import _jax_slot_ids, _port_slot_ids

    cfg_j = dataclasses.replace(jt.PermutoSDFTrainConfig(**_BASE), render_sample_budget=None,
                                train_lod_top_k=None, hit_ray_frac=None)
    cfg_t = tt.PermutoSDFTrainConfig(**_BASE)
    pj = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), cfg_j, 2))
    pj = _plant_plane(pj, smooth_levels=_BASE["nr_levels"])
    pt = params_from_jax(pj, "cpu")
    occ = np.ones(16 ** 3, bool)
    grid_j = jog.OccupancyGridState(values=jax.numpy.zeros(occ.size),
                                    occupancy=jax.numpy.asarray(occ))
    grid_t = tog.OccupancyGridState(values=torch.zeros(occ.size), occupancy=torch.from_numpy(occ))
    o, d = (np.array(a) for a in rays_from_frame(_K, _TF, 16, 12))

    @jax.jit
    def jax_run(p, g, o, d):
        return jt.run_net(p, g, jax.random.PRNGKey(0), o, d, None, 20000, 1.0, 0.8, cfg_j,
                          jitter=False)[:5]

    rgb_j, nrm_j, compact_j, ws_j, smp_j = jax_run(pj, grid_j, o, d)
    want = [np.asarray(a) for a in (rgb_j, nrm_j, ws_j)]
    ot, dtt = torch.from_numpy(o), torch.from_numpy(d)
    smp = RaySamples(origins=ot, dirs=dtt, z=torch.from_numpy(np.array(smp_j.z)),
                     dt=torch.from_numpy(np.array(smp_j.dt)),
                     mask=torch.from_numpy(np.array(smp_j.mask)),
                     ray_fixed_dt=torch.from_numpy(np.array(smp_j.ray_fixed_dt)))
    t_exit = tt.BOUND.ray_intersection(ot, dtt)[3]
    with torch.no_grad():
        same = tt.render_samples(pt, smp, t_exit, 20000, 1.0, 0.8, tt._eval_cfg(cfg_t))
        whole = tt.run_net(pt, grid_t, ot, dtt, 20000, 1.0, 0.8, tt._eval_cfg(cfg_t))
    assert 0.1 < (want[2] > 0.5).mean() < 0.9  # the plane crosses the frame

    L, enc, mask_j = _BASE["nr_levels"], pt["sdf"]["encoding"], np.asarray(smp_j.mask)
    slots_j = _jax_slot_ids(np.asarray(compact_j["pos"]), pj["sdf"]["encoding"]["shift_per_level"],
                            cfg_j.sdf_model.encoding, L)

    def simplex_differs(samples):
        slots = _port_slot_ids(samples.flat_positions().numpy(), enc["lattice_values"],
                               enc["shift_per_level"], cfg_t.sdf_model.encoding, L)
        flip = np.any(slots != slots_j, axis=(0, 2)).reshape(mask_j.shape)
        return np.any(flip & mask_j & samples.mask.numpy(), axis=1)

    flipped = simplex_differs(smp)
    assert flipped.mean() < 0.1
    tols = (5e-4, 5e-4, 1e-4)  # rgb, normals, alpha
    for g, w, tol in zip(same[:3], want, tols):
        np.testing.assert_allclose(g.numpy()[~flipped], w[~flipped], atol=tol, rtol=0)

    s = whole[3]["samples"]
    samples_differ = (np.any(s.mask.numpy() != mask_j, axis=1)
                      | np.any(np.where(mask_j, s.z.numpy() != np.asarray(smp_j.z), False),
                               axis=1))
    off = np.zeros(len(o), bool)
    for g, w, tol in zip(whole[:3], want, tols):
        off |= np.abs(g.numpy() - w).max(axis=1) > tol
    unexplained = off & ~samples_differ & ~simplex_differs(s)
    assert not np.any(unexplained), np.flatnonzero(unexplained)


def test_render_image_default_device_needs_cuda(setup, monkeypatch):
    """device=None means the GPU; without one the entry points raise and
    never fall back to the CPU."""
    _, cfg_t, _, pt, occ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid_t = tog.make_occupancy_grid(cfg_t.grid, device="cpu")
    with pytest.raises(RuntimeError, match="GPU"):
        tt.render_image(pt, grid_t, _K, _TF, 16, 12, 20000, cfg_t)
    with pytest.raises(RuntimeError, match="GPU"):
        tt.init_params(0, cfg_t)


def test_unported_branches_raise(setup):
    """The branches that wait for a later slice raise, naming what they
    wait for."""
    import dataclasses

    _, cfg_t, _, pt, _ = setup
    grid_t = tog.make_occupancy_grid(cfg_t.grid, device="cpu")
    with pytest.raises(NotImplementedError):
        tt.render_image(pt, grid_t, _K, _TF, 16, 12, 20000, cfg_t, lod=True, device="cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3)
    for knob, match in ((dict(hit_ray_frac=0.5), "row H"),
                        (dict(train_lod_top_k=8), "train_lod_top_k"),
                        (dict(use_occupancy_grid=False), "use_occupancy_grid")):
        with pytest.raises(NotImplementedError, match=match):
            tt.run_net(pt, grid_t, o, d, 0, 1.0, 0.8, dataclasses.replace(cfg_t, **knob))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import permuto_sdf_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'permuto_sdf_tpu' or m.startswith('permuto_sdf_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_jax_checkpoint_renders_the_same_pixels(setup, tmp_path):
    """A checkpoint written by the JAX trainer's _save loads in the port
    (numpy only) and renders exactly what the directly converted params
    render; the occupancy grid comes back too."""
    cfg_j, cfg_t, pj, pt, occ = setup
    grid_j = jog.OccupancyGridState(values=jax.numpy.zeros(occ.size),
                                    occupancy=jax.numpy.asarray(occ))
    jt._save(str(tmp_path), "exp", 7, jax.tree_util.tree_map(jax.numpy.asarray, pj), grid_j)
    params, grid = tt.load_from_checkpoint(os.path.join(str(tmp_path), "exp", "7", "models"),
                                           cfg_t, device="cpu")
    np.testing.assert_array_equal(grid.occupancy.numpy(), occ)
    assert "colorcal" in params
    grid_t = tog.OccupancyGridState(values=torch.zeros(occ.size), occupancy=torch.from_numpy(occ))
    a = tt.render_image(params, grid, _K, _TF, 16, 12, 20000, cfg_t, chunk=64, device="cpu")
    b = tt.render_image(pt, grid_t, _K, _TF, 16, 12, 20000, cfg_t, chunk=64, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
