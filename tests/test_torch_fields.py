"""Port parity: the SDF, RGB and background fields of
``permuto_sdf_tpu_torch`` against the JAX package's, on the CPU, with the
same parameters carried across by ``params_from_jax``.

Tables are scaled up from the init's +-1e-4 to +-1e-2 so the encoding
moves the outputs measurably. Tolerances: the sdf and colours agree to
float32 rounding (2e-5); the spatial gradient to 2e-4 relative, bounded by
the float32 lattice precision at the finest level (a barycentric weight
carries ~1e-3 absolute error there, see test_torch_encoding._feature_tol,
and the SDF's fine-level table entries are ~1e-2).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.models import fields as jf
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.convert import params_from_jax
from permuto_sdf_tpu_torch.models import fields as tf
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt
from test_torch_encoding import _ambiguous_mask

_TINY = dict(capacity=2 ** 10, nr_levels=4)


def _params():
    cfg = jt.PermutoSDFTrainConfig(**_TINY)
    params = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(3), cfg, 1))
    for field in ("sdf", "rgb", "bg"):
        params[field]["encoding"]["lattice_values"] = params[field]["encoding"]["lattice_values"] * 100
    return cfg, tt.PermutoSDFTrainConfig(**_TINY), params, params_from_jax(params, "cpu")


def _points(n, d, seed=0):
    return np.random.default_rng(seed).uniform(-0.45, 0.45, (n, d)).astype(np.float32)


@pytest.mark.parametrize("iter_nr,max_levels", [(20000, None), (1500, None), (20000, 2)])
def test_sdf_apply_matches_jax(iter_nr, max_levels):
    """Full field, a partial c2f window (iter 1500 of 10000), and the
    proxy that slices the first layer's rows (max_levels=2)."""
    cfg, tcfg, pj, pt = _params()
    pts = _points(400, 3)
    s_j, g_j = jf.sdf_apply(pj["sdf"], jnp.asarray(pts), iter_nr, cfg.sdf_model, max_levels)
    s_t, g_t = tf.sdf_apply(pt["sdf"], torch.from_numpy(pts), iter_nr, tcfg.sdf_model, max_levels)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=2e-5, rtol=0)


@pytest.mark.parametrize("iter_nr", [20000, 1500])
def test_sdf_with_gradient_matches_jax(iter_nr):
    """Reverse-mode spatial gradient: torch autograd through the MLP and
    kernel B's plain version vs jax.vjp (fields.py _sdf_with_gradient_rev)."""
    cfg, tcfg, pj, pt = _params()
    pts = _points(400, 3, seed=1)
    s_j, gr_j, geo_j = jf.sdf_with_gradient(pj["sdf"], jnp.asarray(pts), iter_nr, cfg.sdf_model)
    with torch.no_grad():  # the render calls it under no_grad
        s_t, gr_t, geo_t = tf.sdf_with_gradient(pt["sdf"], torch.from_numpy(pts), iter_nr,
                                                tcfg.sdf_model)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(geo_t.numpy(), np.asarray(geo_j), atol=2e-5, rtol=0)
    # the gradient jumps where a point's simplex flips: leave tie points out
    ok = ~_ambiguous_mask(pts, pj["sdf"]["encoding"]["shift_per_level"],
                          cfg.sdf_model.encoding, cfg.nr_levels).any(0)
    assert ok.mean() > 0.7
    gr_j = np.asarray(gr_j)
    scale = np.abs(gr_j).max()
    np.testing.assert_allclose(gr_t.numpy()[ok] / scale, gr_j[ok] / scale, atol=2e-4, rtol=0)


def test_rgb_apply_matches_jax():
    cfg, tcfg, pj, pt = _params()
    rng = np.random.default_rng(2)
    n = 300
    pts = _points(n, 3, seed=2)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    grads = rng.normal(size=(n, 3)).astype(np.float32)
    geom = rng.normal(size=(n, 32)).astype(np.float32)
    want = jf.rgb_apply(pj["rgb"], *(jnp.asarray(a) for a in (pts, dirs, grads, geom)), 20000,
                        cfg.rgb_model)
    got = tf.rgb_apply(pt["rgb"], *(torch.from_numpy(a) for a in (pts, dirs, grads, geom)),
                       20000, tcfg.rgb_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_nerf_hash_apply_matches_jax():
    """Background field on the 4D NeRF++ parameterisation (SH degree 4)."""
    cfg, tcfg, pj, pt = _params()
    rng = np.random.default_rng(3)
    n = 300
    pos4 = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(0, 1, (n, 1))], -1)
    pos4[:, :3] /= np.linalg.norm(pos4[:, :3], axis=-1, keepdims=True)
    pos4 = pos4.astype(np.float32)
    dirs = pos4[:, :3].copy()
    rgb_j, dens_j = jf.nerf_hash_apply(pj["bg"], jnp.asarray(pos4), jnp.asarray(dirs), 20000,
                                       cfg.bg_model)
    rgb_t, dens_t = tf.nerf_hash_apply(pt["bg"], torch.from_numpy(pos4), torch.from_numpy(dirs),
                                       20000, tcfg.bg_model)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j), atol=2e-5, rtol=1e-5)


def test_spherical_harmonics_match_jax():
    from permuto_sdf_tpu.ops.spherical_harmonics import spherical_harmonics as jsh
    from permuto_sdf_tpu_torch.ops.spherical_harmonics import spherical_harmonics as tsh

    d = np.random.default_rng(4).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for deg in (4, 5):
        np.testing.assert_allclose(tsh(torch.from_numpy(d), deg).numpy(),
                                   np.asarray(jsh(jnp.asarray(d), deg)), atol=1e-6)
