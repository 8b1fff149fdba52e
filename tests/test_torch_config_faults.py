"""Two places where the port and the JAX package could give different
numbers without an error, on the CPU at small sizes: the trainer refuses
``table_row_gather=False`` (JAX's packed-bf16 table gather, whose forward
values round to bf16), and ``sdf2alpha_sectional`` takes its multiplier by
keyword only (JAX's third positional parameter is ``inv_s``).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.ops import volume_rendering as jvr
from permuto_sdf_tpu.ops.ray_samples import RaySamples as JRaySamples
from permuto_sdf_tpu_torch.datasets import synthetic as tsyn
from permuto_sdf_tpu_torch.datasets.tensor_reel import look_at_cam_to_world
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops import volume_rendering as tvr
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt

_TINY = dict(capacity=2 ** 10, nr_levels=4, nr_rays=32, grid_nr_voxels_per_dim=16,
             max_nr_samples_per_ray=8, nr_samples_imp_sampling=4, nr_samples_bg=4,
             imp_sampling_max_levels=2, sphere_init_points=512, grid_nr_random_samples=512)
_K = np.array([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1]], np.float32)
_TF = look_at_cam_to_world((0.3, 0.5, 1.1)).astype(np.float32)


def test_default_config_builds_its_models():
    cfg = tt.PermutoSDFTrainConfig()
    assert cfg == tt.PermutoSDFTrainConfig() and cfg.table_row_gather
    assert cfg.sdf_model.capacity == cfg.rgb_model.capacity == cfg.bg_model.capacity
    off = dataclasses.replace(cfg, table_row_gather=False)  # constructing it is fine
    assert off != cfg


@pytest.mark.parametrize("path", ["init_params", "train", "render_image",
                                  "render_image_sphere_traced"])
def test_table_row_gather_off_raises(path):
    """Every path builds its models from the config, and each refuses the
    knob JAX would serve with bf16-rounded features."""
    good = tt.PermutoSDFTrainConfig(**_TINY)
    bad = dataclasses.replace(good, table_row_gather=False)
    for name in ("sdf_model", "rgb_model", "bg_model"):
        with pytest.raises(NotImplementedError, match="packed-bf16"):
            getattr(bad, name)
    params = tt.init_params(0, good, device="cpu")
    grid = tog.make_occupancy_grid(good.grid, device="cpu")
    with pytest.raises(NotImplementedError, match="table_row_gather=False"):
        if path == "init_params":
            tt.init_params(0, bad, device="cpu")
        elif path == "train":
            reel = tsyn.make_synthetic_reel(nr_views=2, width=16, height=16, device="cpu")
            tt.train(reel, bad, nr_iters=1, log_every=1, device="cpu")
        else:
            getattr(tt, path)(params, grid, _K, _TF, 8, 6, 0, bad, device="cpu")


def _samples(seed=0, R=6, S=10):
    rng = np.random.default_rng(seed)
    fixed = rng.uniform(1e-4, 1e-2, R).astype(np.float32)
    z = (0.2 + fixed[:, None] * np.arange(S)[None, :]).astype(np.float32)
    nr = rng.integers(2, S + 1, R)
    mask = np.arange(S)[None, :] < nr[:, None]
    dt = np.where(mask, fixed[:, None], 0.0).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    sdf = (0.3 - z + 0.01 * rng.normal(size=(R, S))).astype(np.float32)
    return np.zeros((R, 3), np.float32), dirs, z, dt, mask, fixed, sdf


def test_sdf2alpha_sectional_multiplier_is_keyword_only():
    o, d, z, dt, mask, fixed, sdf = _samples()
    smp = RaySamples(origins=torch.from_numpy(o), dirs=torch.from_numpy(d),
                     z=torch.from_numpy(z), dt=torch.from_numpy(dt),
                     mask=prefix_mask(torch.from_numpy(mask.sum(1)), z.shape[1]),
                     ray_fixed_dt=torch.from_numpy(fixed))
    with pytest.raises(TypeError):
        tvr.sdf2alpha_sectional(smp, torch.from_numpy(sdf), 2.0)
    jsmp = JRaySamples(origins=jnp.asarray(o), dirs=jnp.asarray(d), z=jnp.asarray(z),
                       dt=jnp.asarray(dt), mask=jnp.asarray(mask),
                       ray_fixed_dt=jnp.asarray(fixed))
    for m in (1.0, 2.0, 0.25):
        got = tvr.sdf2alpha_sectional(smp, torch.from_numpy(sdf), inv_s_multiplier=m)
        want = np.asarray(jvr.sdf2alpha_sectional(jsmp, jnp.asarray(sdf), inv_s_multiplier=m))
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
