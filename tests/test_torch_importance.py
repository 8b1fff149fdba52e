"""Port parity of the importance stage (hot op E: kernels E1 and E2 on the
card, their plain versions here): ``importance_sampling_sdf_model`` with
``carry_sdf`` (the branch the train-time LOD reads) against the JAX
package's, with and without the two rounds' jitter (drawn by
``jax.random`` from JAX's two key halves and passed to the port), on
uniform samples from the occupancy sampler and an analytic sphere SDF on
both sides. The stage without a carried sdf is held in
``tests/test_torch_rendering.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.ops import importance_sampling as jis
from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.ops.ray_primitives import Sphere as JSphere
from permuto_sdf_tpu_torch.ops import importance_sampling as tis
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere as TSphere
from test_torch_rendering import _both, _rays


@pytest.mark.parametrize("jitter", [False, True])
def test_importance_stage_carrying_sdf_matches_jax(jitter):
    """``carry_sdf=True``: the second round's samples are evaluated too and
    the merged set carries every sample's sdf. The masks equal; z, dt and
    the carried sdf to 1e-5 (float32 CDF inversion); the carried sdf is
    the SDF at the merged samples' positions."""
    cfg_j, cfg_t = jog.OccupancyGridConfig(16), tog.OccupancyGridConfig(16)
    R, n = 128, 8
    o, d = _rays(R, seed=3, miss_frac=0.1)
    (oj, dj), (ot, dt_) = _both(o, d)
    _, te_j, _, tx_j, _ = JSphere().ray_intersection(oj, dj)
    _, te_t, _, tx_t, _ = TSphere().ray_intersection(ot, dt_)
    # a full grid: kernel C places the uniform samples as JAX does (on a
    # sparse grid a sample on a probe boundary can jump a gap, ROADMAP Queue 3)
    uj = jog.compute_samples_in_occupied_regions(cfg_j, jog.make_occupancy_grid(cfg_j), oj, dj,
                                                 te_j, tx_j, 1e-4, 24)
    ut = tog.compute_samples_in_occupied_regions(cfg_t, tog.make_occupancy_grid(cfg_t), ot, dt_,
                                                 te_t, tx_t, 1e-4, 24)
    sphere_j = lambda p, _m: jnp.linalg.norm(p, axis=-1) - 0.3  # noqa: E731
    sphere_t = lambda p, _m: torch.linalg.norm(p, dim=-1) - 0.3  # noqa: E731
    key = jax.random.PRNGKey(8)
    rj = jis.importance_sampling_sdf_model(sphere_j, uj, tx_j, key, n, jitter=jitter,
                                           masked=True, carry_sdf=True)
    jit = None
    if jitter:
        mov = 1.0 / (n + 1) / 2.0
        jit = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (R, n), minval=-mov,
                                                                 maxval=mov)))
                    for k in jax.random.split(key))
    rt = tis.importance_sampling_sdf_model(sphere_t, ut, tx_t, n, jitter=jit, carry_sdf=True)
    mask = np.asarray(rj.mask)
    assert mask.shape == (R, 24 + 2 * n) and 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(rt.mask.numpy(), mask)
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), atol=1e-5)
    np.testing.assert_allclose(rt.dt.numpy(), np.asarray(rj.dt), atol=1e-5)
    np.testing.assert_allclose(rt.sdf.numpy()[mask], np.asarray(rj.sdf)[mask], atol=1e-5)
    at_pos = sphere_t(rt.flat_positions(), None).reshape(mask.shape)
    np.testing.assert_allclose(rt.sdf.numpy()[mask], at_pos.numpy()[mask], atol=1e-6)
