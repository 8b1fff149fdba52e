"""Port parity of the interactive sphere-traced frame:
``render_image_sphere_traced_fast`` of ``permuto_sdf_tpu_torch`` against the
JAX package's on a 32x32 frame at a small config (capacity 2^10, 8 levels,
32^3 grid) on the CPU, JAX run eagerly on a one-device mesh (with more than
one visible device the JAX render takes its multi-device path; under
``jit`` XLA contracts ``o + t d`` into a fused multiply-add). The SDF gets
the planted plane of ``test_torch_render_image``; the grids are a shell
around that plane (jumps fire) and a full grid (they never do). Plus the
checkpoint path, the device rule, what still raises, and the distance-field
cache after an in-place grid refresh.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.datasets.tensor_reel import look_at_cam_to_world
from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.convert import params_from_jax
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops import sphere_trace as tst
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt
from test_torch_render_image import _plant_plane

_BASE = dict(capacity=2 ** 10, nr_levels=8, grid_nr_voxels_per_dim=32)
_V = 32
_K = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], np.float32)
_TF = look_at_cam_to_world((0.3, 0.5, 1.1)).astype(np.float32)
_NORMAL = np.array([0.3, 1.0, 0.2], np.float32) / np.linalg.norm([0.3, 1.0, 0.2])


def _plane_shell(offset_voxels=0.0):
    """Voxels whose center lies within 2 voxels of the planted plane
    n.p = -0.05 (moved by ``offset_voxels`` along n)."""
    xs = (np.arange(_V, dtype=np.float32) + 0.5) / _V - 0.5
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    dist = X * _NORMAL[0] + Y * _NORMAL[1] + Z * _NORMAL[2] + 0.05 - offset_voxels / _V
    return (np.abs(dist) < 2.0 / _V).reshape(-1), dist.reshape(-1)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jt.PermutoSDFTrainConfig(**_BASE)
    cfg_t = tt.PermutoSDFTrainConfig(**_BASE)
    pj = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), cfg_j, 2))
    pj = _plant_plane(pj)
    return cfg_j, cfg_t, pj, params_from_jax(pj, "cpu")


def _grid_t(occ):
    return tog.OccupancyGridState(values=torch.zeros(occ.size), occupancy=torch.from_numpy(occ))


@pytest.mark.parametrize("grid_kind,lod", [
    ("shell", dict(lod_levels=4)),
    ("full", dict(lod_schedule=(2, 4, 6), nr_rounds=3, iters_per_round=5, nr_refine_iters=3))])
def test_render_image_sphere_traced_fast_matches_jax(setup, grid_kind, lod):
    """The lit masks are equal and rgb and normals agree to 1/255 (one
    quantization step) on every pixel: the two packages trace the same
    rays through the same float operations, and the SDF, its gradient and
    the colour (MLP sums in another order) differ by ~1e-7, far below a
    quantization step except where a value sits on a step's edge."""
    cfg_j, cfg_t, pj, pt = setup
    occ = _plane_shell()[0] if grid_kind == "shell" else np.ones(_V ** 3, bool)
    grid_j = jog.OccupancyGridState(values=jnp.zeros(occ.size), occupancy=jnp.asarray(occ))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("rays",))
    with jax.disable_jit():
        want = jt.render_image_sphere_traced_fast(pj, grid_j, _K, _TF, 32, 32, 20000, cfg_j,
                                                  mesh=mesh, **lod)
    stats = []
    got = tt.render_image_sphere_traced_fast(pt, _grid_t(occ), _K, _TF, 32, 32, 20000, cfg_t,
                                             device="cpu", stats_out=stats, **lod)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cpu"
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert 0.2 < want[2].mean() < 0.8  # the plane crosses the frame
    lit = want[2][..., 0] > 0
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[lit], w[lit], atol=1.0 / 255 + 1e-6, rtol=0)
        assert not g.numpy()[~lit].any()
    assert stats[-2][0] == "refine" and int(stats[-1][1]) == int(lit.sum())


def test_jax_checkpoint_renders_the_same_sphere_traced_pixels(setup, tmp_path):
    """A checkpoint written by the JAX trainer renders, through
    ``load_from_checkpoint``, exactly the pixels of the converted params."""
    cfg_j, cfg_t, pj, pt = setup
    occ = _plane_shell()[0]
    grid_j = jog.OccupancyGridState(values=jnp.zeros(occ.size), occupancy=jnp.asarray(occ))
    jt._save(str(tmp_path), "exp", 3, jax.tree_util.tree_map(jnp.asarray, pj), grid_j)
    params, grid = tt.load_from_checkpoint(os.path.join(str(tmp_path), "exp", "3", "models"),
                                           cfg_t, device="cpu")
    a = tt.render_image_sphere_traced_fast(params, grid, _K, _TF, 32, 32, 20000, cfg_t,
                                           lod_levels=4, device="cpu")
    b = tt.render_image_sphere_traced_fast(pt, _grid_t(occ), _K, _TF, 32, 32, 20000, cfg_t,
                                           lod_levels=4, device="cpu")
    assert a[2].sum() > 100
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_refreshed_grid_gets_a_new_distance_field(setup):
    """The render caches the distance field per grid state. A refresh that
    writes the grid in place (``update_with_sdf_random_sample``, here moving
    the occupied shell by one voxel) must give the next frame a new field:
    the cached field equals one built from the refreshed grid, the frame
    and its trace equal those rendered with that field passed explicitly,
    and the old field would have traced otherwise."""
    _, cfg_t, _, pt = setup
    occ, _ = _plane_shell()
    grid = _grid_t(occ.copy())
    kw = dict(lod_levels=4, device="cpu")
    tt.render_image_sphere_traced_fast(pt, grid, _K, _TF, 32, 32, 20000, cfg_t, **kw)
    old_field = tt._cached_dist_field(cfg_t.grid, grid).clone()
    sdf = torch.from_numpy(_plane_shell(offset_voxels=1.0)[1].astype(np.float32))  # moved a voxel
    tog.update_with_sdf_random_sample(cfg_t.grid, grid, torch.arange(_V ** 3, dtype=torch.int32),
                                      sdf, inv_s=2981.0)
    assert not np.array_equal(grid.occupancy.numpy(), occ)
    stats_cached, stats_fresh, stats_stale = [], [], []
    got = tt.render_image_sphere_traced_fast(pt, grid, _K, _TF, 32, 32, 20000, cfg_t,
                                             stats_out=stats_cached, **kw)
    fresh = tog.chebyshev_empty_distance(cfg_t.grid, grid.occupancy, tst._EMPTY_DIST_CAP)
    assert torch.equal(tt._cached_dist_field(cfg_t.grid, grid), fresh)
    assert not torch.equal(fresh, old_field)
    want = tt.render_image_sphere_traced_fast(pt, grid, _K, _TF, 32, 32, 20000, cfg_t,
                                              dist_field=fresh, stats_out=stats_fresh, **kw)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert [s for s in stats_cached if s[0] != "lit"] == [s for s in stats_fresh if s[0] != "lit"]
    tt.render_image_sphere_traced_fast(pt, grid, _K, _TF, 32, 32, 20000, cfg_t,
                                       dist_field=old_field, stats_out=stats_stale, **kw)
    assert stats_stale[:-1] != stats_fresh[:-1]


def test_sphere_traced_default_device_needs_cuda(setup, monkeypatch):
    """device=None means the GPU; without one the render raises."""
    _, cfg_t, _, pt = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        tt.render_image_sphere_traced_fast(pt, _grid_t(_plane_shell()[0]), _K, _TF, 32, 32,
                                           20000, cfg_t)


def test_sphere_traced_unported_branches_raise(setup):
    """Several devices (Queue 1 item 8) and the 4D time sweep (Queue 1 item
    5) raise; a one-device mesh is the single-device path."""
    _, cfg_t, _, pt = setup
    grid = _grid_t(_plane_shell()[0])
    with pytest.raises(NotImplementedError, match="item 8"):
        tt.render_image_sphere_traced_fast(pt, grid, _K, _TF, 32, 32, 20000, cfg_t,
                                           mesh=[torch.device("cpu")] * 2, device="cpu")
    one = tt.render_image_sphere_traced_fast(pt, grid, _K, _TF, 8, 8, 20000, cfg_t,
                                             mesh=[torch.device("cpu")], device="cpu")
    assert one[0].shape == (8, 8, 3)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    with pytest.raises(NotImplementedError, match="item 5"):
        tst.sphere_trace_adaptive(lambda ctx, p: p[:, 0], None, o, d, tt.BOUND, time_val=0.5)
