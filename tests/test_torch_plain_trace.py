"""Port parity of the plain sphere tracers on the CPU: the seed (kernel
C3's plain version, ``compute_first_sample_start_of_occupied_regions``),
``sphere_trace`` and ``sphere_trace_compacted`` (kernel J3's plain
version, with H0's for the buckets), ``filter_unconverged_points``, the
three sphere-traced renderers and ``render_image_sphere_traced``, each
against the JAX package's function on the same numpy inputs; plus the
plain helpers of the occupancy grid no tracer calls.

The tracers get the same analytic SDF in both packages, written out
operation by operation, and JAX runs eagerly (``jax.disable_jit``): under
``jit`` XLA contracts ``o + t d`` into a fused multiply-add. Eager, the two
do the same float operations but for the bound intersection's square root,
which puts the seeds ~1e-7 apart (ROADMAP Queue 3, "Precision"). So a ray's
convergence and death flags may differ only where its |sdf| lies within
1e-5 of the convergence threshold or of the jump gate (one voxel), on at
most 1% of the rays, and the positions (and the compacted tracer's sdf) of
the rays whose flags agree are held to 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.datasets.tensor_reel import rays_from_frame as jrays_from_frame
from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.ops import sphere_trace as jst
from permuto_sdf_tpu.ops.ray_primitives import Sphere as JSphere
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops import sphere_trace as tst
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere as TSphere
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt
from test_torch_render_sphere_traced import _K, _TF, _plane_shell, setup  # noqa: F401
from test_torch_sphere_trace import (
    RADIUS, _jax_crust_sdf, _jax_sphere_sdf, _occupancy, _rays, _torch_crust_sdf,
    _torch_sphere_sdf,
)

THRESH = 2e-4
V = 32


def _grids(kind, V=V):
    occ = _occupancy(kind, V)
    return (jog.OccupancyGridConfig(nr_voxels_per_dim=V),
            jog.OccupancyGridState(values=jnp.zeros(V ** 3), occupancy=jnp.asarray(occ)),
            tog.OccupancyGridConfig(nr_voxels_per_dim=V),
            tog.OccupancyGridState(values=torch.zeros(V ** 3), occupancy=torch.from_numpy(occ)))


def _bound_rays(n=512, seed=0):
    """Rays from a sphere of radius 1.2 towards the bound's inside, half of
    them aimed past the 0.25 sphere (misses and grazing rays)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.2
    d = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["shell", "sparse", "empty", "full"])
@pytest.mark.parametrize("P", [512, 100])
def test_first_occupied_matches_jax(kind, P):
    """Kernel C3's plain version: ``has`` exactly (rays with no occupied
    probe on the empty grid and on misses), ``t_first`` to 1e-6 (the
    segment start, or t_exit without one)."""
    jcfg, jgrid, tcfg, tgrid = _grids(kind)
    o, d = _bound_rays()
    _, te, _, tx, _ = JSphere().ray_intersection(jnp.asarray(o), jnp.asarray(d))
    te, tx = np.asarray(te), np.asarray(tx)
    with jax.disable_jit():
        t_j, has_j = jog.compute_first_sample_start_of_occupied_regions(
            jcfg, jgrid, jnp.asarray(o), jnp.asarray(d), jnp.asarray(te), jnp.asarray(tx), P)
    t_t, has_t = tog.compute_first_sample_start_of_occupied_regions(
        tcfg, tgrid, *(torch.from_numpy(a) for a in (o, d, te, tx)), P)
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-6, rtol=0)
    has = np.asarray(has_j)
    if kind in ("shell", "sparse"):
        assert 0 < has.sum() < has.size
    if kind == "empty":
        assert not has.any()
        np.testing.assert_array_equal(t_t.numpy(), tx[:, 0])


def _assert_trace_close(got, want, voxel, what, sdf_tol=True):
    """The flags agree but on rays whose |sdf| (either side's) lies within
    1e-5 of the threshold or the gate, at most 1% of them; the agreeing
    rays' positions (and sdf) to 1e-4."""
    pos_t, sdf_t, conv_t, alive_t = (x.numpy() if x is not None else None for x in got)
    pos_j, sdf_j, conv_j, alive_j = (np.asarray(x) for x in want)
    differ = (conv_t != conv_j) | (alive_t != alive_j)
    near = np.zeros_like(differ)
    for s in (sdf_j, sdf_t):
        if s is not None:
            a = np.abs(s)
            near |= (np.abs(a - THRESH) <= 1e-5) | (np.abs(s - voxel) <= 1e-5)
    assert not (differ & ~near).any(), (what, int((differ & ~near).sum()))
    assert differ.sum() <= 0.01 * differ.size, (what, int(differ.sum()))
    agree = ~differ
    np.testing.assert_allclose(pos_t[agree], pos_j[agree], atol=1e-4, rtol=0, err_msg=what)
    if sdf_tol and sdf_t is not None:
        np.testing.assert_allclose(sdf_t[agree], sdf_j[agree], atol=1e-4, rtol=0, err_msg=what)


@pytest.mark.parametrize("grid", ["none", "shell"])
@pytest.mark.parametrize("tracer", ["plain", "compacted"])
def test_plain_tracers_match_jax(grid, tracer):
    """``sphere_trace`` (15 iterations) and ``sphere_trace_compacted`` (3
    rounds of 5, the first bucket all rays, then halved) on the analytic
    sphere at sdf_multiplier 0.9, without a grid and with a shell grid
    (seeded by C3, the jumps gated on sdf > one voxel): a third to a half of
    the rays converge on the sphere, within 5e-4 of it."""
    o, d = _rays()
    jcfg, jgrid, tcfg, tgrid = _grids("shell")
    kw_j = dict(grid_cfg=jcfg, grid=jgrid) if grid == "shell" else {}
    kw_t = dict(grid_cfg=tcfg, grid=tgrid) if grid == "shell" else {}
    jsdf = lambda p: _jax_sphere_sdf({"radius": RADIUS}, p)  # noqa: E731
    tsdf = lambda p: _torch_sphere_sdf({"radius": torch.tensor(RADIUS)}, p)  # noqa: E731
    args_j = (jsdf, jnp.asarray(o), jnp.asarray(d), JSphere())
    args_t = (tsdf, torch.from_numpy(o), torch.from_numpy(d), TSphere())
    with jax.disable_jit():
        if tracer == "plain":
            want = jst.sphere_trace(*args_j, 15, 0.9, THRESH, **kw_j)
        else:
            want = jst.sphere_trace_compacted(*args_j, 3, 5, 0.9, THRESH, **kw_j,
                                              first_bucket_fraction=1.0)
    if tracer == "plain":
        got = tst.sphere_trace(*args_t, 15, 0.9, THRESH, **kw_t)
    else:
        got = tst.sphere_trace_compacted(*args_t, 3, 5, 0.9, THRESH, **kw_t,
                                         first_bucket_fraction=1.0)
    _assert_trace_close(got, want, 1.0 / V, (grid, tracer))
    conv = np.asarray(want[2]) & np.asarray(want[3])
    assert 0.3 < conv.mean() < 0.6, conv.mean()
    np.testing.assert_allclose(np.linalg.norm(got[0].numpy()[conv], axis=-1), RADIUS, atol=5e-4)


def test_rays_that_leave_the_sphere_die():
    """A ray dies when its position leaves the bound sphere (radius 0.5)
    unconverged, in both packages: the alive rays that have not converged
    are all inside the bound, the dead ones that met it are all outside,
    and rays that pass the 0.25 sphere die."""
    o, d = _rays()
    jsdf = lambda p: _jax_sphere_sdf({"radius": RADIUS}, p)  # noqa: E731
    tsdf = lambda p: _torch_sphere_sdf({"radius": torch.tensor(RADIUS)}, p)  # noqa: E731
    with jax.disable_jit():
        want = jst.sphere_trace(jsdf, jnp.asarray(o), jnp.asarray(d), JSphere(), 15, 0.9, THRESH)
    got = tst.sphere_trace(tsdf, torch.from_numpy(o), torch.from_numpy(d), TSphere(), 15, 0.9,
                           THRESH)
    alive, conv = np.asarray(want[3]), np.asarray(want[2])
    np.testing.assert_array_equal(got[3].numpy(), alive)
    np.testing.assert_array_equal(got[2].numpy(), conv)
    r = np.linalg.norm(got[0].numpy(), axis=-1)
    hit = np.asarray(JSphere().ray_intersection(jnp.asarray(o), jnp.asarray(d))[4])[:, 0]
    assert (r[alive & ~conv] < 0.5).all()
    died = hit & ~alive
    assert died.sum() > 50 and (r[died] >= 0.5).all()


def test_filter_unconverged_points_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    sdf = rng.uniform(-0.05, 0.05, (200, 1)).astype(np.float32)
    grads = rng.normal(size=(200, 3)).astype(np.float32)
    for g in (grads, None):
        want = jst.filter_unconverged_points(jnp.asarray(pts), jnp.asarray(sdf),
                                             None if g is None else jnp.asarray(g))
        got = tst.filter_unconverged_points(torch.from_numpy(pts), torch.from_numpy(sdf),
                                            None if g is None else torch.from_numpy(g))
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < float(got[2].sum()) < 200


@pytest.mark.parametrize("mult", [1.5, 2.0])
@pytest.mark.parametrize("tracer", ["plain", "compacted"])
def test_plain_tracers_on_a_phantom_positive_interior_match_jax(tracer, mult):
    """The adaptive tracer's phantom-positive case (a thin negative crust
    one voxel deep over an interior whose SDF is positive but half a voxel,
    a grid occupied only around the crust) through both packages' plain
    tracers, which gate their jumps on sdf > one voxel, not on
    ``jump_gate``; the port matches JAX. At the adaptive test's step
    multiplier 1.5 no ray reaches the interior: the C3 seed starts each
    ray within ~2 voxels of the crust, and the overshoot of a 1.5x step
    stays inside it. At 2.0 rays overshoot into the interior; there the
    SDF is at most half a voxel, so the gate never opens and no jump
    carries a ray through the unoccupied interior: the rays that reach it
    move by SDF steps of at most a voxel, and none converges there."""
    ctx = {"radius": RADIUS, "w": 1.0 / V, "inner": 0.5 / V}
    jcfg, jgrid, tcfg, tgrid = _grids("shell")
    o, d = _rays()
    jsdf = lambda p: _jax_crust_sdf({k: jnp.float32(v) for k, v in ctx.items()}, p)  # noqa: E731
    tsdf = lambda p: _torch_crust_sdf({k: torch.tensor(v) for k, v in ctx.items()}, p)  # noqa: E731
    args_j = (jsdf, jnp.asarray(o), jnp.asarray(d), JSphere())
    args_t = (tsdf, torch.from_numpy(o), torch.from_numpy(d), TSphere())
    with jax.disable_jit():
        if tracer == "plain":
            want = jst.sphere_trace(*args_j, 15, mult, 1e-5, grid_cfg=jcfg, grid=jgrid)
        else:
            want = jst.sphere_trace_compacted(*args_j, 3, 5, mult, 1e-5, grid_cfg=jcfg,
                                              grid=jgrid)
    if tracer == "plain":
        got = tst.sphere_trace(*args_t, 15, mult, 1e-5, grid_cfg=tcfg, grid=tgrid)
    else:
        got = tst.sphere_trace_compacted(*args_t, 3, 5, mult, 1e-5, grid_cfg=tcfg, grid=tgrid)
    _assert_trace_close(got, want, 1.0 / V, (tracer, mult))
    r = np.linalg.norm(np.asarray(want[0]), axis=-1)
    inner = np.asarray(want[3]) & (r < RADIUS - ctx["w"])
    if mult == 1.5:
        assert not inner.any()
        return
    assert inner.sum() > 10
    assert not (inner & np.asarray(want[2])).any()


def _setup_rays(width=32, height=32):
    o, d = jrays_from_frame(_K, _TF, width, height)
    return np.asarray(o), np.asarray(d)


def _grid_pair(kind):
    if kind == "none":
        return None, None
    occ = _plane_shell()[0]
    return (jog.OccupancyGridState(values=jnp.zeros(occ.size), occupancy=jnp.asarray(occ)),
            tog.OccupancyGridState(values=torch.zeros(occ.size),
                                   occupancy=torch.from_numpy(occ)))


def _assert_frames_close(got, want, what):
    """Weights equal on all but 1% of the rays; rgb and normals to 1e-4
    where both are lit (the SDF gradient and colour are MLP sums in another
    order, ~1e-7)."""
    w_t, w_j = got[2].numpy().reshape(-1), np.asarray(want[2]).reshape(-1)
    differ = w_t != w_j
    assert differ.sum() <= 0.01 * differ.size, (what, int(differ.sum()))
    both = (w_t > 0) & (w_j > 0)
    assert 0.2 < both.mean() < 0.8, what  # the plane crosses the frame
    for g, w in zip(got[:2], want[:2]):
        g, w = g.numpy().reshape(-1, 3), np.asarray(w).reshape(-1, 3)
        np.testing.assert_allclose(g[both], w[both], atol=1e-4, rtol=0, err_msg=what)
        assert not g[w_t == 0].any()


@pytest.mark.parametrize("renderer,grid", [("plain", "shell"), ("plain", "none"),
                                           ("compacted", "shell"), ("shade_hits", "none")])
def test_sphere_traced_ray_renderers_match_jax(setup, renderer, grid):  # noqa: F811
    """``render_rays_sphere_traced`` (with and without the grid),
    ``render_rays_sphere_traced_compacted`` (3 rounds, a first bucket of
    1/4 of the rays, smaller than the lit count: the overflow renders as
    background in both) and ``_shade_hits`` (the lit rays of the JAX trace)
    on the planted plane's 32x32 view."""
    cfg_j, cfg_t, pj, pt = setup
    o, d = _setup_rays()
    grid_j, grid_t = _grid_pair(grid)
    with jax.disable_jit():
        if renderer == "plain":
            want = jt.render_rays_sphere_traced(pj, grid_j, jnp.asarray(o), jnp.asarray(d), 20000,
                                                cfg_j)
        elif renderer == "compacted":
            want = jt.render_rays_sphere_traced_compacted(pj, grid_j, jnp.asarray(o),
                                                          jnp.asarray(d), 20000, cfg_j,
                                                          nr_rounds=3)
        else:
            pos, _, conv, alive = jst.sphere_trace(
                lambda p: jt.sdf_apply(pj["sdf"], p, 20000, cfg_j.sdf_model)[0],
                jnp.asarray(o), jnp.asarray(d), jt.BOUND, 15)
            lit = np.asarray(jt._lit_and_state(pos, conv, alive, None, None, cfg_j))
            want = jt._shade_hits(pj, pos, jnp.asarray(d), jnp.asarray(lit), 20000, cfg_j, 1024)
    to = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    if renderer == "plain":
        got = tt.render_rays_sphere_traced(pt, grid_t, to(o), to(d), 20000, cfg_t)
    elif renderer == "compacted":
        got = tt.render_rays_sphere_traced_compacted(pt, grid_t, to(o), to(d), 20000, cfg_t,
                                                     nr_rounds=3)
        lit_j = float(np.asarray(want[2]).sum())
        assert lit_j == 256  # the bucket overflowed: weights clamped to the shaded rays
    else:
        got = tt._shade_hits(pt, to(pos), to(d), to(lit), 20000, cfg_t, 1024)
    _assert_frames_close(got, want, (renderer, grid))


def test_render_image_sphere_traced_matches_jax(setup):  # noqa: F811
    """The chunked 32x24 frame (chunk 512: two chunks, the second padded)
    on the shell grid, against JAX's (numpy) frame; the port returns
    tensors on the device."""
    cfg_j, cfg_t, pj, pt = setup
    grid_j, grid_t = _grid_pair("shell")
    with jax.disable_jit():
        want = jt.render_image_sphere_traced(pj, grid_j, _K, _TF, 32, 24, 20000, cfg_j,
                                             chunk=512)
    got = tt.render_image_sphere_traced(pt, grid_t, _K, _TF, 32, 24, 20000, cfg_t, chunk=512,
                                        device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cpu"
    _assert_frames_close(got, want, "render_image_sphere_traced")


def test_render_image_sphere_traced_default_device_needs_cuda(setup, monkeypatch):  # noqa: F811
    _, cfg_t, _, pt = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        tt.render_image_sphere_traced(pt, None, _K, _TF, 8, 8, 20000, cfg_t)


def test_plain_grid_helpers_match_jax():
    """The plain-only helpers: random voxel samples on replayed draws,
    ``mip_config``, ``downsample_occupancy`` and
    ``advance_sample_to_next_occupied_voxel`` (found, not found, leaving the
    grid)."""
    jcfg, jgrid, tcfg, tgrid = _grids("sparse", V=16)
    key = jax.random.PRNGKey(4)
    c_j, lin_j = jog.compute_random_sample_of_grid_points(jcfg, key, 300)
    k_idx, k_jit = jax.random.split(key)
    draws = (torch.from_numpy(np.array(jax.random.randint(k_idx, (300,), 0, jcfg.nr_voxels))),
             torch.from_numpy(np.array(jax.random.uniform(k_jit, (300, 3), minval=-0.5,
                                                          maxval=0.5))))
    c_t, lin_t = tog.compute_random_sample_of_grid_points(tcfg, 300, draws=draws)
    np.testing.assert_array_equal(lin_t.numpy(), np.asarray(lin_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)
    assert tog.mip_config(tcfg, 4).nr_voxels_per_dim == jog.mip_config(jcfg, 4).nr_voxels_per_dim
    for f in (2, 4):
        np.testing.assert_array_equal(
            tog.downsample_occupancy(tcfg, tgrid.occupancy, f).numpy(),
            np.asarray(jog.downsample_occupancy(jcfg, jgrid.occupancy, f)))
    o, d = _bound_rays(300, seed=5)
    pos = o * 0.45 / 1.2
    want = jog.advance_sample_to_next_occupied_voxel(jcfg, jgrid, jnp.asarray(d), jnp.asarray(pos))
    got = tog.advance_sample_to_next_occupied_voxel(tcfg, tgrid, torch.from_numpy(d),
                                                    torch.from_numpy(pos))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert 0 < np.asarray(want[1]).sum() < 300
