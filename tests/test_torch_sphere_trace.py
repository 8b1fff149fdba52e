"""Port parity of the sphere tracer's pieces on the CPU: the Chebyshev
distance field (kernel J0's plain version), the field lookup, the
fixed-size compaction (kernel H0's plain version), the jump prepass (J1)
and ``sphere_trace_adaptive`` (rounds of H0, the SDF and J2), each against
the JAX package's function on the same numpy inputs.

The tracer tests pass the same analytic SDF to both packages, written out
operation by operation, and run JAX eagerly (``jax.disable_jit``): under
``jit`` XLA contracts ``o + t d`` into a fused multiply-add, and a ray
whose position moves by a rounding can cross a voxel face or the
convergence threshold. Eager, the two packages do the same float
operations, so the masks and the per-round counts must be equal and the
positions agree to 1e-5 (the bound intersection's sums may round apart).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.ops import sphere_trace as jst
from permuto_sdf_tpu.ops.ray_primitives import Sphere as JSphere
from permuto_sdf_tpu_torch.ops import compaction
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops import sphere_trace as tst
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere as TSphere

RADIUS = 0.25


def _occupancy(kind, V, seed=0):
    rng = np.random.default_rng(seed)
    xs = (np.arange(V, dtype=np.float32) + 0.5) / V - 0.5
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    return {"sparse": lambda: rng.uniform(size=V ** 3) < 0.002,
            "shell": lambda: (np.abs(r - RADIUS) < 2.0 / V).reshape(-1),
            "empty": lambda: np.zeros(V ** 3, bool),
            "full": lambda: np.ones(V ** 3, bool)}[kind]()


@pytest.mark.parametrize("V", [16, 32])
@pytest.mark.parametrize("cap", [15, 63])
@pytest.mark.parametrize("kind", ["sparse", "shell", "empty", "full"])
def test_chebyshev_empty_distance_matches_jax(V, cap, kind):
    """Kernel J0's plain version equals JAX's field exactly (the JAX op's
    int32 values, stored as uint8)."""
    occ = _occupancy(kind, V, seed=V + cap)
    want = np.asarray(jog.chebyshev_empty_distance(
        jog.OccupancyGridConfig(nr_voxels_per_dim=V), jnp.asarray(occ), cap))
    got = tog.chebyshev_empty_distance(tog.OccupancyGridConfig(nr_voxels_per_dim=V),
                                       torch.from_numpy(occ), cap)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    if kind == "sparse":
        assert 1 < want.max() and want.min() == 0  # distances of several values


def test_empty_distance_at_matches_jax():
    V = 16
    occ = _occupancy("sparse", V, seed=3)
    field = np.asarray(jog.chebyshev_empty_distance(
        jog.OccupancyGridConfig(nr_voxels_per_dim=V), jnp.asarray(occ), 15))
    pts = np.random.default_rng(4).uniform(-0.7, 0.7, (500, 3)).astype(np.float32)
    want = np.asarray(jog.empty_distance_at(jog.OccupancyGridConfig(nr_voxels_per_dim=V),
                                            jnp.asarray(field), jnp.asarray(pts), 15))
    got = tog.empty_distance_at(tog.OccupancyGridConfig(nr_voxels_per_dim=V),
                                torch.from_numpy(field.astype(np.uint8)),
                                torch.from_numpy(pts), 15)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 15).mean() > 0.3  # out-of-grid points read max_dist


@pytest.mark.parametrize("size", [40, 137, 600])
def test_nonzero_static_matches_jax(size):
    """Kernel H0's plain version equals jnp.nonzero(size=, fill_value=) with
    the bucket below, at and above the true count (137)."""
    rng = np.random.default_rng(1)
    mask = np.zeros(1000, bool)
    mask[rng.choice(1000, 137, replace=False)] = True
    (want,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=1000)
    idx, count = compaction.nonzero_static(torch.from_numpy(mask), size)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert int(count) == 137


def test_slice_entry_points_refuse_other_devices():
    """The field, the compaction and the tracer's kernels pick the kernel on
    cuda, the plain version on cpu, and raise on any other device."""
    cfg = tog.OccupancyGridConfig(nr_voxels_per_dim=8)
    with pytest.raises(ValueError, match="unsupported device"):
        compaction.nonzero_static(torch.zeros(16, dtype=torch.bool, device="meta"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tog.chebyshev_empty_distance(cfg, torch.zeros(512, dtype=torch.bool, device="meta"), 15)
    t = torch.zeros(5, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tst._jump_prepass_impl(None, None, None, None, t, None, cfg, 1)


def _rays(n=512):
    ang = np.linspace(-0.45, 0.45, n).astype(np.float32)
    dirs = np.stack([np.sin(ang), np.zeros(n, np.float32), np.cos(ang)], -1)
    origins = np.tile(np.array([[0.0, 0.0, -1.2]], np.float32), (n, 1))
    return origins, dirs.astype(np.float32)


def _jax_sphere_sdf(ctx, p):
    return jnp.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]) - ctx["radius"]


def _torch_sphere_sdf(ctx, p):
    return torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]) - ctx["radius"]


def _jax_crust_sdf(ctx, p):
    """Positive outside |p| = r, negative in a crust of width w below it,
    and a phantom-positive interior no larger than half a voxel."""
    r = jnp.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2])
    return jnp.maximum(r - ctx["radius"], jnp.minimum(ctx["inner"], (ctx["radius"] - ctx["w"]) - r))


def _torch_crust_sdf(ctx, p):
    r = torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2])
    return torch.maximum(r - ctx["radius"],
                         torch.minimum(ctx["inner"], (ctx["radius"] - ctx["w"]) - r))


def _trace_both(jax_sdf, torch_sdf, ctx, V=32, grid=True, refine_ctx=None, **kw):
    o, d = _rays()
    occ = _occupancy("shell", V)
    jcfg, tcfg = (m.OccupancyGridConfig(nr_voxels_per_dim=V) for m in (jog, tog))
    jgrid = jog.OccupancyGridState(values=jnp.zeros(V ** 3), occupancy=jnp.asarray(occ))
    tgrid = tog.OccupancyGridState(values=torch.zeros(V ** 3), occupancy=torch.from_numpy(occ))
    jctx = {k: jnp.float32(v) for k, v in ctx.items()}
    tctx = {k: torch.tensor(v, dtype=torch.float32) for k, v in ctx.items()}
    jref = tref = None
    if refine_ctx is not None:
        jref = {k: jnp.float32(v) for k, v in refine_ctx.items()}
        tref = {k: torch.tensor(v, dtype=torch.float32) for k, v in refine_ctx.items()}
    stats_j, stats_t = [], []
    common = dict(nr_rounds=5, iters_per_round=3, min_bucket=64, return_n_hit=True, **kw)
    with jax.disable_jit():
        want = jst.sphere_trace_adaptive(
            jax_sdf, jctx, jnp.asarray(o), jnp.asarray(d), JSphere(),
            grid_cfg=jcfg if grid else None, grid=jgrid if grid else None,
            refine_sdf_eval=jax_sdf if jref else None, refine_ctx=jref, stats_out=stats_j,
            **common)
    got = tst.sphere_trace_adaptive(
        torch_sdf, tctx, torch.from_numpy(o), torch.from_numpy(d), TSphere(),
        grid_cfg=tcfg if grid else None, grid=tgrid if grid else None,
        refine_sdf_eval=torch_sdf if tref else None, refine_ctx=tref, stats_out=stats_t,
        **common)
    return want, got, stats_j, stats_t


def _assert_same_trace(want, got, stats_j, stats_t):
    pos_j, sdf_j, conv_j, alive_j, n_j = want
    pos_t, sdf_t, conv_t, alive_t, n_t = got
    assert stats_t == stats_j
    assert n_t == n_j
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
    np.testing.assert_array_equal(alive_t.numpy(), np.asarray(alive_j))
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sdf_t.numpy(), np.asarray(sdf_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("grid,jump_substeps,prepass_jumps,refine", [
    (False, 1, 0, False), (False, 1, 0, True),
    (True, 1, 0, False), (True, 1, 0, True), (True, 1, 16, False), (True, 1, 16, True),
    (True, 4, 0, False), (True, 4, 0, True), (True, 4, 16, False), (True, 4, 16, True)])
def test_sphere_trace_adaptive_matches_jax(grid, jump_substeps, prepass_jumps, refine):
    """The analytic sphere (a 2% larger radius for the march when the refine
    stage takes the true one), with and without the grid's jumps."""
    ctx = {"radius": RADIUS * (1.02 if refine else 1.0)}
    want, got, stats_j, stats_t = _trace_both(
        _jax_sphere_sdf, _torch_sphere_sdf, ctx, grid=grid,
        refine_ctx={"radius": RADIUS} if refine else None,
        jump_substeps=jump_substeps, prepass_jumps=prepass_jumps)
    _assert_same_trace(want, got, stats_j, stats_t)
    conv = got[2].numpy()
    assert 0.15 < conv.mean() < 0.6  # about 47% of the rays meet the sphere
    r = np.linalg.norm(got[0].numpy()[conv], axis=-1)
    np.testing.assert_allclose(r, RADIUS, atol=5e-4)
    if refine:
        assert stats_t[-1][0] == "refine"


def test_jump_gate_matches_jax_on_a_phantom_positive_interior():
    """A thin negative crust over an interior whose SDF is positive but
    below half a voxel, and a grid occupied only around the crust. Steps of
    1.5x the SDF overshoot into the interior; there, with the gate off
    (jump_gate_voxels=0) the jumps fire and carry rays through the
    unoccupied interior, with the gate on (1 voxel) they do not. The port
    matches JAX in both cases, and the two cases differ."""
    V = 32
    ctx = {"radius": RADIUS, "w": 1.0 / V, "inner": 0.5 / V}
    runs = {}
    for gate in (0.0, 1.0):
        want, got, stats_j, stats_t = _trace_both(
            _jax_crust_sdf, _torch_crust_sdf, ctx, V=V, sdf_multiplier=1.5,
            sdf_converged_tresh=1e-5, jump_substeps=4, prepass_jumps=16,
            jump_gate_voxels=gate)
        _assert_same_trace(want, got, stats_j, stats_t)
        runs[gate] = got
    moved = np.abs(runs[0.0][0].numpy() - runs[1.0][0].numpy()).max(axis=1) > 1e-4
    assert moved.sum() > 50
    assert runs[0.0][2].numpy().sum() > runs[1.0][2].numpy().sum()


def test_jump_prepass_matches_jax():
    """Kernel J1's plain version against ``_jump_prepass_impl``: t, the alive
    flags (rays that jump past the bound die) and the alive count."""
    V = 32
    o, d = _rays()
    occ = _occupancy("shell", V)
    jcfg = jog.OccupancyGridConfig(nr_voxels_per_dim=V)
    field = jog.chebyshev_empty_distance(jcfg, jnp.asarray(occ), 63)
    _, te, _, tx, hit = JSphere().ray_intersection(jnp.asarray(o), jnp.asarray(d))
    pad = lambda x, fill=0.0: np.concatenate([np.asarray(x), np.full((1,) + x.shape[1:], fill,  # noqa: E731
                                                                     np.asarray(x).dtype)])
    args = (pad(o), pad(d), pad(tx[:, 0]), pad(te[:, 0]), pad(hit[:, 0], False))
    with jax.disable_jit():
        t_j, alive_j, n_j = jst._jump_prepass_impl(field, *map(jnp.asarray, args), jcfg, 16)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    t_t, alive_t, n_t, _ = tst._jump_prepass_impl(
        torch.from_numpy(np.asarray(field).astype(np.uint8)), *targs,
        tog.OccupancyGridConfig(nr_voxels_per_dim=V), 16)
    np.testing.assert_array_equal(alive_t.numpy(), np.asarray(alive_j))
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    assert int(n_t) == int(n_j)
    assert 0 < int(n_j) < int(np.asarray(hit).sum())  # misses died in the prepass
