"""Port parity: samplers and volume rendering of ``permuto_sdf_tpu_torch``
against the JAX package's, on the CPU (the port runs the plain versions of
kernels C and D there). Inputs come from a numpy seed.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.datasets import tensor_reel as jreel
from permuto_sdf_tpu.ops import importance_sampling as jis
from permuto_sdf_tpu.ops import occupancy_grid as jog
from permuto_sdf_tpu.ops import ray_sampler as jrs
from permuto_sdf_tpu.ops import volume_rendering as jvr
from permuto_sdf_tpu.ops.ray_primitives import Sphere as JSphere
from permuto_sdf_tpu.ops.ray_samples import RaySamples as JRaySamples
from permuto_sdf_tpu_torch.datasets import tensor_reel as treel
from permuto_sdf_tpu_torch.ops import importance_sampling as tis
from permuto_sdf_tpu_torch.ops import occupancy_grid as tog
from permuto_sdf_tpu_torch.ops import ray_sampler as trs
from permuto_sdf_tpu_torch.ops import volume_rendering as tvr
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere as TSphere
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples as TRaySamples


def _rays(n, seed=0, miss_frac=0.2):
    """Rays from a shell around the bound toward points inside it; a
    fraction runs perpendicular to its origin's radius, passing the center
    at >= 0.8 > r, so it misses the sphere."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * rng.uniform(0.8, 1.5, (n, 1))
    tgt = rng.uniform(-0.35, 0.35, (n, 3))
    d = tgt - o
    n_miss = int(n * miss_frac)
    d[:n_miss] = np.cross(o[:n_miss], rng.normal(size=(n_miss, 3)))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def test_ray_intersection_matches_jax():
    o, d = _rays(200)
    (oj, dj), (ot, dt) = _both(o, d)
    outs_j = JSphere(0.5, (0.0, 0.0, 0.0)).ray_intersection(oj, dj)
    outs_t = TSphere(0.5, (0.0, 0.0, 0.0)).ray_intersection(ot, dt)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    hit = outs_t[4][:, 0].numpy()
    assert (~hit).sum() >= 40  # misses present: t_entry = t_exit = 0 there
    assert np.all(outs_t[1].numpy()[~hit] == 0) and np.all(outs_t[3].numpy()[~hit] == 0)


@pytest.mark.parametrize("S,P,min_dist,occ_frac", [(64, 512, 1e-4, 0.25), (16, 64, 0.02, 0.4)])
def test_probe_sampler_matches_jax(S, P, min_dist, occ_frac):
    """Kernel C's plain version vs compute_samples_in_occupied_regions on a
    random sparse 16^3 grid. The sample counts (mask) must match exactly.
    The port forms the cumulative occupied length as count * seg_len with
    one rounding, JAX as an f32 cumsum of occ * seg_len, so a sample that
    lands on a probe boundary next to an unoccupied gap may jump the gap:
    at most 1% of the valid samples may differ by more than 1e-5."""
    rng = np.random.default_rng(1)
    cfg_j, cfg_t = jog.OccupancyGridConfig(16), tog.OccupancyGridConfig(16)
    occ = rng.uniform(size=16 ** 3) < occ_frac
    o, d = _rays(256, seed=2)
    (oj, dj), (ot, dt_) = _both(o, d)
    _, te_j, _, tx_j, _ = JSphere().ray_intersection(oj, dj)
    _, te_t, _, tx_t, _ = TSphere().ray_intersection(ot, dt_)
    grid_j = jog.OccupancyGridState(values=jnp.zeros(16 ** 3), occupancy=jnp.asarray(occ))
    grid_t = tog.OccupancyGridState(values=torch.zeros(16 ** 3), occupancy=torch.from_numpy(occ))
    sj = jog.compute_samples_in_occupied_regions(cfg_j, grid_j, oj, dj, te_j, tx_j, min_dist, S,
                                                 nr_probes=P)
    st = tog.compute_samples_in_occupied_regions(cfg_t, grid_t, ot, dt_, te_t, tx_t, min_dist, S,
                                                 nr_probes=P)
    mask = np.asarray(sj.mask)
    np.testing.assert_array_equal(st.mask.numpy(), mask)
    assert mask.sum() > 500
    np.testing.assert_allclose(st.ray_fixed_dt.numpy(), np.asarray(sj.ray_fixed_dt), atol=1e-7)
    dz = np.abs(st.z.numpy() - np.asarray(sj.z))[mask]
    ddt = np.abs(st.dt.numpy() - np.asarray(sj.dt))[mask]
    n_far = int(np.sum((dz > 1e-5) | (ddt > 1e-5)))
    print(f"probe sampler: {n_far} of {mask.sum()} valid samples differ by > 1e-5")
    assert n_far <= 0.01 * mask.sum()


def _random_samples(R, S, seed):
    rng = np.random.default_rng(seed)
    nr = rng.integers(0, S + 1, R)
    nr[:3] = (0, 1, S)
    mask = np.arange(S)[None, :] < nr[:, None]
    z = np.sort(rng.uniform(0.2, 1.6, (R, S)), axis=-1).astype(np.float32)
    dt = rng.uniform(1e-3, 2e-2, (R, S)).astype(np.float32) * mask
    dirs = rng.normal(size=(R, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    origins = rng.normal(size=(R, 3)).astype(np.float32)
    fixed = rng.uniform(1e-3, 1e-2, R).astype(np.float32) * (nr > 0)
    arrays = dict(origins=origins, dirs=dirs, z=z * mask, dt=dt, mask=mask, ray_fixed_dt=fixed)
    sj = JRaySamples(**{k: jnp.asarray(v) for k, v in arrays.items()})
    st = TRaySamples(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})
    return sj, st, rng


def test_neus_weights_and_integrals_match_jax():
    """Kernel D's plain version (NeuS mode) vs neus_compute_weights +
    integrate_with_weights, at inv_s = exp(8) and cos_anneal_ratio 0.6.
    Tolerance 2e-5: float32 sigmoid/cumprod rounding, amplified ~inv_s
    where alpha is formed from a difference of two sigmoids."""
    R, S = 96, 40
    sj, st, rng = _random_samples(R, S, seed=3)
    sdf = rng.uniform(-0.02, 0.05, (R, S)).astype(np.float32)
    grads = rng.normal(size=(R * S, 3)).astype(np.float32)
    rgb = rng.uniform(size=(R * S, 3)).astype(np.float32)
    inv_s = float(np.exp(np.float32(8.0)).astype(np.float32))
    w_j, ws_j, bg_j = jvr.neus_compute_weights(sj, jnp.asarray(sdf), jnp.asarray(grads), inv_s, 0.6)
    rgb_j = jvr.integrate_with_weights(jnp.asarray(rgb).reshape(R, S, 3), w_j, sj.mask)
    g_j = jvr.integrate_with_weights(jnp.asarray(grads).reshape(R, S, 3), w_j, sj.mask)
    got = tvr.neus_render(st, torch.from_numpy(sdf), torch.from_numpy(grads),
                          torch.from_numpy(rgb), inv_s, 0.6)
    for a, b in zip((w_j, ws_j, bg_j, rgb_j, g_j), got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5, rtol=0)


def test_nerf_weights_and_integral_match_jax():
    """Kernel D's plain version (NeRF mode) on background samples."""
    R, S = 96, 32
    o, d = _rays(R, seed=4, miss_frac=0.0)
    (oj, dj), (ot, dt_) = _both(o, d)
    _, _, _, tx_j, _ = JSphere().ray_intersection(oj, dj)
    _, _, _, tx_t, _ = TSphere().ray_intersection(ot, dt_)
    bj = jrs.compute_samples_bg(oj, dj, tx_j, S, 0.5, (0.0, 0.0, 0.0))
    bt = trs.compute_samples_bg(ot, dt_, tx_t, S, 0.5, (0.0, 0.0, 0.0))
    rng = np.random.default_rng(5)
    dens = rng.uniform(0, 3, (R, S)).astype(np.float32)
    rgb = rng.uniform(size=(R * S, 3)).astype(np.float32)
    w_j, ws_j, bg_j = jvr.nerf_compute_weights(bj, jnp.asarray(dens))
    rgb_j = jvr.integrate_with_weights(jnp.asarray(rgb).reshape(R, S, 3), w_j, bj.mask)
    got = tvr.nerf_render(bt, torch.from_numpy(dens), torch.from_numpy(rgb))
    for a, b in zip((w_j, ws_j, bg_j, rgb_j), got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5, rtol=0)


def test_compute_samples_bg_matches_jax():
    o, d = _rays(128, seed=6, miss_frac=0.0)
    (oj, dj), (ot, dt_) = _both(o, d)
    _, _, _, tx_j, _ = JSphere().ray_intersection(oj, dj)
    _, _, _, tx_t, _ = TSphere().ray_intersection(ot, dt_)
    bj = jrs.compute_samples_bg(oj, dj, tx_j, 32, 0.5, (0.0, 0.0, 0.0))
    bt = trs.compute_samples_bg(ot, dt_, tx_t, 32, 0.5, (0.0, 0.0, 0.0))
    np.testing.assert_allclose(bt.z.numpy(), np.asarray(bj.z), rtol=1e-6)
    np.testing.assert_allclose(bt.pos_4d.numpy(), np.asarray(bj.pos_4d), atol=1e-6)
    np.testing.assert_allclose(bt.dt.numpy(), np.asarray(bj.dt), rtol=1e-5)
    np.testing.assert_array_equal(bt.mask.numpy(), np.asarray(bj.mask))


def test_importance_stage_matches_jax():
    """Two-round SDF-guided importance sampling (eval branch: masked, no
    carried sdf, no jitter) on uniform samples from the probe sampler, with
    an analytic sphere SDF of radius 0.3 on both sides. Tolerance 1e-5 on
    z and dt (float32 CDF inversion)."""
    cfg_j, cfg_t = jog.OccupancyGridConfig(16), tog.OccupancyGridConfig(16)
    o, d = _rays(128, seed=7, miss_frac=0.1)
    (oj, dj), (ot, dt_) = _both(o, d)
    _, te_j, _, tx_j, _ = JSphere().ray_intersection(oj, dj)
    _, te_t, _, tx_t, _ = TSphere().ray_intersection(ot, dt_)
    uj = jog.compute_samples_in_occupied_regions(cfg_j, jog.make_occupancy_grid(cfg_j), oj, dj,
                                                 te_j, tx_j, 1e-4, 24)
    ut = tog.compute_samples_in_occupied_regions(cfg_t, tog.make_occupancy_grid(cfg_t), ot, dt_,
                                                 te_t, tx_t, 1e-4, 24)
    sphere_j = lambda p, _m: jnp.linalg.norm(p, axis=-1) - 0.3  # noqa: E731
    sphere_t = lambda p, _m: torch.linalg.norm(p, dim=-1) - 0.3  # noqa: E731
    rj = jis.importance_sampling_sdf_model(sphere_j, uj, tx_j, jax.random.PRNGKey(0), 8,
                                           jitter=False, masked=True)
    rt = tis.importance_sampling_sdf_model(sphere_t, ut, tx_t, 8)
    assert rt.sdf is None and rj.sdf is None
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), atol=1e-5)
    np.testing.assert_allclose(rt.dt.numpy(), np.asarray(rj.dt), atol=1e-5)


def test_rays_from_frame_matches_jax():
    K = np.array([[30.0, 0, 8.5], [0, 31.0, 6.2], [0, 0, 1]], np.float32)
    tf = jreel.look_at_cam_to_world((0.4, 0.5, 1.3))
    np.testing.assert_allclose(treel.look_at_cam_to_world((0.4, 0.5, 1.3)), tf)
    oj, dj = jreel.rays_from_frame(K, tf.astype(np.float32), 17, 12)
    ot, dt_ = treel.rays_from_frame(K, tf.astype(np.float32), 17, 12)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), atol=1e-6)


def test_variance_inv_s_matches_jax():
    v = jvr.init_variance(0.3)
    assert tvr.variance_inv_s(tvr.init_variance(0.3, "cpu")) == pytest.approx(
        float(jvr.variance_inv_s(v)), rel=1e-6)
    assert tvr.variance_inv_s(None, 0.8) == pytest.approx(
        float(jvr.variance_inv_s(v, jnp.float32(0.8))), rel=1e-6)


def test_combine_keeps_stable_order_on_ties():
    """Equal z from both sets merge in input order (jnp.argsort is stable)."""
    R = 4
    z = np.tile(np.array([[0.1, 0.2, 0.3]], np.float32), (R, 1))
    arrays = dict(origins=np.zeros((R, 3), np.float32), dirs=np.ones((R, 3), np.float32),
                  z=z, dt=np.zeros_like(z), mask=np.ones_like(z, bool),
                  ray_fixed_dt=np.full(R, 0.05, np.float32))
    sdf_a = np.zeros_like(z)
    sdf_b = np.ones_like(z)
    tj = jnp.asarray(np.full(R, 0.5, np.float32))
    aj = JRaySamples(**{k: jnp.asarray(v) for k, v in arrays.items()}, sdf=jnp.asarray(sdf_a))
    bj = dataclasses.replace(aj, sdf=jnp.asarray(sdf_b))
    at = TRaySamples(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                     sdf=torch.from_numpy(sdf_a))
    bt = dataclasses.replace(at, sdf=torch.from_numpy(sdf_b))
    cj = jvr.combine_uniform_samples_with_imp(aj, bj, tj)
    ct = tvr.combine_uniform_samples_with_imp(at, bt, torch.from_numpy(np.asarray(tj)))
    np.testing.assert_array_equal(ct.sdf.numpy(), np.asarray(cj.sdf))
    np.testing.assert_allclose(ct.dt.numpy(), np.asarray(cj.dt), atol=1e-7)


@pytest.mark.parametrize("mode", ["neus", "nerf"])
def test_render_weights_backward_matches_jax_vjp(mode):
    """The backward of kernel D (kernel D''s plain version: autograd of the
    plain forward) against jax.vjp of the JAX weight functions with
    integration, with random cotangents on every output. Tolerance 1e-4 of
    each gradient's largest |value| (float32; the transmittance chain's
    gradient is a sum over the ray)."""
    R, S = 64, 40
    sj, st, rng = _random_samples(R, S, seed=8)
    rgb = rng.uniform(size=(R * S, 3)).astype(np.float32)
    if mode == "neus":
        val = rng.uniform(-0.02, 0.05, (R, S)).astype(np.float32)
        grads = rng.normal(size=(R * S, 3)).astype(np.float32)
        inv_s = float(np.exp(np.float32(5.0)))

        def f(v, g, c):
            w, ws, bg = jvr.neus_compute_weights(sj, v, g, inv_s, 0.6)
            return (w, ws, bg, jvr.integrate_with_weights(c.reshape(R, S, 3), w, sj.mask),
                    jvr.integrate_with_weights(g.reshape(R, S, 3), w, sj.mask))

        args = (val, grads, rgb)
    else:
        val = rng.uniform(0, 30, (R, S)).astype(np.float32)

        def f(v, c):
            w, ws, bg = jvr.nerf_compute_weights(sj, v)
            return w, ws, bg, jvr.integrate_with_weights(c.reshape(R, S, 3), w, sj.mask)

        args = (val, rgb)
    outs, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs]
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    if mode == "neus":
        got_outs = tvr.neus_render(st, ins[0], ins[1], ins[2], inv_s, 0.6)
    else:
        got_outs = tvr.nerf_render(st, ins[0], ins[1])
    got = torch.autograd.grad(got_outs, ins, [torch.from_numpy(c) for c in cots])
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(), rtol=0)


def test_jittered_samplers_match_jax():
    """The occupancy sampler with a per-ray start, the background sampler
    with its jitter and the importance stage with its two rounds' offsets,
    all drawn by jax.random and passed to the port."""
    cfg_j, cfg_t = jog.OccupancyGridConfig(16), tog.OccupancyGridConfig(16)
    o, d = _rays(128, seed=9, miss_frac=0.1)
    (oj, dj), (ot, dt_) = _both(o, d)
    _, te_j, _, tx_j, _ = JSphere().ray_intersection(oj, dj)
    _, te_t, _, tx_t, _ = TSphere().ray_intersection(ot, dt_)
    key = jax.random.PRNGKey(4)
    k_uni, k_imp, k_bg = jax.random.split(key, 3)
    start = jax.random.uniform(k_uni, (128, 1))
    uj = jog.compute_samples_in_occupied_regions(cfg_j, jog.make_occupancy_grid(cfg_j), oj, dj,
                                                 te_j, tx_j, 1e-4, 24, key=k_uni, jitter=True)
    ut = tog.compute_samples_in_occupied_regions(cfg_t, tog.make_occupancy_grid(cfg_t), ot, dt_,
                                                 te_t, tx_t, 1e-4, 24,
                                                 start=torch.from_numpy(np.array(start)))
    np.testing.assert_array_equal(ut.mask.numpy(), np.asarray(uj.mask))
    np.testing.assert_allclose(ut.z.numpy(), np.asarray(uj.z), atol=1e-5)
    sphere_j = lambda p, _m: jnp.linalg.norm(p, axis=-1) - 0.3  # noqa: E731
    sphere_t = lambda p, _m: torch.linalg.norm(p, dim=-1) - 0.3  # noqa: E731
    rj = jis.importance_sampling_sdf_model(sphere_j, uj, tx_j, k_imp, 8, jitter=True, masked=True)
    k1, k2 = jax.random.split(k_imp)
    mov = 1.0 / 9 / 2.0
    jit = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (128, 8), minval=-mov,
                                                             maxval=mov))) for k in (k1, k2))
    rt = tis.importance_sampling_sdf_model(sphere_t, ut, tx_t, 8, jitter=jit)
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), atol=1e-5)
    bj = jrs.compute_samples_bg(oj, dj, tx_j, 32, 0.5, (0.0, 0.0, 0.0), key=k_bg, jitter=True)
    rand = torch.from_numpy(np.array(jax.random.uniform(k_bg, (128, 32))))
    bt = trs.compute_samples_bg(ot, dt_, tx_t, 32, 0.5, (0.0, 0.0, 0.0), rand=rand)
    np.testing.assert_allclose(bt.z.numpy(), np.asarray(bj.z), rtol=1e-6)
    np.testing.assert_allclose(bt.pos_4d.numpy(), np.asarray(bj.pos_4d), atol=1e-6)
