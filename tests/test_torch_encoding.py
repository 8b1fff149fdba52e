"""Port parity: the permutohedral encoding of ``permuto_sdf_tpu_torch``
against the JAX package's, on the CPU (the port runs the plain PyTorch
versions of kernels A and B there).

Inputs come from a numpy seed; both packages get the same tables and
shifts. Points whose simplex fp noise could legitimately flip (near a
rounding or rank tie, ``_is_ambiguous``, copied from test_encoding.py) are
left out of the comparisons: both choices are valid there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from permuto_sdf_tpu.ops import permuto_encoding as jpe
from permuto_sdf_tpu_torch.ops import permuto_encoding as tpe


def _is_ambiguous(point, d, tol=1e-3):
    """True when fp noise could legitimately flip the simplex choice."""
    E = jpe._elevation_matrix(d).astype(np.float64)
    elevated = E @ point
    v = elevated / (d + 1)
    if np.any(np.abs(v - np.floor(v) - 0.5) < tol):
        return True
    rem0 = np.where(
        np.ceil(v) * (d + 1) - elevated < elevated - np.floor(v) * (d + 1),
        np.ceil(v) * (d + 1),
        np.floor(v) * (d + 1),
    )
    diff = elevated - rem0
    pair = np.abs(diff[:, None] - diff[None, :])
    return bool(np.any(pair[np.triu_indices(d + 1, 1)] < tol))


def _setup(d, capacity=2 ** 10, nr_levels=4, n=300, seed=0, table_scale=1e4,
           scaling=1.0):
    """Same encoding params for both packages (tables scaled up from the
    init's 1e-4 so feature errors are measured at magnitude ~1)."""
    rng = np.random.default_rng(seed)
    spec_j = jpe.PermutoEncodingSpec(pos_dim=d, capacity=capacity, nr_levels=nr_levels,
                                     concat_points_scaling=scaling)
    spec_t = tpe.PermutoEncodingSpec(pos_dim=d, capacity=capacity, nr_levels=nr_levels,
                                     concat_points_scaling=scaling)
    table = rng.uniform(-1e-4, 1e-4, (nr_levels, 2, capacity)).astype(np.float32) * table_scale
    shift = (rng.normal(size=(nr_levels, d)) * 10).astype(np.float32)
    pts = rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32)
    params_j = {"lattice_values": jnp.asarray(table), "shift_per_level": jnp.asarray(shift)}
    params_t = {"lattice_values": torch.from_numpy(table), "shift_per_level": torch.from_numpy(shift)}
    return spec_j, spec_t, params_j, params_t, pts


def _feature_tol(pts, shift, spec, K, table_max):
    """Per-column tolerance of the encode output: the elevated lattice
    coordinates reach |e| ~ 2e4 at the finest level (sigma = 1e-4), where
    a float32 ulp is ~2e-3, and the two packages sum E @ p in different
    orders. Barycentric weights then differ by up to ~2 d ulp(|e|), and a
    feature by up to 4 d ulp(|e|) max|table|. Point columns: exact up to
    one rounding."""
    d = pts.shape[1]
    E = jpe._elevation_matrix(d).astype(np.float64)
    scales = spec.scales.astype(np.float32)
    tol = []
    for l in range(K):
        lat = (pts / scales[l] + shift[l]).astype(np.float64)
        emax = np.abs(lat @ E.T).max()
        tol += [4 * d * float(np.spacing(np.float32(emax))) * table_max + 1e-7] * 2
    return np.asarray(tol + [1e-7] * (d if spec.concat_points else 0))


def _ambiguous_mask(pts, shift, spec, K):
    """[K, N] bool: (level, point) pairs near a simplex tie."""
    scales = spec.scales.astype(np.float32)
    out = np.zeros((K, pts.shape[0]), bool)
    for l in range(K):
        lat = pts / scales[l] + shift[l]
        out[l] = [_is_ambiguous(p.astype(np.float64), pts.shape[1]) for p in lat]
    return out


def _jax_slot_ids(pts, shift, spec, L):
    """[L, N, d+1] hash slots of each point's simplex vertices, the JAX way."""
    d = pts.shape[1]
    scales = jnp.asarray(spec.scales, dtype=jnp.float32)
    pts_lat = jnp.asarray(pts).T[None] / scales[:L, None, None] + jnp.asarray(shift)[:L, :, None]
    keys, _ = jpe._simplex_nminor(pts_lat, d)
    k = keys.astype(jnp.uint32)
    h = k[:, :, 0, :] * jnp.uint32(jpe._HASH_PRIMES[0])
    for i in range(1, d):
        h = h ^ (k[:, :, i, :] * jnp.uint32(jpe._HASH_PRIMES[i]))
    return np.asarray(h & jnp.uint32(spec.capacity - 1)).astype(np.int64).transpose(0, 2, 1)


def _port_slot_ids(pts, table, shift, spec, L):
    """[L, N, d+1] hash slots of each point's simplex vertices, the port's way."""
    scales, E, _ = tpe.encoding_constants(spec, None, "cpu")
    got = tpe.flat_slot_ids(torch.from_numpy(pts), table, shift, scales, E, L).numpy()
    return (got - (np.arange(L) * spec.capacity)[:, None, None]).transpose(0, 2, 1)


@pytest.mark.parametrize("d", [3, 4])
def test_slot_ids_bit_exact_at_full_capacity(d):
    """Hash slot ids equal JAX's bit for bit at capacity 2^18 over all 24
    levels (uint32 wraparound, negative keys) wherever the simplex is not
    at a tie."""
    spec_j, spec_t, params_j, params_t, pts = _setup(d, capacity=2 ** 18, nr_levels=24,
                                                     n=256, table_scale=1.0)
    L = 24
    want = _jax_slot_ids(pts, params_j["shift_per_level"], spec_j, L)
    got = _port_slot_ids(pts, params_t["lattice_values"], params_t["shift_per_level"], spec_t, L)
    ok = ~_ambiguous_mask(pts, np.asarray(params_j["shift_per_level"]), spec_j, L)
    assert ok.mean() > 0.8
    np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("d,max_levels,partial_window,scaling", [
    (3, None, False, 1e-3),
    (3, 2, True, 1e-3),
    (3, None, True, 1.0),
    (4, None, False, 1.0),
    (4, 3, True, 1.0),
])
def test_encode_forward_matches_jax(d, max_levels, partial_window, scaling):
    """Forward (kernel A's plain version) vs JAX permuto_encode, with a
    partial c2f window and the narrow max_levels output, to the float32
    precision of the lattice (``_feature_tol``)."""
    spec_j, spec_t, params_j, params_t, pts = _setup(d, scaling=scaling)
    window = jpe.coarse2fine_window(0.55 if partial_window else 1.0, 4)
    want = np.asarray(jpe.permuto_encode(params_j, jnp.asarray(pts), spec_j, window,
                                         max_levels=max_levels, zero_fill=False))
    got = tpe.permuto_encode(params_t, torch.from_numpy(pts), spec_t, np.asarray(window),
                             max_levels=max_levels, zero_fill=False).numpy()
    assert got.shape == want.shape
    K = max_levels or 4
    ok = ~_ambiguous_mask(pts, np.asarray(params_j["shift_per_level"]), spec_j, K).any(0)
    assert ok.mean() > 0.7
    tol = _feature_tol(pts, np.asarray(params_j["shift_per_level"]), spec_j, K, 1.0)
    assert np.all(np.abs(got[ok] - want[ok]) <= tol)


def test_encode_zero_fill_matches_jax():
    spec_j, spec_t, params_j, params_t, pts = _setup(3)
    want = np.asarray(jpe.permuto_encode(params_j, jnp.asarray(pts), spec_j, max_levels=2))
    got = tpe.permuto_encode(params_t, torch.from_numpy(pts), spec_t, max_levels=2).numpy()
    ok = ~_ambiguous_mask(pts, np.asarray(params_j["shift_per_level"]), spec_j, 2).any(0)
    assert got.shape == want.shape == (pts.shape[0], spec_j.output_dims)
    tol = _feature_tol(pts, np.asarray(params_j["shift_per_level"]), spec_j, 2, 1.0)
    tol = np.concatenate([tol[:4], np.zeros(4), tol[4:]])
    assert np.all(np.abs(got[ok] - want[ok]) <= tol)


@pytest.mark.parametrize("d,scaling", [(3, 1e-3), (4, 1.0)])
def test_point_gradient_matches_jax_vjp(d, scaling):
    """d/dpoints of sum(g * encode) through the port's autograd.Function
    (kernel B's plain version on the CPU) vs jax.vjp. Tolerance: 1e-5
    relative to the largest gradient (float32 sums over levels)."""
    spec_j, spec_t, params_j, params_t, pts = _setup(d, scaling=scaling)
    window = jpe.coarse2fine_window(0.7, 4)
    rng = np.random.default_rng(1)
    g = rng.normal(size=(pts.shape[0], spec_j.output_dims)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jpe.permuto_encode(params_j, p, spec_j, window), jnp.asarray(pts))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    p = torch.from_numpy(pts).requires_grad_(True)
    out = tpe.permuto_encode(params_t, p, spec_t, np.asarray(window))
    (got,) = torch.autograd.grad(out, p, torch.from_numpy(g))
    ok = ~_ambiguous_mask(pts, np.asarray(params_j["shift_per_level"]), spec_j, 4).any(0)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy()[ok] / scale, want[ok] / scale, atol=1e-5, rtol=0)


def test_table_gradient_raises():
    _, spec_t, _, params_t, pts = _setup(3)
    params_t["lattice_values"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tpe.permuto_encode(params_t, torch.from_numpy(pts), spec_t)


def test_coarse2fine_window_matches_jax():
    for t in (0.0, 0.3, 0.55, 1.0):
        np.testing.assert_allclose(tpe.coarse2fine_window(t, 24),
                                   np.asarray(jpe.coarse2fine_window(t, 24)), atol=1e-6)


def test_wrappers_refuse_other_devices():
    """The kernel wrappers take float32 and a matching device only."""
    _, spec_t, _, params_t, pts = _setup(3)
    scales, E, _ = tpe.encoding_constants(spec_t, None, "cpu")
    with pytest.raises(TypeError):
        tpe.encode_fwd_cuda(torch.from_numpy(pts).double(), params_t["lattice_values"],
                            params_t["shift_per_level"], scales, None, E, 4, 1.0, True)
