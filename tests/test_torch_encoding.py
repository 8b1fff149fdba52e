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
    """The table-gradient wrappers (kernels F and G) raise on cotangents the
    kernels do not take, before anything launches."""
    _, spec_t, _, params_t, pts = _setup(3)
    scales, E, _ = tpe.encoding_constants(spec_t, None, "cpu")
    args = (torch.from_numpy(pts), params_t["lattice_values"], params_t["shift_per_level"],
            scales, None, E, 4)
    with pytest.raises(ValueError, match="cotangent"):
        tpe.encode_table_grad_cuda(*args, torch.zeros((pts.shape[0], 5)))
    g = torch.zeros((pts.shape[0], spec_t.output_dims))
    with pytest.raises(ValueError, match="cotangent"):
        tpe.encode_double_backward_cuda(*args, 1e-3, True, g, torch.zeros((pts.shape[0], 2)))
    with pytest.raises(ValueError, match="cotangent"):
        tpe.encode_double_backward_cuda(*args, 1e-3, True, g.double(), torch.zeros_like(g))


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


def _unambiguous_points(d, n=300, seed=0, scaling=1.0, spec_j=None, **kw):
    """_setup with the points near a simplex tie at any level left out (a
    flip there moves a whole slot's gradient, and both choices are valid).
    ``spec_j`` replaces the JAX spec the ties are found with."""
    spec_j0, spec_t, params_j, params_t, pts = _setup(d, n=n, seed=seed, scaling=scaling, **kw)
    spec_j = spec_j or spec_j0
    ok = ~_ambiguous_mask(pts, np.asarray(params_j["shift_per_level"]), spec_j,
                          spec_j.nr_levels).any(0)
    return spec_j, spec_t, params_j, params_t, pts[ok]


def _table_tol(pts, shift, spec, g_abs_sum):
    """Per-level absolute tolerance of a table gradient sum_n bary_n g_n:
    each weight is good to ~4 d ulp of the lattice coordinates (as in
    _feature_tol), plus float32 sums."""
    tol = _feature_tol(pts, shift, spec, spec.nr_levels, 1.0)[:2 * spec.nr_levels:2]
    return tol * g_abs_sum + 1e-6


@pytest.mark.parametrize("d,scaling,partial_window,max_levels", [
    (3, 1e-3, True, None), (3, 1e-3, False, 3), (4, 1.0, True, None)])
def test_table_gradient_matches_jax_grad(d, scaling, partial_window, max_levels):
    """The table gradient of sum(w * encode) (kernel F's plain version,
    ``index_add_`` of the gather's transpose) against jax.grad, per level;
    levels past ``max_levels`` get zero."""
    spec_j, spec_t, params_j, params_t, pts = _unambiguous_points(d, scaling=scaling)
    window = jpe.coarse2fine_window(0.6 if partial_window else 1.0, 4)
    w = np.random.default_rng(3).normal(size=(pts.shape[0], spec_j.output_dims)).astype(np.float32)

    def f(table):
        out = jpe.permuto_encode({**params_j, "lattice_values": table}, jnp.asarray(pts),
                                 spec_j, window, max_levels=max_levels)
        return jnp.sum(out * w)

    want = np.asarray(jax.grad(f)(params_j["lattice_values"]))
    table = params_t["lattice_values"].clone().requires_grad_(True)
    out = tpe.permuto_encode({**params_t, "lattice_values": table}, torch.from_numpy(pts),
                             spec_t, np.asarray(window), max_levels=max_levels)
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), table)
    got = got.numpy()
    K = max_levels or 4
    assert np.all(got[K:] == 0) and np.all(want[K:] == 0)
    tol = _table_tol(pts, np.asarray(params_j["shift_per_level"]), spec_j,
                     np.abs(w[:, :8]).sum())
    for lvl in range(K):
        assert np.abs(got[lvl] - want[lvl]).max() <= tol[lvl], lvl
        assert (np.abs(want[lvl]).max() > 0) == (float(window[lvl]) > 0), lvl


@pytest.mark.parametrize("concat,mlp,finest", [(False, False, 0.05), (False, False, 1e-4),
                                               (True, True, 1e-4)])
def test_double_backward_matches_jax_grad(concat, mlp, finest):
    """The eikonal pattern of test_encoding.py:223 (the first case is its
    spec): the gradient, with respect to the table and an MLP, of a loss on
    d sdf / d points. The port builds the point gradient from the MLP's
    feature cotangent (kernel B, ``permuto_point_grad``), whose backward is
    kernel G; with a GELU layer the cotangent depends on the features, so
    the gradient also runs through G's feature output and kernel F."""
    rng = np.random.default_rng(5)
    spec = dict(pos_dim=3, capacity=2 ** 10, nr_levels=4, finest_scale=finest,
                concat_points=concat, concat_points_scaling=1e-3)
    spec_j, _, params_j, params_t, pts = _unambiguous_points(
        3, table_scale=1e3, spec_j=jpe.PermutoEncodingSpec(**spec))
    spec_t = tpe.PermutoEncodingSpec(**spec)
    D = spec_j.output_dims
    W1 = rng.normal(size=(D, 16)).astype(np.float32) * 0.5
    w2 = rng.normal(size=(16 if mlp else D, 1)).astype(np.float32) * 0.5
    window = jpe.coarse2fine_window(0.8, 4)

    def sdf_j(table, p, W1):
        feats = jpe.permuto_encode({**params_j, "lattice_values": table}, p, spec_j, window)
        h = jax.nn.gelu(feats @ W1) if mlp else feats
        return jnp.sum(h @ w2)

    def eik_j(table, W1):
        g = jax.grad(sdf_j, argnums=1)(table, jnp.asarray(pts), W1)
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    want_t, want_w = (np.asarray(a) for a in jax.grad(eik_j, argnums=(0, 1))(
        params_j["lattice_values"], jnp.asarray(W1)))
    table = params_t["lattice_values"].clone().requires_grad_(True)
    W1_t = torch.from_numpy(W1).requires_grad_(True)
    p_t = torch.from_numpy(pts)
    prm = {**params_t, "lattice_values": table}
    feats = tpe.permuto_encode(prm, p_t, spec_t, np.asarray(window))
    h = torch.nn.functional.gelu(feats @ W1_t, approximate="tanh") if mlp else feats
    sdf = h @ torch.from_numpy(w2)
    (g,) = torch.autograd.grad(sdf, feats, torch.ones_like(sdf), create_graph=True)
    grads = tpe.permuto_point_grad(prm, p_t, g, spec_t, np.asarray(window))
    loss = torch.mean((torch.linalg.norm(grads, dim=-1) - 1.0) ** 2)
    got_t, got_w = torch.autograd.grad(loss, [table, W1_t], allow_unused=True)
    got_t = got_t.numpy()
    assert np.abs(want_t).max() > 0
    for lvl in range(4):
        scale = np.abs(want_t[lvl]).max()
        # the finest level's barycentric weights are good to ~1e-3 (_feature_tol)
        np.testing.assert_allclose(got_t[lvl], want_t[lvl], atol=2e-3 * scale + 1e-9,
                                   err_msg=f"level {lvl}")
    if mlp:
        np.testing.assert_allclose(got_w.numpy(), want_w, atol=2e-3 * np.abs(want_w).max())


@pytest.mark.parametrize("period,parity", [(2, 0), (2, 1), (3, 0), (3, 1), (3, 2)])
def test_grad_level_parity_matches_jax_grad(period, parity):
    """Alternating-level table gradients (``grad_level_parity``, JAX
    permuto_encoding.py:561-609; after test_encoding.py:466 and :594) with
    the same spec on both sides: the forward and the point gradient are
    bit-identical to the port's without parity; the table gradient (kernel
    F) and the eikonal pattern's table term (kernel G) equal JAX's at the
    active levels and are exactly zero at the frozen ones on both sides."""
    L = 5
    base = dict(pos_dim=3, capacity=2 ** 10, nr_levels=L, concat_points_scaling=1e-3)
    par = dict(base, grad_level_parity=parity, grad_level_period=period)
    spec_j = jpe.PermutoEncodingSpec(**par)
    spec_t, spec_t0 = tpe.PermutoEncodingSpec(**par), tpe.PermutoEncodingSpec(**base)
    _, _, params_j, params_t, pts = _unambiguous_points(3, nr_levels=L, table_scale=1e3,
                                                        spec_j=spec_j)
    rng = np.random.default_rng(period * 10 + parity)
    window = jpe.coarse2fine_window(0.9, L)
    w = rng.normal(size=(pts.shape[0], spec_j.output_dims)).astype(np.float32)
    w2 = rng.normal(size=(spec_j.output_dims, 1)).astype(np.float32) * 0.5
    active = [lvl % period == parity for lvl in range(L)]
    p_t = torch.from_numpy(pts)

    def encode_t(spec, table, points):
        return tpe.permuto_encode({**params_t, "lattice_values": table}, points, spec,
                                  np.asarray(window))

    # forward and point gradient: unchanged by the parity
    for spec in (spec_t, spec_t0):
        x = p_t.clone().requires_grad_(True)
        out = encode_t(spec, params_t["lattice_values"], x)
        (gp,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), x)
        if spec is spec_t:
            out_p, gp_p = out.detach(), gp
    np.testing.assert_array_equal(out_p.numpy(), out.detach().numpy())
    np.testing.assert_array_equal(gp_p.numpy(), gp.numpy())

    # table gradient (kernel F)
    def f(table):
        out = jpe.permuto_encode({**params_j, "lattice_values": table}, jnp.asarray(pts),
                                 spec_j, window)
        return jnp.sum(out * w)

    want = np.asarray(jax.grad(f)(params_j["lattice_values"]))
    table = params_t["lattice_values"].clone().requires_grad_(True)
    (got,) = torch.autograd.grad((encode_t(spec_t, table, p_t) * torch.from_numpy(w)).sum(),
                                 table)
    got = got.numpy()
    tol = _table_tol(pts, np.asarray(params_j["shift_per_level"]), spec_j,
                     np.abs(w[:, :2 * L]).sum())
    for lvl in range(L):
        if active[lvl]:
            assert np.abs(want[lvl]).max() > 0
            assert np.abs(got[lvl] - want[lvl]).max() <= tol[lvl], lvl
        else:
            assert np.all(got[lvl] == 0) and np.all(want[lvl] == 0), lvl

    # the eikonal pattern's table term (kernel G: a linear head makes the
    # feature cotangent constant)
    def eik_j(table):
        g = jax.grad(lambda tb, p: jnp.sum(jpe.permuto_encode(
            {**params_j, "lattice_values": tb}, p, spec_j, window) @ w2),
            argnums=1)(table, jnp.asarray(pts))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    want = np.asarray(jax.grad(eik_j)(params_j["lattice_values"]))
    table = params_t["lattice_values"].clone().requires_grad_(True)
    prm = {**params_t, "lattice_values": table}
    feats = tpe.permuto_encode(prm, p_t, spec_t, np.asarray(window))
    sdf = feats @ torch.from_numpy(w2)
    (g,) = torch.autograd.grad(sdf, feats, torch.ones_like(sdf), create_graph=True)
    grads = tpe.permuto_point_grad(prm, p_t, g, spec_t, np.asarray(window))
    loss = torch.mean((torch.linalg.norm(grads, dim=-1) - 1.0) ** 2)
    (got,) = torch.autograd.grad(loss, table)
    got = got.numpy()
    for lvl in range(L):
        if active[lvl]:
            scale = np.abs(want[lvl]).max()
            assert scale > 0
            np.testing.assert_allclose(got[lvl], want[lvl], atol=2e-3 * scale + 1e-9,
                                       err_msg=f"level {lvl}")
        else:
            assert np.all(got[lvl] == 0) and np.all(want[lvl] == 0), lvl
