"""Port parity of mesh extraction: ``permuto_sdf_tpu_torch.ops.marching_cubes``
against the JAX package's, on the CPU.

The reference is the JAX package's native path
(``permuto_sdf_tpu.native.marching_tetrahedra_native``, the C++ walk built
with g++), which its extractor takes wherever a compiler exists. On one
grid the port's plain marching tetrahedra must equal it: faces and counts
exactly, vertices within one float32 ulp (the world transform is one
fused multiply-add in both; the port emulates it exactly, so the ulp is
headroom for a compiler that does not contract). The whole extractor runs
the SDF through each package's own encoding, whose finest levels round
differently (ROADMAP Queue 3), so it is compared geometrically, as
``tests/test_native.py`` compares the two JAX paths: the face count equal,
the vertex count within 0.5%, every port vertex within 1e-5 of a JAX
vertex (one int16 quantum of the grid, 0.25 / 32766, moves a vertex by at
most ~7.6e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial import cKDTree

from permuto_sdf_tpu.models import fields as jf
from permuto_sdf_tpu.native import marching_tetrahedra_native, native_available
from permuto_sdf_tpu.ops import marching_cubes as jmc
from permuto_sdf_tpu_torch.convert import params_from_jax
from permuto_sdf_tpu_torch.models import fields as tf
from permuto_sdf_tpu_torch.ops import marching_cubes as tmc


def sphere_grid(n=40, r=0.3):
    ax = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    return np.linalg.norm(g, axis=-1) - r


def planted_grid(n, seed=0):
    """A sphere union a grid-aligned plane whose layer n // 3 holds exactly
    the level (0), every value within 1/64 of it snapped onto it, eight
    isolated interior nodes at exactly the level (their faces are all
    degenerate, so their vertices stay unreferenced), and eight nodes at
    -1e-13 beside a node at the level (the 1e-12 denominator floor)."""
    rng = np.random.default_rng(seed)
    h = np.float32(1.0 / (n - 1))
    idx = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    c = np.float32(n - 1) * np.float32([0.55, 0.5, 0.45])
    s = (np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
         - np.float32(0.3 * (n - 1))) * h
    plane = (y - np.float32(n // 3)) * np.float32(1.0 / 16)
    v = np.minimum(s, plane).astype(np.float32)
    v[np.abs(v) < np.float32(1.0 / 64)] = 0.0
    inner = np.argwhere(v < -0.05)
    for i, j, k in inner[rng.choice(len(inner), size=min(8, len(inner)), replace=False)]:
        v[i, j, k] = 0.0
    zeros = np.argwhere(v == 0.0)
    for i, j, k in zeros[rng.choice(len(zeros), size=8, replace=False)]:
        if i + 1 < n:
            v[i + 1, j, k] = np.float32(-1e-13)
    return v


GRIDS = {
    "sphere40": (lambda: sphere_grid(40), (-0.5,) * 3, (1.0 / 39,) * 3),
    "planted": (lambda: planted_grid(24), (-0.5, -0.4, -0.3), (0.05, 0.04, 1.0 / 23)),
    "empty": (lambda: np.ones((8, 9, 10), np.float32), (0.0,) * 3, (1.0,) * 3),
}


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_case_table_matches_jax():
    np.testing.assert_array_equal(tmc._TRI_EDGES, jmc._TRI_EDGES)
    np.testing.assert_array_equal(tmc._N_TRIS, jmc._N_TRIS)
    np.testing.assert_array_equal(tmc._TETS, jmc._TETS)
    np.testing.assert_array_equal(tmc._CUBE_CORNERS, jmc._CUBE_CORNERS)
    np.testing.assert_array_equal(tmc._TET_EDGES, jmc._TET_EDGES)


@pytest.fixture
def native():
    if not native_available():
        pytest.skip("no C++ toolchain for the JAX native path")


@pytest.mark.parametrize("name", list(GRIDS))
def test_plain_marching_tets_matches_native(native, name):
    make, origin, spacing = GRIDS[name]
    v = make()
    Vn, Fn = marching_tetrahedra_native(v, 0.0, origin=origin, spacing=spacing)
    Vt, Ft = tmc.marching_tetrahedra(torch.from_numpy(v), 0.0, origin=origin, spacing=spacing)
    Vt, Ft = Vt.numpy(), Ft.numpy()
    assert Vt.dtype == np.float32 and Ft.dtype == np.int64
    assert Vt.shape == Vn.shape and Ft.shape == Fn.shape
    np.testing.assert_array_equal(Ft, Fn)
    if Vn.size:
        assert _ulps(Vt, Vn).max() <= 1
    if name == "empty":
        assert Vt.shape == (0, 3) and Ft.shape == (0, 3)
    if name == "planted":
        # the exact-level nodes weld several edges' crossings into one
        # vertex and leave the vertices of dropped degenerate faces in V
        used = np.zeros(len(Vn), bool)
        used[Fn.reshape(-1)] = True
        assert (~used).sum() > 0
    if name == "sphere40":
        edges = np.sort(np.concatenate([Ft[:, [0, 1]], Ft[:, [1, 2]], Ft[:, [2, 0]]]), axis=1)
        _, counts = np.unique(edges, axis=0, return_counts=True)
        assert (counts == 2).all()


def test_plain_emits_degenerate_faces_on_the_planted_grid():
    """The planted grid does reach the degenerate-face and denominator-floor
    branches, and the slabs do not change the mesh."""
    v = torch.from_numpy(planted_grid(24))
    spacing, origin = (np.float32(0.05),) * 3, (0.0,) * 3
    _, keys, degenerate = tmc._slab_emit(v, 0, 23, torch.tensor(0.0), spacing, origin)
    assert degenerate.sum() > 100
    whole = tmc.marching_tetrahedra_plain(v, 0.0, slab=64)
    thin = tmc.marching_tetrahedra_plain(v, 0.0, slab=1)
    assert torch.equal(whole[0], thin[0]) and torch.equal(whole[1], thin[1])


def test_fma_emulation_rounds_once():
    """``_fma_f32`` equals the float32 fused multiply-add: against a
    float64 reference whose exact sum is checked with fractions."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 600, 20000).astype(np.float32)
    b, c = float(np.float32(1.0 / 511)), float(np.float32(-0.5))
    got = tmc._fma_f32(torch.from_numpy(a), b, c).numpy()
    for i in range(0, 20000, 97):
        exact = Fraction(float(a[i])) * Fraction(b) + Fraction(c)
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-1)), lo, np.nextafter(lo, np.float32(1))]
        best = min(cands, key=lambda x: abs(Fraction(float(x)) - exact))
        assert got[i] == best


def _planted_plane_params():
    """JAX SDF parameters (capacity 2^10, 4 levels) whose SDF is a
    monotone function of n.p (a tilted plane through the box) plus a bump
    from every encoding level (the tables scaled up to +-1e-2): hidden unit
    0 carries 2 + n.p from the concatenated point columns through the three
    GELUs (increasing above 1), and the output bias puts the level set at
    the median of the grid's values."""
    cfg = jf.SDFConfig(geom_feat_size_out=0, capacity=2 ** 10, nr_levels=4)
    p = jax.tree_util.tree_map(np.array, jf.init_sdf(jax.random.PRNGKey(5), cfg))
    p["encoding"]["lattice_values"] = p["encoding"]["lattice_values"] * 100
    mlp = p["mlp_sdf"]
    n = np.float32([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2]).astype(np.float32)
    mlp[0]["w"][:-3, 0] *= 0.05
    mlp[0]["w"][-3:, 0] = n * 1e3
    mlp[0]["b"][0] = 2.0
    for layer in mlp[1:-1]:
        layer["w"][:, 0] = 0.0
        layer["w"][0, 0] = 1.0
        layer["b"][0] = 0.0
    mlp[-1]["w"][:, 0] = 0.0
    mlp[-1]["w"][0, 0] = 1.0
    mlp[-1]["b"][0] = 0.0
    ax = np.linspace(-0.5, 0.5, 16, dtype=np.float32)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    mlp[-1]["b"][0] = -np.median(np.asarray(jf.sdf_apply(p, jnp.asarray(pts), 9_999_999, cfg)[0]))
    return cfg, p


def _box_and_plane(xp, pts):
    """min(a box's max-norm SDF, a tilted plane) in operations that round
    the same in both frameworks (power-of-two products, abs, max, min)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    box = xp.maximum(xp.maximum(xp.abs(x - 0.0625), xp.abs(y)), xp.abs(z + 0.125)) - 0.25
    plane = x * 0.5 + y * 0.25 + z * 0.125 + 0.1875
    return xp.minimum(box, plane)[:, None]


def test_extract_mesh_matches_jax_on_the_same_sdf(native):
    """The whole extractor (axis, blocks, int16 quantization, marching) on
    an SDF that both frameworks evaluate bit for bit: the same mesh. 37 is
    not a multiple of the block (16)."""
    Vj, Fj = jmc.extract_mesh_from_sdf_fn(lambda p: _box_and_plane(jnp, p), 37, -0.5, 0.5,
                                          block=16)
    Vt, Ft = tmc.extract_mesh_from_sdf_fn(lambda p: _box_and_plane(torch, p), 37, -0.5, 0.5,
                                          block=16, device="cpu")
    Vt, Ft = Vt.numpy(), Ft.numpy()
    assert len(Fj) > 1000 and Vt.shape == Vj.shape
    np.testing.assert_array_equal(Ft, Fj)
    assert _ulps(Vt, Vj).max() <= 1


def test_extract_mesh_of_a_model_matches_jax(native):
    """The extractor on converted parameters at 32^3. The two packages'
    SDFs differ by ~1e-6 here (the MLP's sums and GELUs round apart), so
    ~1% of the grid's int16 values differ by one quantum q = 0.25 / 32766.
    That moves a crossing by q / |ds| of its edge, ds the SDF's change along
    the edge: ~7.6e-6 where the edge crosses the surface head on, more where
    it runs nearly tangent to it. Gates: the face count equal, the vertex
    count within 0.5%, 99% of the port's vertices within 1e-5 of a JAX
    vertex and all within 1e-4 (1/300 of a cell)."""
    cfg, pj = _planted_plane_params()
    tcfg = tf.SDFConfig(geom_feat_size_out=0, capacity=2 ** 10, nr_levels=4)
    pt = params_from_jax(pj, "cpu")
    pj = jax.tree_util.tree_map(jnp.asarray, pj)
    Vj, Fj = jmc.extract_mesh_from_sdf_fn(
        lambda pts: jf.sdf_apply(pj, pts, 9_999_999, cfg)[0], 32, -0.5, 0.5)
    Vt, Ft = tmc.extract_mesh_from_sdf_fn(
        lambda pts: tf.sdf_apply(pt, pts, 9_999_999, tcfg)[0], 32, -0.5, 0.5, device="cpu")
    Vt, Ft = Vt.numpy(), Ft.numpy()
    assert len(Fj) > 1000
    assert len(Ft) == len(Fj)
    assert abs(len(Vt) - len(Vj)) <= 0.005 * len(Vj)
    d = cKDTree(Vj).query(Vt, k=1)[0]
    assert np.mean(d <= 1e-5) >= 0.99
    assert d.max() <= 1e-4


def test_device_rule():
    with pytest.raises(ValueError):
        tmc.marching_tetrahedra(torch.zeros((2, 2, 2), device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmc.extract_mesh_from_sdf_fn(lambda p: p[:, :1], 8, -0.5, 0.5)
