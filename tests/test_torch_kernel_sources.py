"""The CUDA sources of kernels A-D, F, G, D', I, J0-J2 and H0, compiled for the CPU with g++ against a
small CUDA stand-in (``tests/cuda_cpu_emulation/cuda_runtime.h``) and run
through the port's own kernel wrappers, against the plain PyTorch versions.

This checks the kernels' logic (indexing, warp scans, masks, the lattice)
on every CPU run; the card itself checks them in ``chip_smoke.py``. The
emulation compiles the same float operations in the same order as nvcc
with ``--fmad=false`` would, so the lattice and the sampler agree exactly;
kernel D's warp-scan product differs from the serial cumprod by
association only (tolerance 1e-6).
"""

import ctypes
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.ops import compaction
from permuto_sdf_tpu_torch.ops import occupancy_grid as og
from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
from permuto_sdf_tpu_torch.ops import sphere_trace as st
from permuto_sdf_tpu_torch.ops import volume_rendering as vr
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask

_EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_cpu_emulation")


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """Build the kernel libraries for the CPU (in parallel)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available: cannot compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("cpu_kernels")

    def build(name):
        lib = out / f"lib{name}.so"
        cmd = [gxx, "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
               "-Wno-unknown-pragmas", "-I", _EMU, "-I", str(kernels.CSRC), "-o", str(lib),
               str(kernels.CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        return name, lib

    with ThreadPoolExecutor(len(kernels.LIBRARIES)) as ex:
        libs = dict(ex.map(build, kernels.LIBRARIES))
    return {name: kernels.declare(ctypes.CDLL(str(path)), name) for name, path in libs.items()}


@pytest.fixture
def emulated(cpu_kernels, monkeypatch):
    """Route the wrappers' launches to the CPU-compiled libraries."""
    monkeypatch.setattr(kernels, "load", lambda name: cpu_kernels[name])
    monkeypatch.setattr(kernels, "current_stream", lambda device: ctypes.c_void_p(None))


@pytest.mark.parametrize("d,K,window", [(3, 4, False), (3, 3, True), (4, 4, True)])
def test_kernels_A_B_source_matches_plain(emulated, d, K, window):
    rng = np.random.default_rng(d * 10 + K)
    spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=2 ** 18, nr_levels=4,
                                  concat_points_scaling=1e-3)
    prm = pe.init_encoding_params(torch.Generator().manual_seed(1), spec, "cpu")
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (300, d)).astype(np.float32))
    scales, E, _ = pe.encoding_constants(spec, None, "cpu")
    win = torch.tensor([1.0, 0.7, 0.3, 0.0]) if window else None
    args = (pts, prm["lattice_values"], prm["shift_per_level"], scales, win, E, K, 1e-3, True)
    launches = pe.encode_fwd_cuda.launches
    got = pe.encode_fwd_cuda(*args)
    assert pe.encode_fwd_cuda.launches == launches + 1
    np.testing.assert_array_equal(got.numpy(), pe.encode_fwd_plain(*args).numpy())
    g = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    np.testing.assert_array_equal(pe.encode_point_grad_cuda(*args, g).numpy(),
                                  pe.encode_point_grad_plain(*args, g).numpy())


@pytest.mark.parametrize("S,P,min_dist", [(64, 512, 1e-4), (40, 64, 0.02)])
def test_kernel_C_source_matches_plain(emulated, S, P, min_dist):
    rng = np.random.default_rng(S)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    R = 37  # not a multiple of the 4 rays per block
    o = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    o = o / o.norm(dim=-1, keepdim=True) * 1.3
    tgt = torch.from_numpy(rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32))
    dr = torch.nn.functional.normalize(tgt - o, dim=-1)
    _, te, _, tx, _ = Sphere().ray_intersection(o, dr)
    occ = torch.from_numpy(rng.uniform(size=16 ** 3) < 0.3)
    got = og.probe_sampler_cuda(cfg, occ, o, dr, te, tx, min_dist, S, P)
    want = og.probe_sampler_plain(cfg, occ, o, dr, te, tx, min_dist, S, P)
    assert want[2].sum() > 50
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_D_source_matches_plain(emulated):
    rng = np.random.default_rng(7)
    R, S = 50, 70  # S spans three 32-sample chunks, the last one partial
    nr = torch.from_numpy(rng.integers(0, S + 1, R))
    nr[0], nr[1] = 0, S
    z = torch.zeros((R, S))
    dt = torch.from_numpy(rng.uniform(0, 0.02, (R, S)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32)), dim=-1)
    smp = RaySamples(origins=torch.zeros(R, 3), dirs=dirs, z=z, dt=dt, mask=prefix_mask(nr, S),
                     ray_fixed_dt=torch.zeros(R))
    sdf = torch.from_numpy(rng.uniform(-0.05, 0.05, (R, S)).astype(np.float32))
    grads = torch.from_numpy(rng.normal(size=(R * S, 3)).astype(np.float32))
    rgb = torch.from_numpy(rng.uniform(size=(R * S, 3)).astype(np.float32))
    got = vr.render_weights_cuda(0, smp, sdf, grads, rgb, 400.0, 0.7)
    want = vr.neus_render_plain(smp, sdf, grads, rgb, 400.0, 0.7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    dens = torch.from_numpy(rng.uniform(0, 50, (R, S)).astype(np.float32))
    got = vr.render_weights_cuda(1, smp, dens, None, rgb, 0.0, 0.0)
    assert got[4] is None
    want = vr.nerf_render_plain(smp, dens, rgb)
    for a, b in zip(got[:4], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("d,K,window", [(3, 4, True), (4, 3, False)])
def test_kernels_F_G_source_match_plain(emulated, d, K, window):
    """Kernel F (table gradient) and kernel G (double backward) against
    their plain versions. Both add into the table with atomicAdd in no fixed
    order, so each level of the table gradient is held to 1e-5 of its
    largest |value|; G's feature cotangent is a gather and matches to 1e-6."""
    rng = np.random.default_rng(d * 7 + K)
    spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=2 ** 10, nr_levels=4,
                                  concat_points_scaling=1e-3)
    prm = pe.init_encoding_params(torch.Generator().manual_seed(2), spec, "cpu")
    table = prm["lattice_values"] * 1e3
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (200, d)).astype(np.float32))
    scales, E, _ = pe.encoding_constants(spec, None, "cpu")
    win = torch.tensor([1.0, 0.6, 0.2, 0.0]) if window else None
    args = (pts, table, prm["shift_per_level"], scales, win, E, K)
    g = torch.from_numpy(rng.normal(size=(200, 2 * K + d)).astype(np.float32))
    launches = (pe.encode_table_grad_cuda.launches, pe.encode_double_backward_cuda.launches)

    def close_per_level(a, b):
        for lvl in range(a.shape[0]):
            scale = float(b[lvl].abs().max())
            np.testing.assert_allclose(a[lvl].numpy(), b[lvl].numpy(),
                                       atol=1e-5 * scale + 1e-12, rtol=0)

    close_per_level(pe.encode_table_grad_cuda(*args, g), pe.encode_table_grad_plain(*args, g))
    u = torch.from_numpy(rng.normal(size=(200, d)).astype(np.float32))
    dt_k, dg_k = pe.encode_double_backward_cuda(*args, 1e-3, True, g, u)
    dt_p, dg_p = pe.encode_double_backward_plain(*args, 1e-3, True, g, u)
    close_per_level(dt_k, dt_p)
    np.testing.assert_allclose(dg_k.numpy(), dg_p.numpy(), atol=1e-6 * float(dg_p.abs().max()))
    assert (pe.encode_table_grad_cuda.launches, pe.encode_double_backward_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.parametrize("mode", [0, 1])
def test_kernel_D_backward_source_matches_plain(emulated, mode):
    """Kernel D' (reverse warp scan of the transmittance recurrence, three
    32-sample chunks, the last partial) against the plain backward (autograd
    of the plain forward), with random cotangents on every output; to 1e-5
    of each gradient's largest |value|."""
    rng = np.random.default_rng(11 + mode)
    R, S = 50, 70
    nr = torch.from_numpy(rng.integers(0, S + 1, R))
    nr[0], nr[1], nr[2] = 0, S, 1
    mask = prefix_mask(nr, S) if mode == 0 else torch.ones((R, S), dtype=torch.bool)
    dt = torch.from_numpy(rng.uniform(0, 0.02, (R, S)).astype(np.float32))
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32)), dim=-1)
    smp = RaySamples(origins=torch.zeros(R, 3), dirs=dirs, z=torch.zeros((R, S)), dt=dt,
                     mask=mask, ray_fixed_dt=torch.zeros(R))
    if mode == 0:
        val = torch.from_numpy(rng.uniform(-0.05, 0.05, (R, S)).astype(np.float32))
        grads = torch.from_numpy(rng.normal(size=(R * S, 3)).astype(np.float32))
    else:
        val = torch.from_numpy(rng.uniform(0, 50, (R, S)).astype(np.float32))
        grads = None
    rgb = torch.from_numpy(rng.uniform(size=(R * S, 3)).astype(np.float32))
    cots = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for shape in ((R, S), (R, 1), (R,), (R, 3), (R, 3))]
    if mode == 1:
        cots[4] = None
    got = vr.render_weights_bwd_cuda(mode, smp, val, grads, rgb, 400.0, 0.7, *cots)
    want = vr.render_weights_bwd_plain(mode, smp, val, grads, rgb, 400.0, 0.7, *cots)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), b.reshape(a.shape).numpy(),
                                   atol=1e-5 * float(b.abs().max()), rtol=0)


def test_kernel_I_source_matches_plain(emulated):
    """Kernel I: the stratified probe ids and jittered centers, then the
    grid update, against the plain versions (identical float operations:
    exact), at an update index that wraps the uint32 probe index."""
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    rng = np.random.default_rng(3)
    n = 700
    for update_idx in (0, 3, 2 ** 22 + 1):
        jitter = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
        c_k, lin_k = og.grid_points_cuda(cfg, n, update_idx, jitter, "cpu")
        c_p, lin_p = og.grid_points_plain(cfg, n, update_idx, jitter, "cpu")
        np.testing.assert_array_equal(lin_k.numpy(), lin_p.numpy())
        np.testing.assert_array_equal(c_k.numpy(), c_p.numpy())
    lin = lin_k[:16 ** 3 // 2]  # distinct voxels: the Weyl map is a bijection
    assert len(set(lin.tolist())) == lin.numel()
    sdf = torch.from_numpy(rng.normal(0, 0.1, lin.numel()).astype(np.float32))
    grids = [og.OccupancyGridState(values=torch.zeros(16 ** 3),
                                   occupancy=torch.ones(16 ** 3, dtype=torch.bool))
             for _ in range(2)]
    og.grid_update_cuda(cfg, grids[0], lin, sdf, 300.0, 1e-4)
    og.grid_update_plain(cfg, grids[1], lin, sdf, 300.0, 1e-4)
    np.testing.assert_array_equal(grids[0].values.numpy(), grids[1].values.numpy())
    np.testing.assert_array_equal(grids[0].occupancy.numpy(), grids[1].occupancy.numpy())
    assert 0 < int((~grids[0].occupancy).sum()) < lin.numel()


def test_kernel_C_jittered_start_source_matches_plain(emulated):
    """Kernel C with the per-ray start of the training jitter."""
    rng = np.random.default_rng(5)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    R = 37
    o = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    o = o / o.norm(dim=-1, keepdim=True) * 1.3
    dr = torch.nn.functional.normalize(
        torch.from_numpy(rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)) - o, dim=-1)
    _, te, _, tx, _ = Sphere().ray_intersection(o, dr)
    occ = torch.from_numpy(rng.uniform(size=16 ** 3) < 0.3)
    start = torch.from_numpy(rng.uniform(size=R).astype(np.float32))
    got = og.probe_sampler_cuda(cfg, occ, o, dr, te, tx, 0.02, 40, 64, start)
    want = og.probe_sampler_plain(cfg, occ, o, dr, te, tx, 0.02, 40, 64, start)
    assert want[2].sum() > 50
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("V,cap,kind", [(16, 63, "sparse"), (32, 15, "sparse"), (32, 63, "shell")])
def test_kernel_J0_source_matches_plain(emulated, V, cap, kind):
    """Kernel J0 (three separable passes) against the plain version (the
    JAX op's min-pool sweeps): the same integers."""
    rng = np.random.default_rng(V + cap)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=V)
    occ = torch.from_numpy(rng.uniform(size=V ** 3) < 0.002) if kind == "sparse" else _shell(V)
    launches = og.chebyshev_field_cuda.launches
    got = og.chebyshev_field_cuda(cfg, occ, cap)
    assert og.chebyshev_field_cuda.launches == launches + 1
    want = og.chebyshev_field_plain(cfg, occ, cap)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert 0 == int(want.min()) < 3 < int(want.max())


@pytest.mark.parametrize("n,p,sizes", [(5000, 0.3, (100, 1500, 1523, 6000)), (0, 0.0, (0, 256)),
                                       (2048, 1.0, (2048,)), (777, 0.01, (256, 3))])
def test_kernel_H0_source_matches_plain(emulated, n, p, sizes):
    """Kernel H0 (tile counts, then the offsets and the in-block scan)
    against the plain version: the same indices in the same order, the fill
    value in the unused slots, and the true count; buckets below, at and
    above the count, and a mask shorter than a tile."""
    mask = torch.from_numpy(np.random.default_rng(n).uniform(size=n) < p)
    count = int(mask.sum())
    for size in sizes + (count,):
        for fill in (None, n + 5):
            got = compaction.nonzero_static_cuda(mask, size, fill)
            want = compaction.nonzero_static_plain(mask, size, fill)
            np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
            assert int(got[1]) == int(want[1]) == count


def _shell(V):
    """Voxels whose center is within 1.5 voxels of the sphere |p| = 0.25."""
    c = (torch.arange(V, dtype=torch.float32) + 0.5) / V - 0.5
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    return (torch.abs(torch.sqrt(x * x + y * y + z * z) - 0.25) < 1.5 / V).reshape(-1)


def _trace_state(V=32, n=300, seed=0):
    """A shell grid, its distance field and padded per-ray state of rays
    from cameras around the grid towards its center."""
    rng = np.random.default_rng(seed)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=V)
    occ = _shell(V)
    field = og.chebyshev_field_plain(cfg, occ, 63)
    o = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    o = o / o.norm(dim=-1, keepdim=True) * 1.2
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.uniform(-0.35, 0.35, (n, 3)).astype(np.float32)) - o, dim=-1)
    _, te, _, tx, hit = Sphere().ray_intersection(o, d)
    pad = lambda t, fill=0.0: torch.cat([t, torch.full((1,) + t.shape[1:], fill, dtype=t.dtype)])  # noqa: E731
    state = dict(origins_f=pad(o), dirs_f=pad(d), texit_f=pad(tx[:, 0]), t_f=pad(te[:, 0]),
                 alive_f=pad(hit[:, 0], False))
    return cfg, occ, field, state


def test_kernels_J1_J2_source_match_plain(emulated):
    """Kernel J1 (the jump prepass) and kernel J2 (one trace iteration:
    positions only, then with SDF values, with and without the field and the
    gate, with the counts) against their plain versions on cloned state:
    identical float operations, so t, the flags, the sdf, the positions and
    the counts are equal."""
    cfg, _, field, s0 = _trace_state()
    R = s0["t_f"].shape[0] - 1
    ks = {k: v.clone() for k, v in s0.items()}
    ps = {k: v.clone() for k, v in s0.items()}
    args = lambda s: (field, s["origins_f"], s["dirs_f"], s["texit_f"], s["t_f"], s["alive_f"])  # noqa: E731
    n_k = st.jump_prepass_cuda(*args(ks), cfg, 16)
    n_p = st.jump_prepass_plain(*args(ps), cfg, 16)
    for k in ks:
        np.testing.assert_array_equal(ks[k].numpy(), ps[k].numpy())
    assert int(n_k) == int(n_p) and 0 < int(n_p) < int(s0["alive_f"].sum())
    assert not torch.equal(ks["t_f"], s0["t_f"])

    rng = np.random.default_rng(1)
    for s in (ks, ps):
        s["conv_f"] = torch.zeros(R + 1, dtype=torch.bool)
        s["sdf_f"] = torch.zeros(R + 1)
    idx, _ = compaction.nonzero_static_plain(ps["alive_f"][:R] & ~ps["conv_f"][:R], 384, R)
    for it, (fld, gate, subs) in enumerate(((field, 1.0 / 32, 4), (field, 0.0, 1), (None, 0.0, 1))):
        sdf = torch.from_numpy(rng.uniform(-0.02, 0.2, idx.shape[0]).astype(np.float32))
        sdf[::7] = 1e-5  # converge some rays
        for s_in in (None, sdf):
            outs = []
            for fn, s in ((st.trace_step_cuda, ks), (st.trace_step_plain, ps)):
                outs.append(fn(idx, s_in, s["origins_f"], s["dirs_f"], s["texit_f"], s["t_f"],
                               s["alive_f"], s["conv_f"], s["sdf_f"], fld, cfg, 0.9, 2e-4, subs,
                               gate, counts=True))
            for a, b in zip(*outs):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
            for k in ks:
                np.testing.assert_array_equal(ks[k].numpy(), ps[k].numpy())
    assert 0 < int(ps["conv_f"].sum()) and int((~ps["alive_f"][:R] & s0["alive_f"][:R]).sum()) > 0


def test_sphere_trace_through_the_kernel_sources_matches_plain(emulated, monkeypatch):
    """``sphere_trace_adaptive`` with H0, J0, J1 and J2 all taken from the
    kernel sources (on CPU tensors) gives the plain path's trace exactly."""
    cfg, occ, _, s0 = _trace_state()
    o, d = s0["origins_f"][:-1], s0["dirs_f"][:-1]
    grid = og.OccupancyGridState(values=torch.zeros(cfg.nr_voxels), occupancy=occ)

    def sdf(ctx, p):
        return torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]) - ctx

    kw = dict(nr_rounds=4, iters_per_round=3, grid_cfg=cfg, grid=grid, min_bucket=64,
              refine_sdf_eval=sdf, refine_ctx=0.25, jump_substeps=4, prepass_jumps=16,
              return_n_hit=True)
    stats_p, stats_k = [], []
    want = st.sphere_trace_adaptive(sdf, 0.255, o, d, Sphere(), stats_out=stats_p, **kw)
    monkeypatch.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: cuda_fn)
    got = st.sphere_trace_adaptive(sdf, 0.255, o, d, Sphere(), stats_out=stats_k, **kw)
    assert stats_k == stats_p and stats_p[-1][0] == "refine" and stats_p[-1][3] > 20
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_I_launch_bumps_the_grid_version(emulated):
    """The refresh kernel writes the grid through ctypes, so its wrapper
    bumps the tensors' version counters by hand (the distance-field cache
    keys on them); the plain path's index writes bump them as well."""
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    lin = torch.arange(100, dtype=torch.int32)
    sdf = torch.full((100,), 0.5)
    for fn in (og.grid_update_cuda, og.grid_update_plain):
        grid = og.make_occupancy_grid(cfg, device="cpu")
        before = grid.occupancy._version
        fn(cfg, grid, lin, sdf, 300.0, 1e-4)
        assert grid.occupancy._version > before
        assert not grid.occupancy[:100].any()
