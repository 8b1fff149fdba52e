"""The CUDA sources of kernels A-D, F, G, D', I, J0-J2, H0-H2, E1, E2, L, D2, D2', M,
C3, J3, C2 and I2,
compiled for the CPU with g++ against a small CUDA stand-in
(``tests/cuda_cpu_emulation/cuda_runtime.h``) and run through the port's
own kernel wrappers, against the plain PyTorch versions.

This checks the kernels' logic (indexing, warp scans, masks, the lattice)
on every CPU run; the card itself checks them in ``chip_smoke.py``. The
emulation compiles the same float operations in the same order as nvcc
with ``--fmad=false`` would, so the lattice and the sampler agree exactly;
kernel D's warp-scan product differs from the serial cumprod by
association only (tolerance 1e-6), and so do E1's sums (its scans
accumulate in double, as the CPU's cumsum does: 1e-6).
"""

import ctypes
import dataclasses
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
from permuto_sdf_tpu_torch.ops import ray_sampler as rs
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


def _imp_batch(rng, R, S, nr):
    """A prefix-masked uniform sample set whose sdf crosses zero once per
    ray (a surface), plus noise."""
    from permuto_sdf_tpu_torch.ops.ray_samples import prefix_mask as pm

    fixed = torch.from_numpy(rng.uniform(2e-3, 2e-2, R).astype(np.float32))
    start = torch.from_numpy(rng.uniform(0.2, 0.6, R).astype(np.float32))
    z = start[:, None] + fixed[:, None] * torch.arange(S, dtype=torch.float32)[None, :]
    mask = pm(nr, S)
    dt = torch.where(mask, fixed[:, None].expand(R, S), torch.zeros(R, S))
    surf = start + fixed * torch.from_numpy(rng.uniform(0, S, R).astype(np.float32))
    sdf = (surf[:, None] - z) + torch.from_numpy(rng.normal(0, 2e-3, (R, S)).astype(np.float32))
    sdf = torch.where(mask, sdf, torch.full_like(sdf, 1e3))
    z = torch.where(mask, z, torch.zeros_like(z))
    smp = RaySamples(origins=torch.zeros(R, 3), dirs=torch.zeros(R, 3), z=z, dt=dt, mask=mask,
                     ray_fixed_dt=fixed)
    return smp, sdf, start + fixed * (S + 1)


@pytest.mark.parametrize("S,n,jitter,mult", [(64, 16, False, 1.0), (70, 16, True, 2.0),
                                             (8, 4, True, 1.0), (80, 40, False, 2.0)])
def test_kernel_E1_source_matches_plain(emulated, S, n, jitter, mult):
    """Kernel E1 (section alphas, the transmittance and CDF warp scans in
    double, the upper-bound search) against the plain round on rays with 0,
    1, 2 and all samples valid, runs spanning lanes, n above a warp: the
    masks equal, z_imp to 1e-6 (the plain sums in another order)."""
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp

    rng = np.random.default_rng(S + n)
    R = 37
    nr = torch.from_numpy(rng.integers(0, S + 1, R))
    nr[0], nr[1], nr[2], nr[3] = 0, 1, 2, S
    smp, sdf, _ = _imp_batch(rng, R, S, nr)
    mov = 1.0 / (n + 1) / 2.0
    jit = (torch.from_numpy(rng.uniform(-mov, mov, (R, n)).astype(np.float32))
           if jitter else None)
    launches = isp.importance_round_cuda.launches
    z_k, m_k = isp.importance_round_cuda(smp, sdf, n, jit, mult)
    z_p, m_p = isp.importance_round_plain(smp, sdf, n, jit, mult)
    assert isp.importance_round_cuda.launches == launches + 1
    np.testing.assert_array_equal(m_k.numpy(), m_p.numpy())
    np.testing.assert_allclose(z_k.numpy(), z_p.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(m_k, (nr > 0)[:, None].expand(R, n)) and (z_k[0] == 0).all()


@pytest.mark.parametrize("carry", [False, True])
def test_kernel_E2_source_matches_plain(emulated, carry):
    """Kernel E2 (the rank merge, then dt) against the plain merge
    (``torch.argsort(stable=True)``): ties between and within the two sets
    go in concatenation order, rays with 0, 1 and all samples valid; z, dt,
    mask and the carried sdf equal."""
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp
    from permuto_sdf_tpu_torch.ops.ray_samples import prefix_mask as pm

    rng = np.random.default_rng(9)
    R, S1, S2 = 41, 40, 16
    nr1 = torch.from_numpy(rng.integers(0, S1 + 1, R))
    nr1[0], nr1[1], nr1[2] = 0, 1, S1
    nr2 = torch.where(nr1 > 0, S2, 0)
    z1 = torch.sort(torch.from_numpy(rng.integers(0, 30, (R, S1)).astype(np.float32) * 0.01),
                    dim=1).values
    z2 = torch.from_numpy(rng.integers(0, 30, (R, S2)).astype(np.float32) * 0.01)  # unsorted, ties
    z2[3] = z1[3, :S2]  # exact ties across the sets
    fixed = torch.from_numpy(rng.uniform(0.005, 0.02, R).astype(np.float32))
    a = RaySamples(origins=torch.zeros(R, 3), dirs=torch.zeros(R, 3), z=z1, dt=torch.zeros(R, S1),
                   mask=pm(nr1, S1), ray_fixed_dt=fixed)
    b = RaySamples(origins=torch.zeros(R, 3), dirs=torch.zeros(R, 3), z=z2, dt=torch.zeros(R, S2),
                   mask=pm(nr2, S2), ray_fixed_dt=fixed)
    if carry:
        a = a.with_sdf(torch.from_numpy(rng.normal(size=(R, S1)).astype(np.float32)))
        b = b.with_sdf(torch.from_numpy(rng.normal(size=(R, S2)).astype(np.float32)))
    t_exit = torch.from_numpy(rng.uniform(0.0, 0.4, (R, 1)).astype(np.float32))
    got = isp.merge_samples_cuda(a, b, t_exit)
    want = vr.combine_uniform_samples_with_imp(a, b, t_exit)
    for f in ("z", "dt", "mask", "sdf"):
        g, w = getattr(got, f), getattr(want, f)
        if not carry and f == "sdf":
            assert g is None and w is None
            continue
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f)
    assert (want.dt[2] > 0).any() and not want.mask[0].any()


def test_kernels_H1_H2_source_match_plain(emulated):
    """Kernels H1 (take) and H2 (scatter, and its backward through H1)
    against the plain index ops, exactly: a bucket with fill slots, a
    bucket that overflows (fewer slots than hits), rows of floats, bools
    (4-byte and odd row widths) and int64."""
    rng = np.random.default_rng(4)
    n = 30
    arrays = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
              torch.from_numpy(rng.normal(size=(n, 20)).astype(np.float32)),
              torch.from_numpy(rng.uniform(size=(n, 20)) < 0.5),
              torch.from_numpy(rng.uniform(size=(n, 7)) < 0.5),
              torch.from_numpy(rng.integers(0, 5, n)),
              torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))]
    hit = torch.from_numpy(rng.uniform(size=n) < 0.5)
    for size in (int(hit.sum()) + 5, int(hit.sum()) - 3):
        idx, _ = compaction.nonzero_static_plain(hit, size, n)
        got = compaction.take_rows_cuda(arrays, idx)
        for g, w in zip(got, compaction.take_rows_plain(arrays, idx)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        xs = [torch.from_numpy(rng.normal(size=(size,) + s).astype(np.float32))
              for s in ((3,), (3,), (1,), ())]
        fills = (0.0, 0.0, 0.0, 1.0)
        got = compaction.scatter_rows_cuda(xs, idx, n, fills)
        for g, w in zip(got, compaction.scatter_rows_plain(xs, idx, n, fills)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        # the autograd function routed to the kernels: backward is H1
        leaves = [x.clone().requires_grad_(True) for x in xs]
        cots = [torch.from_numpy(rng.normal(size=g.shape).astype(np.float32)) for g in got]
        launches = (compaction.take_rows_cuda.launches, compaction.scatter_rows_cuda.launches)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: cuda_fn)
            outs = compaction.scatter_rows(leaves, idx, n, fills)
            torch.autograd.backward(outs, cots)
        assert (compaction.take_rows_cuda.launches, compaction.scatter_rows_cuda.launches) == (
            launches[0] + 1, launches[1] + 1)
        for leaf, c in zip(leaves, cots):
            want = torch.cat([c, torch.zeros((1,) + c.shape[1:])])[idx]
            np.testing.assert_array_equal(leaf.grad.numpy(), want.numpy())


@pytest.mark.parametrize("carry", [False, True])
def test_importance_stage_through_the_kernel_sources_matches_plain(emulated, monkeypatch, carry):
    """``importance_sampling_sdf_model`` (two rounds of E1, two merges of
    E2: four launches) from the kernel sources, with jitter, against the
    plain stage: the masks equal, z and dt to 1e-6, the carried sdf to 1e-6
    (an analytic sphere SDF of the samples' positions)."""
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp

    rng = np.random.default_rng(12)
    R, S, n = 45, 24, 8
    nr = torch.from_numpy(rng.integers(0, S + 1, R))
    nr[0], nr[1] = 0, S
    smp, _, t_exit = _imp_batch(rng, R, S, nr)
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32)), dim=-1)
    smp = dataclasses.replace(smp, origins=-0.8 * dirs, dirs=dirs)
    mov = 1.0 / (n + 1) / 2.0
    jit = tuple(torch.from_numpy(rng.uniform(-mov, mov, (R, n)).astype(np.float32))
                for _ in range(2))

    def sphere(p, _m):
        return torch.linalg.norm(p, dim=-1) - 0.3

    want = isp.importance_sampling_sdf_model(sphere, smp, t_exit, n, jitter=jit, carry_sdf=carry)
    launches = (isp.importance_round_cuda.launches, isp.merge_samples_cuda.launches)
    monkeypatch.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: cuda_fn)
    got = isp.importance_sampling_sdf_model(sphere, smp, t_exit, n, jitter=jit, carry_sdf=carry)
    assert (isp.importance_round_cuda.launches, isp.merge_samples_cuda.launches) == (
        launches[0] + 2, launches[1] + 2)
    np.testing.assert_array_equal(got.mask.numpy(), want.mask.numpy())
    for f in ("z", "dt") + (("sdf",) if carry else ()):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), atol=1e-6,
                                   rtol=0, err_msg=f)
    assert (got.sdf is None) == (not carry)


@pytest.mark.parametrize("d,K,levels", [(3, 4, (0, 2)), (3, 4, (1, 2)), (4, 4, (2, 3)),
                                        (3, 3, (1, 3))])
def test_kernels_F_G_parity_source_match_plain(emulated, d, K, levels):
    """Kernels F and G with alternating-level table gradients ``levels =
    (phase, period)``: the frozen levels of the table gradient are exactly
    zero, the active ones equal the same kernel without parity (1e-5 of the
    level's largest |value|: atomics in no fixed order) and the plain
    version with parity; G's feature cotangent is unchanged at every
    level."""
    rng = np.random.default_rng(d * 13 + K + levels[0])
    spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=2 ** 10, nr_levels=4,
                                  concat_points_scaling=1e-3)
    prm = pe.init_encoding_params(torch.Generator().manual_seed(3), spec, "cpu")
    table = prm["lattice_values"] * 1e3
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (200, d)).astype(np.float32))
    scales, E, _ = pe.encoding_constants(spec, None, "cpu")
    args = (pts, table, prm["shift_per_level"], scales, torch.tensor([1.0, 0.8, 0.5, 0.2]), E, K)
    g = torch.from_numpy(rng.normal(size=(200, 2 * K + d)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(200, d)).astype(np.float32))
    phase, period = levels
    launches = (pe.encode_table_grad_cuda.launches, pe.encode_double_backward_cuda.launches)
    got_f = pe.encode_table_grad_cuda(*args, g, levels)
    all_f = pe.encode_table_grad_cuda(*args, g)
    plain_f = pe.encode_table_grad_plain(*args, g, levels)
    got_g, dg = pe.encode_double_backward_cuda(*args, 1e-3, True, g, u, levels)
    all_g, dg_all = pe.encode_double_backward_cuda(*args, 1e-3, True, g, u)
    plain_g, dg_plain = pe.encode_double_backward_plain(*args, 1e-3, True, g, u, levels)
    for got, full, plain in ((got_f, all_f, plain_f), (got_g, all_g, plain_g)):
        for lvl in range(table.shape[0]):
            if lvl < K and lvl % period == phase:
                scale = float(full[lvl].abs().max())
                assert scale > 0
                for want in (full, plain):
                    np.testing.assert_allclose(got[lvl].numpy(), want[lvl].numpy(),
                                               atol=1e-5 * scale, rtol=0)
            else:
                assert float(got[lvl].abs().max()) == 0.0 == float(plain[lvl].abs().max())
    np.testing.assert_array_equal(dg.numpy(), dg_all.numpy())
    np.testing.assert_allclose(dg.numpy(), dg_plain.numpy(),
                               atol=1e-6 * float(dg_plain.abs().max()))
    assert (pe.encode_table_grad_cuda.launches, pe.encode_double_backward_cuda.launches) == (
        launches[0] + 2, launches[1] + 2)


def _lod_batch(rng, R, S):
    """A carried-sdf batch for the train-time LOD: prefix masks with empty,
    full, one-sample and short rays; a ray inside the surface (weights
    underflow to exact ties at 0); a ray whose scores all tie; carried sdf
    at the invalid slots as the merge leaves it (arbitrary values)."""
    nr = torch.from_numpy(rng.integers(0, S + 1, R))
    nr[0], nr[1], nr[2], nr[3], nr[4] = 0, S, 1, 5, S
    mask = prefix_mask(nr, S)
    z = torch.from_numpy(np.sort(rng.uniform(0.5, 1.5, (R, S)), axis=1).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.002, 0.02, (R, S)).astype(np.float32))
    dt = torch.where(mask, dt, torch.zeros_like(dt))
    dt[5, int(nr[5]) - 1] = 0.0 if int(nr[5]) > 0 else dt[5, 0]  # a last sample at t_exit
    sdf = torch.from_numpy((0.05 - 0.1 * rng.uniform(size=(R, 1)) - (z.numpy() - 1.0) * 0.2
                            + rng.normal(0, 0.003, (R, S))).astype(np.float32))
    sdf[4] = -1.0  # inside: alpha 1, the transmittance underflows
    sdf = torch.where(mask, sdf, torch.from_numpy(rng.uniform(-5, 1e3, (R, S)).astype(np.float32)))
    scores = torch.from_numpy(rng.uniform(size=(R, S)).astype(np.float32))
    scores[6] = 0.5
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32)), dim=-1)
    smp = RaySamples(origins=torch.zeros(R, 3), dirs=dirs, z=z, dt=dt, mask=mask,
                     ray_fixed_dt=torch.full((R,), 0.01))
    return smp, sdf, scores


@pytest.mark.parametrize("S,K,E", [(70, 24, 8), (40, 40, 0), (37, 6, 3)])
def test_kernel_L_source_matches_plain(emulated, S, K, E):
    """Kernel L (fd cos, the ranking weights' warp scan, top-K and the
    extras by rank) against its plain version: cos_fd bit for bit, sel
    exactly (ties by the lower index, as ``lax.top_k``), on empty, short,
    one-sample and full rays, a last sample with dt 0 and exact ties."""
    rng = np.random.default_rng(S + K)
    smp, sdf, scores = _lod_batch(rng, 41, S)
    launches = vr.train_lod_select_cuda.launches
    cos_k, sel_k = vr.train_lod_select_cuda(smp, sdf, 400.0, 0.6, scores, K, E)
    cos_p, sel_p = vr.train_lod_select_plain(smp, sdf, 400.0, 0.6, scores, K, E)
    assert vr.train_lod_select_cuda.launches == launches + 1
    np.testing.assert_array_equal(cos_k.numpy(), cos_p.numpy())
    np.testing.assert_array_equal(sel_k.numpy(), sel_p.numpy())
    assert sel_k.shape == (41, K + E)
    # a ray with K + E valid samples selects each slot once; a shorter one
    # repeats slots, as lax.top_k does over the tied -1s
    nr = smp.mask.sum(1).numpy()
    for row, n in zip(sel_k.numpy(), nr):
        assert (len(set(row.tolist())) == K + E) == (n >= K + E or E == 0), (row, n)


def test_kernels_D2_source_match_plain(emulated):
    """Kernel D2 (the mixed chain's weights and the selected slots'
    integration) and D2' (its VJP in the fine set's sdf, gradient and rgb)
    against their plain versions (autograd of the plain forward), with
    random cotangents on every output: to 1e-6, and to 1e-5 of each
    gradient's largest |value|."""
    rng = np.random.default_rng(21)
    R, S, K, E = 41, 70, 12, 4
    smp, sdf, scores = _lod_batch(rng, R, S)
    cos_fd, sel = vr.train_lod_select_plain(smp, sdf, 400.0, 0.6, scores, K, E)
    n = R * (K + E)
    sdf_c = torch.from_numpy(rng.uniform(-0.05, 0.05, (n, 1)).astype(np.float32))
    grads_c = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    rgb_c = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    args = (smp, sdf, cos_fd, sel, sdf_c, grads_c, rgb_c, 400.0, 0.6)
    got = vr.neus_render_mixed_cuda(*args)
    want = vr.neus_render_mixed_plain(*args)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.reshape(a.shape).numpy(), atol=1e-6, rtol=0)
    cots = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for shape in ((R, S), (R, 1), (R,), (R, 3), (R, 3))]
    got = vr.neus_render_mixed_bwd_cuda(*args, *cots)
    want = vr.neus_render_mixed_bwd_plain(*args, *cots)
    valid = smp.flat_mask()[(torch.arange(R)[:, None] * S + sel).reshape(-1)]
    for a, b in zip(got, want):
        b = b.reshape(a.shape)
        assert float(b.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * float(b.abs().max()),
                                   rtol=0)
        assert float(a[~valid].abs().max()) == 0.0


@pytest.mark.parametrize("grid", ["planted", "sphere"])
def test_kernel_M_source_matches_plain(emulated, grid):
    """Kernel M (M1 counts the triangles per cube and block, M2 emits them
    at the blocks' offsets) against its plain version on a grid that is not
    a cube (10 x 11 x 12: cube ids cross block boundaries mid-row): the
    emitted world positions, weld keys and degenerate flags bit for bit
    before the welding, the welded mesh after it. The planted grid holds
    exact-level nodes, degenerate faces and the 1e-12 denominator floor."""
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc
    from test_torch_marching_tets import planted_grid, sphere_grid

    v = (planted_grid(13) if grid == "planted" else sphere_grid(13, 0.31))[:10, :11, :12]
    v = torch.from_numpy(np.ascontiguousarray(v))
    origin, spacing = (-0.5, -0.4, -0.3), (0.05, 0.04, 1.0 / 23)
    launches = (mc.mt_count_cuda.launches, mc.mt_emit_cuda.launches)
    counts, block_tris = mc.mt_count_cuda(v, 0.0)
    offsets, T = mc.mt_offsets(block_tris)
    emitted = mc.mt_emit_cuda(v, 0.0, counts, offsets, T, origin, spacing)
    assert (mc.mt_count_cuda.launches, mc.mt_emit_cuda.launches) == (launches[0] + 1,
                                                                     launches[1] + 1)
    want_counts, want_blocks = mc.mt_count_plain(v, 0.0, slab=3)
    assert torch.equal(counts, want_counts) and torch.equal(block_tris, want_blocks)
    assert len(block_tris) == 4  # 990 cubes, the last block partial
    want = mc.mt_emit_plain(v, 0.0, origin, spacing)
    assert T == want[2].shape[0] > 50
    for a, b in zip(emitted, want):
        assert torch.equal(a, b)
    if grid == "planted":
        assert emitted[2].sum() > 0
    Vk, Fk = mc.weld(*emitted)
    Vp, Fp = mc.marching_tetrahedra_plain(v, 0.0, origin, spacing)
    assert torch.equal(Vk, Vp) and torch.equal(Fk, Fp)
    assert torch.equal(mc.marching_tetrahedra_cuda(v, 0.0, origin, spacing)[1], Fp)


@pytest.mark.parametrize("P,kind", [(512, "shell"), (100, "shell"), (64, "empty")])
def test_kernel_C3_source_matches_plain(emulated, P, kind):
    """Kernel C3 (a warp per ray, rounds of 32 probes, a ballot) against
    its plain version: ``has`` and ``t_first`` exactly, with rays that miss
    the bound, rays with no occupied probe (t_exit), a probe count that is
    not a multiple of 32, and a ray count that is not a multiple of the 4
    rays per block."""
    cfg, _, _, state = _trace_state(V=16, n=301, seed=2)
    occ = _shell(16) if kind == "shell" else torch.zeros(16 ** 3, dtype=torch.bool)
    o, d = state["origins_f"][:-1], state["dirs_f"][:-1]
    _, te, _, tx, _ = Sphere().ray_intersection(o, d)
    launches = og.first_occupied_cuda.launches
    got = og.first_occupied_cuda(cfg, occ, o, d, te, tx, P)
    assert og.first_occupied_cuda.launches == launches + 1
    want = og.first_occupied_plain(cfg, occ, o, d, te, tx, P)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    has = want[1]
    assert (0 < int(has.sum()) < has.numel()) if kind == "shell" else not has.any()


def test_kernel_J3_source_matches_plain(emulated):
    """Kernel J3 against its plain version on cloned position state: the
    full-state form (no index list) with and without the field, and the
    bucket form (an index list with fill slots, the sdf store and the next
    positions), with rays that converge and rays that leave the sphere:
    positions, flags, sdf and the slots' positions equal."""
    cfg, _, field, s0 = _trace_state(V=32, n=300)
    R = s0["t_f"].shape[0] - 1
    pos0 = s0["origins_f"] + s0["t_f"][:, None] * s0["dirs_f"]
    bound = st._sphere_bound(Sphere())
    rng = np.random.default_rng(4)

    def state():
        return dict(dirs_f=s0["dirs_f"].clone(), pos_f=pos0.clone(),
                    alive_f=s0["alive_f"].clone(), conv_f=torch.zeros(R + 1, dtype=torch.bool),
                    sdf_f=torch.zeros(R + 1))

    ks, ps = state(), state()
    idx, _ = compaction.nonzero_static_plain(s0["alive_f"][:R], 320, R)  # fill slots at the end
    assert int((idx == R).sum()) > 0
    for it, (rows, fld, store) in enumerate(((None, field, False), (None, None, False),
                                             (idx, field, True), (idx, field, True))):
        B = R if rows is None else rows.shape[0]
        sdf = torch.from_numpy(rng.uniform(-0.02, 0.25, B).astype(np.float32))
        sdf[::9] = 1e-5  # converge some rays
        outs = []
        for fn, s in ((st.trace_step_pos_cuda, ks), (st.trace_step_pos_plain, ps)):
            st_in = (s["pos_f"] if rows is not None else s["pos_f"][:R].contiguous(),
                     s["alive_f"] if rows is not None else s["alive_f"][:R].contiguous(),
                     s["conv_f"] if rows is not None else s["conv_f"][:R].contiguous())
            d = s["dirs_f"] if rows is not None else s["dirs_f"][:R].contiguous()
            outs.append((fn(rows, sdf, d, *st_in, s["sdf_f"] if store else None, fld, cfg,
                            0.9, 2e-4, bound, pos_out=rows is not None), st_in))
            if rows is None:  # write the row views back into the padded state
                s["pos_f"][:R], s["alive_f"][:R], s["conv_f"][:R] = st_in
        (out_k, _), (out_p, _) = outs
        if rows is not None:
            np.testing.assert_array_equal(out_k.numpy(), out_p.numpy())
        for k in ks:
            np.testing.assert_array_equal(ks[k].numpy(), ps[k].numpy(), err_msg=f"{it} {k}")
    r = ps["pos_f"][:R].norm(dim=-1)
    died = s0["alive_f"][:R] & ~ps["alive_f"][:R]
    assert int(ps["conv_f"].sum()) > 0 and int(died.sum()) > 0 and bool((r[died] >= 0.5).all())


@pytest.mark.parametrize("jitter", [False, True])
def test_kernel_C2_source_matches_plain(emulated, jitter):
    """Kernel C2 (a thread per sample slot) against its plain version:
    z, dt, mask and ray_fixed_dt exactly, on rays planted with 0, 1, 2 and
    S samples (and one at exactly 3), random ranges and misses."""
    S, md = 16, 0.05
    rng = np.random.default_rng(7 + jitter)
    R = 70
    te = rng.uniform(0.0, 0.4, R).astype(np.float32)
    dist = rng.uniform(0.0, 1.2, R).astype(np.float32)
    dist[:6] = [0.0, 0.04, 0.07, 0.12, 0.151, 2.0]  # nr 0, 0, 1, 2, 3, S
    te[6] = 0.0  # a miss: t_entry = t_exit = 0
    dist[6] = 0.0
    tx = (te + dist).astype(np.float32)
    te_t, tx_t = torch.from_numpy(te)[:, None], torch.from_numpy(tx)[:, None]
    start = torch.from_numpy(rng.uniform(size=(R, 1)).astype(np.float32)) if jitter else None
    launches = rs.samples_fg_cuda.launches
    got = rs.samples_fg_cuda(te_t, tx_t, md, S, start)
    assert rs.samples_fg_cuda.launches == launches + 1
    want = rs.samples_fg_plain(te_t, tx_t, md, S, start)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    counts = want[2].sum(dim=1)
    assert counts[:6].tolist() == [0, 0, 0, 0, 3, S]
    assert int((counts == S).sum()) > 10


def test_kernel_I2_source_matches_plain(emulated):
    """Kernel I2 on the stratified probes of one update (distinct voxels):
    values and occupancy exactly, with voxels that empty and that fill."""
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    rng = np.random.default_rng(8)
    _, lin = og.grid_points_plain(cfg, 1500, 3, None, "cpu")
    density = torch.from_numpy(rng.exponential(2e-3, (1500, 1)).astype(np.float32))
    vals0 = torch.from_numpy(rng.uniform(0, 4e-3, 16 ** 3).astype(np.float32))
    occ0 = vals0 > 1e-3
    grids = [og.OccupancyGridState(values=vals0.clone(), occupancy=occ0.clone()) for _ in range(2)]
    launches = og.density_update_cuda.launches
    og.density_update_cuda(cfg, grids[0], lin, density, 0.7, 1e-3)
    assert og.density_update_cuda.launches == launches + 1
    og.density_update_plain(cfg, grids[1], lin, density, 0.7, 1e-3)
    np.testing.assert_array_equal(grids[0].values.numpy(), grids[1].values.numpy())
    np.testing.assert_array_equal(grids[0].occupancy.numpy(), grids[1].occupancy.numpy())
    flips = grids[1].occupancy != occ0
    assert int((flips & occ0).sum()) > 10 and int((flips & ~occ0).sum()) > 10


def test_plain_tracers_through_the_kernel_sources_match_plain(emulated, monkeypatch):
    """``sphere_trace`` and ``sphere_trace_compacted`` with C3, J0, J3 and
    H0 all taken from the kernel sources (on CPU tensors) give the plain
    path's trace exactly."""
    cfg, occ, _, s0 = _trace_state(n=200)
    o, d = s0["origins_f"][:-1], s0["dirs_f"][:-1]
    grid = og.OccupancyGridState(values=torch.zeros(cfg.nr_voxels), occupancy=occ)

    def sdf(p):
        return torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]) - 0.25

    runs = {}
    for route in ("plain", "kernel"):
        if route == "kernel":
            monkeypatch.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: cuda_fn)
        runs[route] = (st.sphere_trace(sdf, o, d, Sphere(), 8, grid_cfg=cfg, grid=grid),
                       st.sphere_trace_compacted(sdf, o, d, Sphere(), 3, 3, grid_cfg=cfg,
                                                 grid=grid, first_bucket_fraction=1.0))
    for got, want in zip(runs["kernel"], runs["plain"]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(runs["plain"][0][2].sum()) > 20
