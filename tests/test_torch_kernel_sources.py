"""The CUDA sources of kernels A-D, F, G, D' and I, compiled for the CPU with g++ against a
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
from permuto_sdf_tpu_torch.ops import occupancy_grid as og
from permuto_sdf_tpu_torch.ops import permuto_encoding as pe
from permuto_sdf_tpu_torch.ops import volume_rendering as vr
from permuto_sdf_tpu_torch.ops.ray_primitives import Sphere
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples, prefix_mask

_EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_cpu_emulation")


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """Build the three kernel libraries for the CPU (in parallel)."""
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
