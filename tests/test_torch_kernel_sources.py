"""The CUDA sources of kernels A-D, F, G, D', I, J0-J2, H0-H2, E1, E2 (its three
forms), L, D2, D2', M, C3, J3, J3f, J2f, C2 and I2 (and H0's one-launch cluster
form, ``profiling/h0_variants.cu``, and If's shapes, which the port measured
and did not keep),
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
# kernel H0's one-launch cluster form and kernel If's persistent shapes,
# measured and not kept by the port
_H0_VARIANTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "profiling", "h0_variants.cu")
_REFRESH_VARIANT = os.path.join(os.path.dirname(_H0_VARIANTS), "grid_refresh_variant.cu")


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """Build the kernel libraries for the CPU (in parallel)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available: cannot compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("cpu_kernels")

    def build(source):
        name = os.path.splitext(os.path.basename(source))[0]
        lib = out / f"lib{name}.so"
        cmd = [gxx, "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
               "-Wno-unknown-pragmas", "-I", _EMU, "-I", str(kernels.CSRC), "-o", str(lib),
               source]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        return name, lib

    sources = [str(kernels.CSRC / f"{name}.cu") for name in kernels.LIBRARIES] + [
        _H0_VARIANTS, _REFRESH_VARIANT]
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(ex.map(build, sources))
    return {name: (kernels.declare(ctypes.CDLL(str(path)), name) if name in kernels.LIBRARIES
                   else ctypes.CDLL(str(path))) for name, path in libs.items()}


@pytest.fixture
def emulated(cpu_kernels, monkeypatch):
    """Route the wrappers' launches to the CPU-compiled libraries."""
    monkeypatch.setattr(kernels, "load", lambda name: cpu_kernels[name])
    monkeypatch.setattr(kernels, "current_stream", lambda device: ctypes.c_void_p(None))


@pytest.mark.parametrize("d,K,window,N,concat", [
    (3, 4, False, 300, True), (3, 3, True, 300, True), (4, 4, True, 300, True),
    (3, 4, False, 257, True),  # N not a multiple of A's or B's point tile
    (3, 2, False, 300, False),  # K < L, concat off
    (4, 3, True, 257, True),  # d = 4 with a window, K < L, a ragged tile
    (4, 4, True, 300, False)])
def test_kernels_A_B_source_matches_plain(emulated, d, K, window, N, concat):
    rng = np.random.default_rng(d * 10 + K)
    spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=2 ** 18, nr_levels=4,
                                  concat_points_scaling=1e-3)
    prm = pe.init_encoding_params(torch.Generator().manual_seed(1), spec, "cpu")
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (N, d)).astype(np.float32))
    scales, E, _ = pe.encoding_constants(spec, None, "cpu")
    win = torch.tensor([1.0, 0.7, 0.3, 0.0]) if window else None
    args = (pts, prm["lattice_values"], prm["shift_per_level"], scales, win, E, K, 1e-3,
            concat)
    launches = pe.encode_fwd_cuda.launches
    got = pe.encode_fwd_cuda(*args)
    assert pe.encode_fwd_cuda.launches == launches + 1
    assert got.shape == (N, 2 * K + (d if concat else 0))
    np.testing.assert_array_equal(got.numpy(), pe.encode_fwd_plain(*args).numpy())
    g = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    np.testing.assert_array_equal(pe.encode_point_grad_cuda(*args, g).numpy(),
                                  pe.encode_point_grad_plain(*args, g).numpy())


def test_kernels_A_B_interleaved_table_follows_the_table(emulated):
    """A, B and G read the table as the cached [L, C, 2] copy: made once per
    table state (a detached alias, as the trainers pass, reuses it), made
    again after an in-place Adam update and for a freshly loaded table, and
    A's, B's and G's outputs equal the plain versions' after each (G's
    feature cotangent gathers from the copy: a stale one would show)."""
    import io
    import weakref

    from permuto_sdf_tpu_torch.train.optimizers import ManualAdam

    rng = np.random.default_rng(5)
    spec = pe.PermutoEncodingSpec(pos_dim=3, capacity=2 ** 10, nr_levels=4,
                                  concat_points_scaling=1e-3)
    params = pe.init_encoding_params(torch.Generator().manual_seed(3), spec, "cpu")
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (100, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(100, 11)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(100, 3)).astype(np.float32))
    scales, E, _ = pe.encoding_constants(spec, None, "cpu")

    def check(copies_made, table=None):
        copies = pe.interleaved_table.copies
        table = params["lattice_values"] if table is None else table
        args = (pts, table, params["shift_per_level"], scales, None, E, 4, 1e-3, True)
        with torch.no_grad():
            np.testing.assert_array_equal(pe.encode_fwd_cuda(*args).numpy(),
                                          pe.encode_fwd_plain(*args).numpy())
            np.testing.assert_array_equal(pe.encode_point_grad_cuda(*args, g).numpy(),
                                          pe.encode_point_grad_plain(*args, g).numpy())
            (dt_k, dg_k), (dt_p, dg_p) = (pe.encode_double_backward_cuda(*args, g, u),
                                          pe.encode_double_backward_plain(*args, g, u))
            np.testing.assert_allclose(dg_k.numpy(), dg_p.numpy(),
                                       atol=1e-6 * float(dg_p.abs().max()), rtol=0)
            np.testing.assert_allclose(dt_k.numpy(), dt_p.numpy(),
                                       atol=1e-5 * float(dt_p.abs().max()), rtol=0)
        assert pe.interleaved_table.copies == copies + copies_made

    check(1)
    check(0)  # the same table state: the cached copy
    check(0, params["lattice_values"].detach().requires_grad_(True))
    adam = ManualAdam()
    grads = {"lattice_values": torch.from_numpy(rng.normal(size=(4, 2, 2 ** 10)).astype(
        np.float32)), "shift_per_level": None}
    before = params["lattice_values"].clone()
    adam.update(grads, adam.init(params), params, 1e-3)
    assert not torch.equal(before, params["lattice_values"])
    check(1)
    check(0, params["lattice_values"].detach().requires_grad_(True))
    buf = io.BytesIO()
    torch.save(params["lattice_values"] * 2.0, buf)
    buf.seek(0)
    old = weakref.ref(params["lattice_values"])
    params["lattice_values"] = torch.load(buf)
    check(1)
    assert old() is None  # the replaced table is gone, and its copy with it
    assert all(ref() is not None for ref, _, _ in pe._INTERLEAVED.values())


def _c_rays(rng, R):
    o = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    o = o / o.norm(dim=-1, keepdim=True) * 1.3
    tgt = torch.from_numpy(rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32))
    dr = torch.nn.functional.normalize(tgt - o, dim=-1)
    _, te, _, tx, _ = Sphere().ray_intersection(o, dr)
    return o, dr, te, tx


def _c_placements(cfg, occ, o, dr, te, tx, min_dist, S, P, start):
    """The probe rounds kernel C's valid samples land in, and how many
    samples lie past the last occupied probe (searchsorted returns P: the
    index is clamped to P - 1), replayed from the plain version's math."""
    occ_p, seg = og._probe_occupancy(cfg, occ, o, dr, te, tx, P)
    counts = torch.cumsum(occ_p.to(torch.int32), dim=-1)
    z, _, mask, fixed = og.probe_sampler_plain(cfg, occ, o, dr, te, tx, min_dist, S, P, start)
    st = start.reshape(-1, 1) if start is not None else 0.5
    arc = (torch.arange(S, dtype=torch.float32)[None, :] + st) * fixed[:, None]
    idx = torch.searchsorted(counts.to(torch.float32) * seg[:, None], arc.contiguous(),
                             right=True)
    rounds = torch.unique(torch.clamp(idx, max=P - 1)[mask] // 32)
    return rounds, int((idx[mask] == P).sum())


@pytest.mark.parametrize("S,P,min_dist,density,R", [
    pytest.param(64, 512, 1e-4, 0.3, 37, id="64-512-0.0001"),
    pytest.param(40, 64, 0.02, 0.3, 37, id="40-64-0.02"),  # the generic path (P != 512)
    (64, 512, 1e-4, 0.95, 9),  # dense: samples land in every round of 32 probes
    (40, 96, 0.02, 0.95, 6)])  # generic and dense, fewer rays than a block holds
def test_kernel_C_source_matches_plain(emulated, S, P, min_dist, density, R):
    rng = np.random.default_rng(S)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    o, dr, te, tx = _c_rays(rng, R)  # R not a multiple of the 4 rays per block
    occ = torch.from_numpy(rng.uniform(size=16 ** 3) < density)
    got = og.probe_sampler_cuda(cfg, occ, o, dr, te, tx, min_dist, S, P)
    want = og.probe_sampler_plain(cfg, occ, o, dr, te, tx, min_dist, S, P)
    assert want[2].sum() > min(50, 3 * R)
    if density > 0.5:
        rounds, _ = _c_placements(cfg, occ, o, dr, te, tx, min_dist, S, P, None)
        assert rounds.numel() == P // 32
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


@pytest.mark.parametrize("S", [20, 32, 45])
def test_kernel_D_run_lengths_match_plain(emulated, monkeypatch, S):
    """Kernel D's lane runs at S below a warp (runs of 1, some lanes idle),
    at S = 32 and at S not a multiple of the run length (45: runs of 2,
    the last one short; 16-, 4- and 1-byte staging), both modes through
    the autograd functions, forward within 1e-6 of the plain version and
    the backward (kernel D') within 1e-5 of each gradient's largest
    |value|."""
    rng = np.random.default_rng(S)
    R = 40
    nr = torch.from_numpy(rng.integers(0, S + 1, R))
    nr[0], nr[1], nr[2] = 0, S, 1
    dirs = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32)), dim=-1)
    smp = RaySamples(origins=torch.zeros(R, 3), dirs=dirs, z=torch.zeros((R, S)),
                     dt=torch.from_numpy(rng.uniform(0, 0.02, (R, S)).astype(np.float32)),
                     mask=prefix_mask(nr, S), ray_fixed_dt=torch.zeros(R))
    sdf = torch.from_numpy(rng.uniform(-0.05, 0.05, (R, S)).astype(np.float32))
    dens = torch.from_numpy(rng.uniform(0, 50, (R, S)).astype(np.float32))
    grads = torch.from_numpy(rng.normal(size=(R * S, 3)).astype(np.float32))
    rgb = torch.from_numpy(rng.uniform(size=(R * S, 3)).astype(np.float32))

    def run(on_card):
        monkeypatch.setattr(vr, "_on_cuda", lambda samples: on_card)
        leaves = [t.clone().requires_grad_(True) for t in (sdf, grads, rgb, dens)]
        outs = vr.neus_render(smp, leaves[0], leaves[1], leaves[2], 400.0, 0.7)
        outs = outs + vr.nerf_render(smp, leaves[3], leaves[2])
        cots = [torch.from_numpy(np.random.default_rng(1).normal(size=o.shape).astype(
            np.float32)) for o in outs]
        torch.autograd.backward(outs, cots)
        return [o.detach() for o in outs], [leaf.grad for leaf in leaves]

    launches = (vr.render_weights_cuda.launches, vr.render_weights_bwd_cuda.launches)
    got, got_g = run(True)
    assert (vr.render_weights_cuda.launches, vr.render_weights_bwd_cuda.launches) == (
        launches[0] + 2, launches[1] + 2)
    want, want_g = run(False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * float(b.abs().max()),
                                   rtol=0)


def _fg_points(rng, n, d, clustered):
    """Uniform points in [-0.5, 0.5]^d, or (clustered) points in a cube of
    side 0.01: then a warp's 32 lanes share their slots at every level
    coarser than the cube, and kernels F and G combine their atomics."""
    if clustered:
        return torch.from_numpy((0.1 + rng.uniform(0.0, 0.01, (n, d))).astype(np.float32))
    return torch.from_numpy(rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32))


def _close_per_level(a, b):
    """Each level of a table gradient within 1e-5 of its largest |value|."""
    for lvl in range(a.shape[0]):
        scale = float(b[lvl].abs().max())
        np.testing.assert_allclose(a[lvl].numpy(), b[lvl].numpy(),
                                   atol=1e-5 * scale + 1e-12, rtol=0)


@pytest.mark.parametrize("d,K,window,N,clustered", [
    pytest.param(3, 4, True, 200, False, id="3-4-True"),
    pytest.param(4, 3, False, 200, False, id="4-3-False"),
    (3, 4, True, 96, True),  # clustered: the lanes combine their atomics; whole tiles
    (3, 3, True, 77, True),  # clustered, K < L, a zero-weight level, a ragged tile
    (4, 4, False, 45, True)])  # d = 4 clustered, a ragged tile
def test_kernels_F_G_source_match_plain(emulated, d, K, window, N, clustered):
    """Kernel F (table gradient) and kernel G (double backward) against
    their plain versions. Both add into the table with atomicAdd in no fixed
    order, after summing the terms of a warp's lanes that share a slot, so
    each level of the table gradient is held to 1e-5 of its largest
    |value|; G's feature cotangent is a gather and matches to 1e-6."""
    rng = np.random.default_rng(d * 7 + K + (N if clustered else 0))
    spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=2 ** 10, nr_levels=4,
                                  concat_points_scaling=1e-3)
    prm = pe.init_encoding_params(torch.Generator().manual_seed(2), spec, "cpu")
    table = prm["lattice_values"] * 1e3
    pts = _fg_points(rng, N, d, clustered)
    scales, E, _ = pe.encoding_constants(spec, None, "cpu")
    win = torch.tensor([1.0, 0.6, 0.2, 0.0]) if window else None
    args = (pts, table, prm["shift_per_level"], scales, win, E, K)
    if clustered:  # the first tile's points share a slot at the coarsest level
        ids = pe.flat_slot_ids(pts[:32], table, prm["shift_per_level"], scales, E, K)
        assert torch.unique(ids[0, 0]).numel() < ids.shape[2] // 4
    g = torch.from_numpy(rng.normal(size=(N, 2 * K + d)).astype(np.float32))
    launches = (pe.encode_table_grad_cuda.launches, pe.encode_double_backward_cuda.launches)
    _close_per_level(pe.encode_table_grad_cuda(*args, g), pe.encode_table_grad_plain(*args, g))
    u = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
    dt_k, dg_k = pe.encode_double_backward_cuda(*args, 1e-3, True, g, u)
    dt_p, dg_p = pe.encode_double_backward_plain(*args, 1e-3, True, g, u)
    _close_per_level(dt_k, dt_p)
    np.testing.assert_allclose(dg_k.numpy(), dg_p.numpy(), atol=1e-6 * float(dg_p.abs().max()))
    assert (pe.encode_table_grad_cuda.launches, pe.encode_double_backward_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.parametrize("mode,S,masks", [
    pytest.param(0, 70, "prefix", id="0"), pytest.param(1, 70, "ones", id="1"),
    (0, 96, "prefix"), (1, 96, "ones"), (0, 32, "prefix"), (1, 32, "ones"),
    (0, 70, "random"), (1, 96, "random"), (0, 32, "random")])
def test_kernel_D_backward_source_matches_plain(emulated, mode, S, masks):
    """Kernel D' (each ray's rows staged once, one warp scan of the runs'
    transmittance products, one reverse warp scan of the runs' composed
    affine maps) against the plain backward (autograd of the plain
    forward), with random cotangents on every output; to 1e-5 of each
    gradient's largest |value|. S = 70 gives runs of 3 with the last lanes
    empty and rows that are not 16-byte aligned (the 4-byte stores), S = 96
    whole 16-byte rows, S = 32 a sample a lane read without the staging
    (as up to S = 64);
    prefix masks as the samplers make them, full ones, and random masks
    that are not prefixes (invalid samples inside a ray, valid ones past
    nr - 1)."""
    seed = 11 + mode + (0 if S == 70 else S) + (7 if masks == "random" else 0)
    rng = np.random.default_rng(seed)  # the first two cases' seeds as before
    R = 50
    nr = torch.from_numpy(rng.integers(0, S + 1, R))
    nr[0], nr[1], nr[2] = 0, S, 1
    if masks == "prefix":
        mask = prefix_mask(nr, S)
    elif masks == "ones":
        mask = torch.ones((R, S), dtype=torch.bool)
    else:
        mask = torch.from_numpy(rng.uniform(size=(R, S)) < rng.uniform(0.2, 0.9, (R, 1)))
        mask[0] = False
        assert not torch.equal(mask, prefix_mask(mask.sum(1), S))
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


def test_kernel_C_wrapper_refuses_what_the_kernel_cannot_take():
    """Probe counts beyond one ballot per lane, and t_entry, t_exit or start
    of another ray count (the kernel would read past them), raise before any
    launch."""
    rng = np.random.default_rng(9)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    o, dr, te, tx = _c_rays(rng, 8)
    occ = torch.ones(16 ** 3, dtype=torch.bool)
    for P in (48, 1056):
        with pytest.raises(ValueError, match="multiple of 32 up to 1024"):
            og.probe_sampler_cuda(cfg, occ, o, dr, te, tx, 0.02, 16, P)
    for args in ((te[:-1], tx, None), (te, tx, torch.zeros(9)), (te, tx.double(), None)):
        with pytest.raises(ValueError, match="float32 rays"):
            og.probe_sampler_cuda(cfg, occ, o, dr, args[0], args[1], 0.02, 16, 64, args[2])


@pytest.mark.parametrize("kind,S,P,R", [
    ("uniform", 40, 64, 37), ("uniform", 64, 512, 13),
    ("near_one", 40, 64, 13),  # starts just below 1: samples past the last occupied probe
    ("near_one", 64, 512, 13)])
def test_kernel_C_jittered_start_source_matches_plain(emulated, kind, S, P, R):
    """Kernel C with the per-ray start of the training jitter."""
    rng = np.random.default_rng(5)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    o, dr, te, tx = _c_rays(rng, R)
    occ = torch.from_numpy(rng.uniform(size=16 ** 3) < 0.3)
    start = torch.from_numpy(rng.uniform(size=R).astype(np.float32))
    if kind == "near_one":
        start = torch.full((R,), float(np.nextafter(np.float32(1), np.float32(0))))
        assert _c_placements(cfg, occ, o, dr, te, tx, 0.02, S, P, start)[1] > 0
    got = og.probe_sampler_cuda(cfg, occ, o, dr, te, tx, 0.02, S, P, start)
    want = og.probe_sampler_plain(cfg, occ, o, dr, te, tx, 0.02, S, P, start)
    assert want[2].sum() > 50
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("V,cap,kind", [
    (16, 63, "sparse"), (32, 15, "sparse"), (32, 63, "shell"),
    (16, 15, "empty"), (16, 63, "full"), (16, 0, "sparse"), (16, 255, "sparse"),
    (20, 63, "sparse"), (20, 255, "shell"),  # V = 20: lines not a multiple of a block
    (15, 63, "sparse")])  # odd V: the scans meet at a middle voxel
def test_kernel_J0_source_matches_plain(emulated, V, cap, kind):
    """Kernel J0 (three separable passes) against the plain version (the
    JAX op's min-pool sweeps): the same integers."""
    rng = np.random.default_rng(V + cap)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=V)
    occ = {"sparse": lambda: torch.from_numpy(rng.uniform(size=V ** 3) < 0.002),
           "shell": lambda: _shell(V), "empty": lambda: torch.zeros(V ** 3, dtype=torch.bool),
           "full": lambda: torch.ones(V ** 3, dtype=torch.bool)}[kind]()
    launches = og.chebyshev_field_cuda.launches
    got = og.chebyshev_field_cuda(cfg, occ, cap)
    assert og.chebyshev_field_cuda.launches == launches + 1
    want = og.chebyshev_field_plain(cfg, occ, cap)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if kind == "empty":
        assert int(want.min()) == int(want.max()) == cap
    elif kind == "full" or cap == 0:
        assert int(want.max()) == 0
    else:
        assert 0 == int(want.min()) < 3 < int(want.max())


@pytest.fixture(scope="module")
def h0_cluster_variant(cpu_kernels):
    """The one-launch (thread-block cluster) form of kernel H0 that the port
    measured and did not keep (``profiling/h0_variants.cu``), built for the
    CPU with the kernels: the emulation runs a cluster's blocks together."""
    lib = cpu_kernels["h0_variants"]
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.psdf_compact_shape.argtypes = [I, I, I, I, P, P, I, I, ctypes.c_longlong, P, P, P]
    lib.psdf_compact_shape.restype = I
    return lib


@pytest.mark.parametrize("n,p,sizes", [(5000, 0.3, (100, 1500, 1523, 6000)), (0, 0.0, (0, 256)),
                                       (2048, 1.0, (2048,)), (777, 0.01, (256, 3)),
                                       (6500, 0.5, (64, 4095, 6501)),
                                       (3077, 0.7, (1, 2100, 3500))])
def test_kernel_H0_source_matches_plain(emulated, h0_cluster_variant, n, p, sizes):
    """Kernel H0 (tile counts, then the offsets and the in-block scan) and
    its one-launch cluster form (``profiling/h0_variants.cu``, clusters of 4
    blocks of 32 threads here, 2,048 elements a pass: n = 3,077 takes 2
    passes and 6,500 takes 4) against the plain version: the same indices
    in the same order, the fill value in the unused slots, and the true
    count; buckets below, at and above the count, a mask shorter than a
    tile, a ragged tail, the fill value n + 5 and the default, and the
    second mask fused in (mask & other, mask & ~other; one fill value a size
    in turns); and masks that do not start on an 8- or 16-byte boundary
    (the byte loads: the first size of each mode, all sizes for the
    cluster form)."""
    rng = np.random.default_rng(n)
    base = torch.from_numpy(rng.uniform(size=n + 1) < p)
    second = torch.from_numpy(rng.uniform(size=n + 1) < 0.5)
    for offset in (0, 1):
        mask, other = base[offset:offset + n], second[offset:offset + n]
        assert mask.is_contiguous() and mask.numel() == n
        for fused in (None, False, True):
            kw = {} if fused is None else dict(other=other, negate_other=fused)
            mode = 0 if fused is None else (2 if fused else 1)
            combined = mask if fused is None else mask & (~other if fused else other)
            count = int(combined.sum())
            for k, size in enumerate(sizes + (count,)):
                both = offset == 0 and fused is None
                for fill in (None, n + 5) if both else ((None, n + 5)[(k + offset) % 2],):
                    want = compaction.nonzero_static_plain(mask, size, fill, **kw)
                    assert int(want[1]) == count
                    np.testing.assert_array_equal(
                        want[0].numpy(), compaction.nonzero_static_plain(combined, size, fill)[0])
                    if offset == 0 or k == 0:
                        launches = compaction.nonzero_static_cuda.launches
                        got = compaction.nonzero_static_cuda(mask, size, fill, **kw)
                        assert compaction.nonzero_static_cuda.launches == launches + 1
                        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
                        assert int(got[1]) == count
                    idx = torch.full((size,), -1, dtype=torch.int64)
                    cnt = torch.zeros((1,), dtype=torch.int32)
                    assert h0_cluster_variant.psdf_compact_shape(
                        32, 1, 4, n, kernels.ptr(mask), kernels.ptr(other) if fused is not None
                        else None, mode, size, n if fill is None else fill, kernels.ptr(idx),
                        kernels.ptr(cnt), None) == 0
                    np.testing.assert_array_equal(idx.numpy(), want[0].numpy())
                    assert int(cnt) == count


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
    n_k, idx_k = st.jump_prepass_cuda(*args(ks), cfg, 16)
    n_p, idx_p = st.jump_prepass_plain(*args(ps), cfg, 16)
    for k in ks:
        np.testing.assert_array_equal(ks[k].numpy(), ps[k].numpy())
    np.testing.assert_array_equal(idx_k.numpy(), idx_p.numpy())
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


def _out_of_grid_lookups(cfg, field, s, jumps):
    """Rays whose chain of jumps reads the field inside the grid, then looks
    up a point outside it (where J1 reads nothing and jumps the cap)."""
    t, allow = s["t_f"].clone(), s["alive_f"].clone()
    inside_before = torch.zeros_like(allow)
    leaves = torch.zeros_like(allow)
    for _ in range(jumps):
        lin, inb = og.point_to_lin_idx(cfg, s["origins_f"] + t[:, None] * s["dirs_f"])
        leaves |= allow & ~inb & inside_before
        inside_before |= allow & inb
        k = torch.where(inb, field[lin.clamp(0, field.numel() - 1)].to(torch.int32), 63)
        allow = allow & (k > 1)
        t = torch.where(allow, t + (k - 1).to(t.dtype) * cfg.voxel_size, t)
    return int(leaves.sum())


@pytest.mark.parametrize("grid", ["shell", "leaves_grid"])
def test_kernel_J1_source_matches_plain(emulated, grid):
    """Kernel J1 against its plain version: t, the alive flags and the count
    bit for bit, and round 0's list (written by the same launch: a scan of
    the tiles' counts with look-back) equal to ``nonzero_static``'s at a
    bucket below, at and above the count, and past R (the fill R); on the
    shell grid, and on a grid smaller than the bound and moved off its
    centre, so that chains leave the grid and jump the cap."""
    cfg, _, field, s0 = _trace_state(n=600, seed=4)
    if grid == "leaves_grid":
        cfg = og.OccupancyGridConfig(nr_voxels_per_dim=32, grid_extent=0.8,
                                     grid_translation=(0.05, 0.0, -0.03))
        assert _out_of_grid_lookups(cfg, field, s0, 16) > 20
    R = s0["t_f"].shape[0] - 1
    for list_size in (R, R + 37):
        ks = {k: v.clone() for k, v in s0.items()}
        ps = {k: v.clone() for k, v in s0.items()}
        args = lambda s: (field, s["origins_f"], s["dirs_f"], s["texit_f"], s["t_f"],  # noqa: E731
                          s["alive_f"], cfg, 16, list_size)
        n_k, idx_k = st.jump_prepass_cuda(*args(ks))
        n_p, idx_p = st.jump_prepass_plain(*args(ps))
        for k in ks:
            np.testing.assert_array_equal(ks[k].numpy(), ps[k].numpy())
        count = int(n_p)
        assert int(n_k) == count and 0 < count < int(s0["alive_f"].sum())
        assert idx_k.shape == (list_size,)
        mask = ps["alive_f"][:R]
        for size in (count // 2, count, st.pow2_bucket(count, lo=64, hi=R), list_size):
            want, _ = compaction.nonzero_static_plain(mask, size, R)
            np.testing.assert_array_equal(idx_k[:size].numpy(), want.numpy())
        np.testing.assert_array_equal(idx_k.numpy(), idx_p.numpy())


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
    """The refresh kernels (I's entry 2, If) write the grid through ctypes,
    so their wrappers bump the tensors' version counters by hand (the
    distance-field cache keys on them); the plain paths' index writes bump
    them as well."""
    from permuto_sdf_tpu_torch.models.fields import SDFEval

    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    lin = torch.arange(100, dtype=torch.int32)
    sdf = torch.full((100,), 0.5)
    for fn in (og.grid_update_cuda, og.grid_update_plain):
        grid = og.make_occupancy_grid(cfg, device="cpu")
        before = grid.occupancy._version
        fn(cfg, grid, lin, sdf, 300.0, 1e-4)
        assert grid.occupancy._version > before
        assert not grid.occupancy[:100].any()
    sdf_cfg, params = _planted_sdf(4)
    for fn in (og.grid_refresh_cuda, og.grid_refresh_plain):
        grid = og.make_occupancy_grid(cfg, device="cpu")
        versions = (grid.values._version, grid.occupancy._version)
        fn(cfg, grid, SDFEval(sdf_cfg), (params, 50), 64, 3, None, 300.0, 1e-4)
        assert grid.values._version > versions[0] and grid.occupancy._version > versions[1]
        assert int((grid.values != 0).sum()) == 64 and not grid.occupancy.all()


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
                                             (8, 4, True, 1.0), (80, 40, False, 2.0),
                                             (128, 32, True, 1.0)])
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


@pytest.mark.parametrize("S,n", [(64, 16), (128, 32)])
def test_kernel_E1_zero_weight_rays_match_plain(emulated, S, n):
    """Kernel E1 on rays whose weights sum below the 1e-6 floor of the
    normalization: one valid sample (its alpha is 0: a weight sum of 0 and
    an all-zero CDF), or an sdf far outside the surface (every alpha
    ~1e-6, the floor reached with two valid samples), beside ordinary rays:
    masks equal, z_imp to 1e-6."""
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp

    rng = np.random.default_rng(S)
    R = 37
    nr = torch.from_numpy(rng.integers(2, S + 1, R))
    nr[:8], nr[8:12] = 1, 2
    smp, sdf, _ = _imp_batch(rng, R, S, nr)
    sdf[:24] = 5.0  # far outside: sigmoid saturates, alpha = 1e-6 / (1 + 1e-6)
    jit = torch.from_numpy(rng.uniform(-0.5, 0.5, (R, n)).astype(np.float32)) / (n + 1)
    z_k, m_k = isp.importance_round_cuda(smp, sdf, n, jit)
    z_p, m_p = isp.importance_round_plain(smp, sdf, n, jit)
    np.testing.assert_array_equal(m_k.numpy(), m_p.numpy())
    np.testing.assert_allclose(z_k.numpy(), z_p.numpy(), atol=1e-6, rtol=0)
    alpha = torch.clamp(vr.sdf2alpha_sectional(smp, sdf), 0.0, 1.0)
    w_sum = torch.where(smp.mask, alpha, 0.0)[:24].sum(dim=1)
    assert bool((w_sum[:8] == 0).all()) and bool((w_sum[8:12] < 1e-6).all())
    assert bool((w_sum[12:24] > 1e-6).all())


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


@pytest.mark.parametrize("carry", [False, True])
def test_kernel_E2_sorted_sets_merge_matches_plain(emulated, carry):
    """Kernel E2 on two ascending sets (the binary-search merge): ties
    within each set and across the two, rays with 0, 1 and all samples of
    either set valid; z, dt, mask and the carried sdf equal the plain
    merge's bit for bit."""
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp
    from permuto_sdf_tpu_torch.ops.ray_samples import prefix_mask as pm

    rng = np.random.default_rng(21)
    R, S1, S2 = 41, 36, 12
    nr1 = torch.from_numpy(rng.integers(0, S1 + 1, R))
    nr2 = torch.from_numpy(rng.integers(0, S2 + 1, R))
    nr1[:6] = torch.tensor([0, 1, S1, 0, S1, 1])
    nr2[:6] = torch.tensor([0, 1, S2, S2, 0, 1])

    def ascending(width):  # steps of 0.01 with repeats: ties within the set
        steps = rng.integers(0, 3, (R, width)).astype(np.float32) * 0.01
        return torch.from_numpy(np.cumsum(steps, axis=1) + 0.1)

    z1, z2 = ascending(S1), ascending(S2)
    z2[6] = z1[6, :S2]  # every key of set 2 also in set 1
    fixed = torch.from_numpy(rng.uniform(0.005, 0.02, R).astype(np.float32))
    sets = []
    for z, nr in ((z1, nr1), (z2, nr2)):
        mask = pm(nr, z.shape[1])
        sets.append(RaySamples(origins=torch.zeros(R, 3), dirs=torch.zeros(R, 3),
                               z=torch.where(mask, z, 0.0), dt=torch.zeros_like(z), mask=mask,
                               ray_fixed_dt=fixed))
    if carry:
        sets = [s.with_sdf(torch.from_numpy(rng.normal(size=s.z.shape).astype(np.float32)))
                for s in sets]
    t_exit = torch.from_numpy(rng.uniform(0.0, 0.5, (R, 1)).astype(np.float32))
    got = isp.merge_samples_cuda(*sets, t_exit)
    want = vr.combine_uniform_samples_with_imp(*sets, t_exit)
    for f in ("z", "dt", "mask") + (("sdf",) if carry else ()):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                      err_msg=f)
    assert (got.sdf is None) == (not carry)
    assert not want.mask[0].any() and want.mask[2].all()


@pytest.mark.parametrize("jitter", [False, True])
def test_kernel_E2_draw_forms_match_plain(emulated, jitter):
    """Kernel E2's forms (b) (the merge, then round 2 on the merged ray)
    and (c) (the draws merged in too) against the plain composition: the
    merged set of (b) bit for bit, the masks equal, the draws and (c)'s z
    and dt within E1's 1e-6; (b)'s draws bit-equal to kernel E1 run on
    (b)'s merged set."""
    from permuto_sdf_tpu_torch.ops import importance_sampling as isp

    rng = np.random.default_rng(33 + jitter)
    R, S, n = 37, 40, 12
    nr = torch.from_numpy(rng.integers(0, S + 1, R))
    nr[0], nr[1], nr[2] = 0, 1, S
    smp, sdf, t_exit = _imp_batch(rng, R, S, nr)
    smp = smp.with_sdf(sdf)
    z_i, m_i = isp.importance_round_plain(smp, sdf, n, None, 1.0)
    imp = RaySamples(origins=smp.origins, dirs=smp.dirs, z=z_i, dt=torch.zeros_like(z_i),
                     mask=m_i, ray_fixed_dt=smp.ray_fixed_dt,
                     sdf=torch.from_numpy(rng.normal(0, 0.02, (R, n)).astype(np.float32)))
    mov = 1.0 / (n + 1) / 2.0
    jit = (torch.from_numpy(rng.uniform(-mov, mov, (R, n)).astype(np.float32))
           if jitter else None)
    launches = isp.merge_samples_cuda.launches
    merged, draws = isp.merge_samples_cuda(smp, imp, t_exit, n, jit)
    want_m, want_d = isp.merge_samples_plain(smp, imp, t_exit, n, jit)
    for f in ("z", "dt", "mask", "sdf"):
        np.testing.assert_array_equal(getattr(merged, f).numpy(), getattr(want_m, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(draws.mask.numpy(), want_d.mask.numpy())
    np.testing.assert_allclose(draws.z.numpy(), want_d.z.numpy(), atol=1e-6, rtol=0)
    z_e1, _ = isp.importance_round_cuda(merged, merged.sdf, n, jit, 2.0)
    np.testing.assert_array_equal(draws.z.numpy(), z_e1.numpy())
    got = isp.merge_samples_cuda(smp, imp, t_exit, n, jit, merge_draws=True)
    want = isp.merge_samples_plain(smp, imp, t_exit, n, jit, merge_draws=True)
    assert got.sdf is None and want.sdf is None and got.z.shape == (R, S + 2 * n)
    np.testing.assert_array_equal(got.mask.numpy(), want.mask.numpy())
    for f in ("z", "dt"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), atol=1e-6,
                                   rtol=0, err_msg=f)
    assert isp.merge_samples_cuda.launches == launches + 2


def test_kernels_H1_H2_source_match_plain(emulated):
    """Kernels H1 (take) and H2 (scatter, and its backward through H1)
    against the plain index ops, exactly: a bucket with fill slots, a
    bucket that overflows (fewer slots than hits), rows of floats, bools
    (4-byte and odd row widths) and int64; then H1 and H2 on every chunk
    width (16, 8, 4 and 1 bytes), bases at an odd element, the most arrays
    a launch takes, nonzero fills (H2) and buckets of 0 to 130 rows, one
    launch a call (none for an empty bucket, or for H2 no rows); then H2 on
    buckets long enough that its blocks narrow the ids' range first."""
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
    # H1's chunks: rows of 1, 3, 12, 96 and 384 bytes and of int64, each
    # also based at an odd element (12 arrays, the most a launch takes); B =
    # 0, 1, 5 (2 chunks a thread), 37 and 130 (4; not a multiple of a block),
    # ids repeated and at n (the fill)
    n = 50

    def odd(a):
        flat = torch.empty(a.numel() + 1, dtype=a.dtype)
        flat[1:] = a.reshape(-1)
        return flat[1:].view(a.shape)

    base = [torch.from_numpy(rng.uniform(size=(n, 1)) < 0.5),
            torch.from_numpy(rng.uniform(size=(n, 3)) < 0.5),
            torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, 96)).astype(np.float32)),
            torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (n, 2)))]
    arrays = base + [odd(a) for a in base]
    assert len(arrays) == kernels.MAX_ROW_ARRAYS
    widths = {compaction._row_arrays(arrays, arrays).chunk[k] for k in range(len(arrays))}
    assert widths == {1, 4, 8, 16}
    for B in (0, 1, 5, 37, 130):
        idx = torch.from_numpy(rng.integers(0, n + 1, B))
        idx[: B // 4] = n
        launches = compaction.take_rows_cuda.launches
        got = compaction.take_rows_cuda(arrays, idx)
        assert compaction.take_rows_cuda.launches == launches + (B > 0)
        for g, w in zip(got, compaction.take_rows_plain(arrays, idx)):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        # H2 back to the n rows: ascending distinct ids, a quarter of the
        # bucket (and all it holds beyond n rows) at n, dropped
        valid = min(B - B // 4, n)
        idx = torch.from_numpy(np.concatenate([np.sort(rng.choice(n, valid, replace=False)),
                                               np.full(B - valid, n)]))
        xs = [a[:B] if a.shape[0] >= B else torch.cat([a] * (B // n + 1))[:B] for a in arrays]
        xs = [odd(x.contiguous()) if k >= len(base) else x.contiguous()
              for k, x in enumerate(xs)]
        fills = [-2.5 if x.dtype == torch.float32 and k % 2 else
                 (1.0 if x.dtype == torch.float32 else 0.0) for k, x in enumerate(xs)]
        launches = compaction.scatter_rows_cuda.launches
        got = compaction.scatter_rows_cuda(xs, idx, n, fills)
        assert compaction.scatter_rows_cuda.launches == launches + 1
        for g, w in zip(got, compaction.scatter_rows_plain(xs, idx, n, fills)):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert compaction._row_arrays(xs, got).row_chunks > 0
    launches = compaction.scatter_rows_cuda.launches
    assert [g.shape for g in compaction.scatter_rows_cuda(xs[:0] + [xs[2][:0]], idx[:0], 0,
                                                          (0.0,))] == [(0, 3)]
    assert compaction.scatter_rows_cuda.launches == launches
    # H2's narrowing rounds: 2,000 and 1,200 ids (beyond the 512 a block
    # scans at once) of 3,001 rows, the second all in the first half
    n = 3001
    for B, top in ((2000, n), (1200, n // 2)):
        idx = torch.from_numpy(np.concatenate([np.sort(rng.choice(top, B - 7, replace=False)),
                                               np.full(7, n)]))
        xs = [torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)),
              torch.from_numpy(rng.uniform(size=(B, 3)) < 0.5)]
        got = compaction.scatter_rows_cuda(xs, idx, n, (0.5, 0.0))
        for g, w in zip(got, compaction.scatter_rows_plain(xs, idx, n, (0.5, 0.0))):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("carry", [False, True])
def test_importance_stage_through_the_kernel_sources_matches_plain(emulated, monkeypatch, carry):
    """``importance_sampling_sdf_model`` (E1, then E2 in form c, or in form
    b and a with ``carry_sdf``) from the kernel sources, with jitter, against the
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
    # E1 for round 1; E2 merges, draws round 2 and merges its draws in one
    # launch, or, to carry their sdf, merges and draws, then merges again
    assert (isp.importance_round_cuda.launches, isp.merge_samples_cuda.launches) == (
        launches[0] + 1, launches[1] + (2 if carry else 1))
    np.testing.assert_array_equal(got.mask.numpy(), want.mask.numpy())
    for f in ("z", "dt") + (("sdf",) if carry else ()):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), atol=1e-6,
                                   rtol=0, err_msg=f)
    assert (got.sdf is None) == (not carry)


@pytest.mark.parametrize("d,K,levels,N,clustered", [
    pytest.param(3, 4, (0, 2), 200, False, id="3-4-levels0"),
    pytest.param(3, 4, (1, 2), 200, False, id="3-4-levels1"),
    pytest.param(4, 4, (2, 3), 200, False, id="4-4-levels2"),
    pytest.param(3, 3, (1, 3), 200, False, id="3-3-levels3"),
    (3, 4, (1, 2), 77, True),  # clustered (combined atomics), a ragged tile
    (4, 3, (0, 2), 45, True)])  # d = 4, K < L, clustered, a ragged tile
def test_kernels_F_G_parity_source_match_plain(emulated, d, K, levels, N, clustered):
    """Kernels F and G with alternating-level table gradients ``levels =
    (phase, period)``: the frozen levels of the table gradient are exactly
    zero, the active ones equal the same kernel without parity (1e-5 of the
    level's largest |value|: atomics in no fixed order) and the plain
    version with parity; G's feature cotangent is unchanged at every
    level."""
    rng = np.random.default_rng(d * 13 + K + levels[0] + (N if clustered else 0))
    spec = pe.PermutoEncodingSpec(pos_dim=d, capacity=2 ** 10, nr_levels=4,
                                  concat_points_scaling=1e-3)
    prm = pe.init_encoding_params(torch.Generator().manual_seed(3), spec, "cpu")
    table = prm["lattice_values"] * 1e3
    pts = _fg_points(rng, N, d, clustered)
    scales, E, _ = pe.encoding_constants(spec, None, "cpu")
    args = (pts, table, prm["shift_per_level"], scales, torch.tensor([1.0, 0.8, 0.5, 0.2]), E, K)
    g = torch.from_numpy(rng.normal(size=(N, 2 * K + d)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
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


def _plant_ties(sdf, scores):
    """Exact ties for kernel L's two selections, in place: rays inside the
    surface from their first sample (weights 1, 1e-7, 1e-14, ..., then exact
    zeros), rays whose scores are all equal, and rays of -0.0 beside +0.0
    scores (the float compare has them equal)."""
    sdf[7:11] = -1.0
    scores[7:13] = 0.25
    scores[9:11, ::2] = -0.0
    scores[9:11, 1::2] = 0.0
    scores[11, ::3] = -0.0
    scores[12, 1::2] = -0.0


@pytest.mark.parametrize("S,K,E,ties", [(70, 24, 8, False), (40, 40, 0, False),
                                        (37, 6, 3, False), (96, 24, 8, False),
                                        (96, 24, 8, True), (150, 24, 8, False)],
                         ids=["70-24-8", "40-40-0", "37-6-3", "96-24-8", "96-24-8-ties",
                              "150-24-8"])
def test_kernel_L_source_matches_plain(emulated, S, K, E, ties):
    """Kernel L (fd cos, the ranking weights' warp scan, the top-K and the
    extras by a bitonic sort of 64-bit keys) against its plain version:
    cos_fd bit for bit, sel exactly (descending, ties by the lower index, as
    ``lax.top_k``), on empty, short, one-sample and full rays, a last sample
    with dt 0 and exact ties (planted ones too: zero weights, equal scores,
    -0.0 beside +0.0), at the flagship shape and a sort of 256 keys."""
    rng = np.random.default_rng(S + K)
    smp, sdf, scores = _lod_batch(rng, 41, S)
    if ties:
        _plant_ties(sdf, scores)
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


@pytest.mark.parametrize("S,K,E,seed", [(70, 12, 4, 21), (96, 24, 8, 117)],
                         ids=["70-12-4", "96-24-8"])
def test_kernels_D2_source_match_plain(emulated, S, K, E, seed):
    """Kernel D2 (the mixed chain's weights and the selected slots'
    integration) and D2' (its VJP in the fine set's sdf, gradient and rgb)
    against their plain versions (autograd of the plain forward), with
    random cotangents on every output: to 1e-6, and to 1e-5 of each
    gradient's largest |value|, exact zeros at the rows of invalid slots;
    the short and empty rays select slots twice (the duplicate rows), and
    (96, 24, 8) is the lever step's shape."""
    rng = np.random.default_rng(seed)
    R = 41
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


def test_kernel_D2_sharp_crossing_matches_float64(emulated):
    """Kernel D2 and its plain version each against a float64 evaluation of
    the same chain (the same float32 inputs), to 1e-6: the (96, 24, 8) batch
    at seed 21 has a sharp crossing (ray 27, slot 3) where float32
    conditioning moves a weight by ~8e-7 either way. The weights, their sum,
    bg_T and the rgb integral (rgb in [0, 1]) are held to 1e-6; the
    gradient integral to 1e-6 times the largest |gradient| entry (the
    weights' 1e-6 carried through its sum: at the crossing both float32
    versions are ~1.4-1.9e-6 off there, with gradients up to ~3.5)."""
    rng = np.random.default_rng(21)
    R, S, K, E = 41, 96, 24, 8
    smp, sdf, scores = _lod_batch(rng, R, S)
    cos_fd, sel = vr.train_lod_select_plain(smp, sdf, 400.0, 0.6, scores, K, E)
    n = R * (K + E)
    sdf_c = torch.from_numpy(rng.uniform(-0.05, 0.05, (n, 1)).astype(np.float32))
    grads_c = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    rgb_c = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    args = (smp, sdf, cos_fd, sel, sdf_c, grads_c, rgb_c, 400.0, 0.6)
    got = vr.neus_render_mixed_cuda(*args)
    plain = vr.neus_render_mixed_plain(*args)
    f64 = lambda t: t.to(torch.float64)  # noqa: E731
    smp64 = RaySamples(origins=f64(smp.origins), dirs=f64(smp.dirs), z=f64(smp.z),
                       dt=f64(smp.dt), mask=smp.mask, ray_fixed_dt=f64(smp.ray_fixed_dt))
    want = vr.neus_render_mixed_plain(smp64, f64(sdf), f64(cos_fd), sel, f64(sdf_c),
                                      f64(grads_c), f64(rgb_c), 400.0, 0.6)
    assert float((plain[0] - want[0]).abs()[27, 3]) > 1e-7  # the crossing is there
    limits = (1e-6,) * 4 + (1e-6 * float(grads_c.abs().max()),)
    for outs in (got, plain):
        for a, b, tol in zip(outs, want, limits):
            np.testing.assert_allclose(a.to(torch.float64).numpy(),
                                       b.reshape(a.shape).numpy(), atol=tol, rtol=0)


def _kernel_m_matches_plain(v, origin, spacing):
    """Kernel M's pieces (M1, the tile offsets, M2 with its weld table, the
    ranking glue) against their plain versions, exactly; returns (T, M2's
    outputs, the welded mesh)."""
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc

    launches = (mc.mt_count_cuda.launches, mc.mt_emit_cuda.launches)
    word_tris, tile_tris = mc.mt_count_cuda(v, 0.0)
    want_words, want_tiles = mc.mt_count_plain(v, 0.0, slab=3)
    assert torch.equal(word_tris, want_words) and torch.equal(tile_tris, want_tiles)
    offsets, T = mc.mt_offsets(tile_tris)
    want = mc.mt_emit_plain(v, 0.0, origin, spacing)
    want = (*want, mc.mt_first_plain(want[1]))
    assert T == want[2].shape[0]
    if T == 0:
        assert mc.mt_count_cuda.launches == launches[0] + (word_tris.numel() > 0)
        return T, want, mc.weld(*want[:3])
    emitted = mc.mt_emit_cuda(v, 0.0, word_tris, tile_tris, offsets, T, origin, spacing)
    assert (mc.mt_count_cuda.launches, mc.mt_emit_cuda.launches) == (launches[0] + 1,
                                                                     launches[1] + 1)
    for a, b in zip(emitted[:4], want):
        assert torch.equal(a, b)
    assert emitted[4].tolist() == [0]  # no key found the table full
    Vk, Fk = mc.weld_first(emitted[0], emitted[3], emitted[2], emitted[4])
    Vp, Fp = mc.weld(*want[:3])
    assert torch.equal(Vk, Vp) and torch.equal(Fk, Fp)
    return T, emitted, (Vk, Fk)


@pytest.mark.parametrize("grid", ["planted", "sphere"])
def test_kernel_M_source_matches_plain(emulated, grid):
    """Kernel M (M1 counts the triangles of each tile of 8 cube rows and
    each 32-cube word, M2 emits them at the tiles' offsets and welds them in
    a hash table) against its plain version on a grid that is not a cube
    (10 x 11 x 12: the second tile of each x holds 2 rows): M1's counts,
    the emitted world positions, weld keys, degenerate flags and each
    emission's first emission of its key bit for bit, the welded mesh of
    the ranking glue equal to the plain weld's. The planted grid holds
    exact-level nodes, degenerate faces and the 1e-12 denominator floor."""
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc
    from test_torch_marching_tets import planted_grid, sphere_grid

    v = (planted_grid(13) if grid == "planted" else sphere_grid(13, 0.31))[:10, :11, :12]
    v = torch.from_numpy(np.ascontiguousarray(v))
    origin, spacing = (-0.5, -0.4, -0.3), (0.05, 0.04, 1.0 / 23)
    T, emitted, (Vk, Fk) = _kernel_m_matches_plain(v, origin, spacing)
    assert T > 50
    assert mc.mt_count_plain(v, 0.0)[1].shape == (18,)  # 9 x, 2 tiles each
    if grid == "planted":
        assert emitted[2].sum() > 0
    Vp, Fp = mc.marching_tetrahedra_plain(v, 0.0, origin, spacing)
    assert torch.equal(Vk, Vp) and torch.equal(Fk, Fp)
    Vm, Fm = mc.marching_tetrahedra_cuda(v, 0.0, origin, spacing)
    assert torch.equal(Vm, Vp) and torch.equal(Fm, Fp)


def _thin_grid(axis):
    """A 700-long grid of 3 x 3 nodes across, a field through x = 600 along
    the long axis whose nodes just below the level sit 1e-7 under it: the
    crossings on the long edges lie w ~ 1e-9 from x = 600, far below
    float32's ulp there (6.1e-5), so they round onto the node, where the
    crossings of the short edges from the same node land too (w ~ 2e-7,
    keys 0 across). Only an exact-triple weld numbers them as the plain
    weld does."""
    x = np.arange(700, dtype=np.float32)
    f = np.where(x <= 600, np.float32(-1e-7), np.float32(100.0) * (x - 600))
    v = np.broadcast_to(f[:, None, None], (700, 3, 3)).copy()
    v[600, 1:, :] = 0.5  # short edges crossed beside the near-level nodes
    v[600, 0, 2] = 0.5
    return np.ascontiguousarray(np.moveaxis(v, 0, axis))


@pytest.mark.parametrize("case", ["small_table", "thin_x", "thin_z", "empty", "inside",
                                  "full_table"])
def test_kernel_M_edge_cases_match_plain(emulated, monkeypatch, case):
    """Kernel M on the cases its hash weld must get right: a table of just
    enough slots (the power of two at or above the distinct keys: long
    probe chains that wrap around the table's end), a thin 700 x 3 x 3 grid
    whose float32 crossings collide with a node's key (along x: 699 tiles
    of 2 rows; along z: two staged chunks of 352 cubes per row), an empty
    and an all-inside grid (no triangles: M2 is not launched), and a table
    smaller than the distinct keys (the mesh raises). The small tables
    replace ``table_slots``, whose two slots per emission never fill."""
    from permuto_sdf_tpu_torch.ops import marching_cubes as mc
    from test_torch_marching_tets import sphere_grid

    origin, spacing = (-0.5, -0.4, -0.3), (0.05, 0.04, 1.0 / 23)
    if case in ("small_table", "full_table"):
        v = torch.from_numpy(np.ascontiguousarray(sphere_grid(13, 0.35)[:10, :11, :12]))
        keys = mc.mt_emit_plain(v, 0.0, origin, spacing)[1]
        distinct = torch.unique(keys, dim=0).shape[0]
        slots = 1 << (distinct - 1).bit_length()
        if case == "full_table":
            monkeypatch.setattr(mc, "table_slots", lambda nr_tris: slots // 2)
            with pytest.raises(RuntimeError, match="full"):
                mc.marching_tetrahedra_cuda(v, 0.0, origin, spacing)
            return
        assert distinct > 0.8 * slots  # 860 keys in 1,024 slots: chains cross the end
        monkeypatch.setattr(mc, "table_slots", lambda nr_tris: slots)
        T, _, _ = _kernel_m_matches_plain(v, origin, spacing)
        assert T > 50
    elif case.startswith("thin"):
        v = torch.from_numpy(_thin_grid(0 if case == "thin_x" else 2))
        T, (world, keys, *_), (Vk, Fk) = _kernel_m_matches_plain(v, origin, (1.0,) * 3)
        # crossings at distinct world positions share a key (11 keys, 29
        # pairs of key and position), and some faces survive the weld
        pairs = torch.cat([keys, world.view(torch.int32).to(torch.int64)], 1)
        assert torch.unique(pairs, dim=0).shape[0] > torch.unique(keys, dim=0).shape[0]
        assert Vk.shape[0] == torch.unique(keys, dim=0).shape[0] and 0 < Fk.shape[0] < T
    else:
        v = torch.full((6, 7, 9), 1.0 if case == "empty" else -1.0)
        T, _, (Vk, Fk) = _kernel_m_matches_plain(v, origin, spacing)
        assert T == 0 and Vk.shape == (0, 3) and Fk.shape == (0, 3)
        assert all(t.shape[0] == 0 for t in mc.marching_tetrahedra_cuda(v, 0.0, origin,
                                                                          spacing))


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


def _sparse_blocks(V, rng, blocks=40, per_block=2):
    """A V^3 grid with ``per_block`` random voxels set in each of ``blocks``
    random 8^3 blocks: clusters of occupancy with empty space around and
    between their voxels."""
    occ = torch.zeros(V, V, V, dtype=torch.bool)
    c = V // 8
    for cell in rng.choice(c ** 3, size=blocks, replace=False):
        cx, cy, cz = cell // (c * c), (cell // c) % c, cell % c
        for ix, iy, iz in rng.integers(0, 8, (per_block, 3)):
            occ[8 * cx + ix, 8 * cy + iy, 8 * cz + iz] = True
    return occ.reshape(-1)


def _c3_rays(rng, n, radius=0.5):
    """Rays from a sphere of radius 1.2 towards points near the grid's
    center, clipped to a bound sphere of ``radius`` (beyond 0.5 the probes
    start and end outside the grid) -> (o, d, t_entry, t_exit)."""
    o = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    o = o / o.norm(dim=-1, keepdim=True) * 1.2
    tgt = torch.from_numpy(rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(tgt - o, dim=-1)
    _, te, _, tx, _ = Sphere(radius=radius).ray_intersection(o, d)
    return o, d, te, tx


@pytest.mark.parametrize("P,kind,cap", [(512, "sparse", 63), (100, "sparse", 63),
                                        (512, "sparse", 2), (512, "full", 63)])
def test_kernel_C3_field_spans_match_plain(emulated, P, kind, cap):
    """Kernel C3 rules spans of 16 probes out with the grid's distance
    field: on a V = 64 grid of 48 sparse clusters (spans near a cluster
    that the field cannot rule out, whose probes find nothing), on a full
    grid, and with a field capped at 2 (a span rules out only where its
    end is within one voxel of its start), ``has`` and ``t_first`` equal
    the plain version's exactly."""
    rng = np.random.default_rng(P + cap)
    V = 64
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=V)
    occ = (_sparse_blocks(V, rng, blocks=48, per_block=24) if kind == "sparse"
           else torch.ones(V ** 3, dtype=torch.bool))
    field = og.chebyshev_field_plain(cfg, occ, cap)
    o, d, te, tx = _c3_rays(rng, 101 if kind == "sparse" else 33)
    got = og.first_occupied_cuda(cfg, occ, o, d, te, tx, P, dist_field=field)
    want = og.first_occupied_plain(cfg, occ, o, d, te, tx, P)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    has = want[1]
    if kind == "full":
        assert bool(has[(tx > te)[:, 0]].all())
    else:
        assert 5 < int(has.sum()) < has.numel()


def test_kernel_C3_seed_follows_a_refresh(emulated, monkeypatch):
    """The tracers' seed reads C3's distance field from the trainer's
    per-state cache: a second seed on the same grid reuses it, and an
    in-place refresh (kernel I through its emulated launch, then a plain
    index write; both bump the occupancy's version) builds it again
    (kernel J0), so the next seed follows the new grid."""
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    monkeypatch.setattr(kernels, "dispatch", lambda device, cuda_fn, plain_fn: cuda_fn)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    grid = og.make_occupancy_grid(cfg, initial_occupied=False, device="cpu")
    o, d, te, tx = _c3_rays(np.random.default_rng(3), 29)
    tps._DIST_FIELD_CACHE.clear()

    def seed(builds):
        launches = og.chebyshev_field_cuda.launches
        got = og.first_occupied_cuda(cfg, grid.occupancy, o, d, te, tx, 64,
                                     dist_field=tps._cached_dist_field(cfg, grid))
        want = og.first_occupied_plain(cfg, grid.occupancy, o, d, te, tx, 64)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert og.chebyshev_field_cuda.launches == launches + builds
        return int(got[1].sum())

    assert seed(1) == 0 and seed(0) == 0
    lin = torch.from_numpy(np.flatnonzero(_shell(16).numpy()).astype(np.int32))
    og.grid_update_cuda(cfg, grid, lin, torch.zeros(lin.shape[0]), 300.0, 1e-4)
    shell_hits = seed(1)
    assert shell_hits > 5 and seed(0) == shell_hits
    grid.occupancy[:] = False
    assert seed(1) == 0


@pytest.mark.parametrize("V", [12, 20])
def test_kernel_C3_any_grid_size_matches_plain(emulated, V):
    """C3 on grids whose size no span or block divides, on rays whose
    probes start and end outside the grid: ``has`` and ``t_first`` equal
    the plain version's exactly on voxels set only near the grid's far
    faces, on a full grid and on single voxels at block faces; without a
    field the wrapper builds one (kernel J0)."""
    rng = np.random.default_rng(V)
    cfg = og.OccupancyGridConfig(nr_voxels_per_dim=V)
    tail = torch.zeros(V, V, V, dtype=torch.bool)
    tail[V - V % 8:] = torch.from_numpy(rng.random((V % 8, V, V)) < 0.25)
    tail[:, V - V % 8:, :2] = True
    o, d, te, tx = _c3_rays(rng, 33, radius=0.8)
    grids = [tail.reshape(-1), torch.ones(V ** 3, dtype=torch.bool)]
    for ijk in ((7, 0, 0), (0, 7, 3), (3, 0, 7), (V - 1, 2, 9), (8, V - 1, V - 1)):
        one = torch.zeros(V, V, V, dtype=torch.bool)
        one[ijk] = True
        grids.append(one.reshape(-1))
    for i, occ in enumerate(grids):
        want = og.first_occupied_plain(cfg, occ, o, d, te, tx, 100)
        field = og.chebyshev_field_plain(cfg, occ, 63)
        got = og.first_occupied_cuda(cfg, occ, o, d, te, tx, 100, dist_field=field)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        if i < 2:
            assert int(want[1].sum()) > 3
    launches = og.chebyshev_field_cuda.launches
    got = og.first_occupied_cuda(cfg, grids[0], o, d, te, tx, 100)
    assert og.chebyshev_field_cuda.launches == launches + 1
    want = og.first_occupied_plain(cfg, grids[0], o, d, te, tx, 100)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
    """Kernel C2 (the bound sphere's intersection and the uniform samples,
    a thread per sample slot) against its plain version, bit for bit: z,
    dt, mask, ray_fixed_dt, t_entry, t_exit and does_intersect, one launch
    a call, on rays from outside that cross, miss, graze (disc 0 and a
    rounding either side), start inside (t_entry clamped to 0) and start
    past the sphere (both t < 0), rays planted with chords of 0, 1, 2, 3
    and S samples, S a multiple of 4 or not. The plain version's span is
    ``Sphere.ray_intersection``'s: does_intersect equal, the t within the
    CPU float32 root's rounding."""
    rng = np.random.default_rng(7 + jitter)
    R = 70
    start = torch.from_numpy(rng.uniform(size=(R, 1)).astype(np.float32)) if jitter else None
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * rng.uniform(0.0, 1.5, (R, 1))
    d = rng.uniform(-0.4, 0.4, (R, 3)).astype(np.float32) - o
    o[-10:] *= 1.2 / np.linalg.norm(o[-10:], axis=-1, keepdims=True)
    d[-10:] = o[-10:]  # outside, away from the sphere: both t < 0
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o[:4] = [[0.5, 0.0, -2.0], [0.5 + 3e-8, 0.0, -2.0], [0.5 - 3e-8, 0.0, -2.0], [0.6, 0, -2]]
    d[:9] = [0.0, 0.0, 1.0]
    sphere = Sphere(0.5, (0.0, 0.0, 0.0))
    for S in (16, 18):
        md = 0.9 / S
        # chords of 0.8, 1.4, 2.4 and 3.1 steps (nr 0, 1, 2, 3) and the diameter (S)
        chord = np.append(np.array([0.8, 1.4, 2.4, 3.1]) * md, 1.0)
        o[4:9, 0] = np.sqrt(0.25 - (chord / 2) ** 2)
        o[4:9, 1:] = [0.0, -2.0]
        o_t, d_t = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
        launches = rs.samples_fg_sphere_cuda.launches
        got = rs.samples_fg_sphere_cuda(o_t, d_t, sphere, md, S, start)
        assert rs.samples_fg_sphere_cuda.launches == launches + 1
        want = rs.samples_fg_sphere_plain(o_t, d_t, sphere, md, S, start)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        _, te_s, _, tx_s, hit_s = sphere.ray_intersection(o_t, d_t)
        np.testing.assert_array_equal(want[6].numpy(), hit_s.numpy())
        np.testing.assert_allclose(want[4].numpy(), te_s.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(want[5].numpy(), tx_s.numpy(), rtol=0, atol=1e-6)
        counts = want[2].sum(dim=1)
        assert counts[4:9].tolist() == [0, 0, 0, 3, S]
        te_w, tx_w, hit_w = (t[:, 0] for t in want[4:])
        assert hit_w[0] and not hit_w[3] and bool((tx_w[-10:] < 0).all())
        assert not want[2][-10:].any()
        assert (hit_w & (tx_w > 0) & (te_w == 0)).sum() > 5  # from inside
        assert (hit_w & (te_w > 0)).sum() > 5 and int((counts == S).sum()) > 5


def test_gridfree_paths_through_kernel_C2_match_plain(emulated, monkeypatch):
    """The flagship's grid-free ``run_net`` (with the step's jitter, and the
    eval render without it) and NeRF's grid-free ``_render_rays`` at the
    NeRF tests' tiny config (capacity 2^10, 4 levels, 32 rays), with kernel
    C2 routed to its CPU-compiled source and every other op
    on its plain version: every output equals the plain route's bit for
    bit, each run takes C2 once, and neither route calls
    ``Sphere.ray_intersection`` besides."""
    from permuto_sdf_tpu_torch.datasets import synthetic as tsyn
    from permuto_sdf_tpu_torch.train import train_nerf as tn
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt

    tiny = dict(capacity=2 ** 10, nr_levels=4, nr_rays=32, max_nr_samples_per_ray=16,
                nr_samples_bg=4, use_occupancy_grid=False)
    cfg = tt.PermutoSDFTrainConfig(**tiny, nr_samples_imp_sampling=4,
                                   imp_sampling_max_levels=2, nr_iter_sphere_fit=20)
    ncfg = tn.NerfTrainConfig(**tiny)
    reel = tsyn.make_synthetic_reel(nr_views=2, width=16, height=16, device="cpu")
    rng = np.random.default_rng(11)
    o = rng.normal(size=(32, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.2
    d = rng.uniform(-0.5, 0.5, (32, 3)) - o
    o_t = torch.from_numpy(o.astype(np.float32))
    d_t = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    params = tt.init_params(0, cfg, device="cpu")
    nparams = tn.init_params(0, ncfg, reel.rgb.shape[0], device="cpu")
    draws = tt.draw_train_step(torch.Generator().manual_seed(1), cfg, reel)
    ndraws = tn.draw_train_step(torch.Generator().manual_seed(1), ncfg, reel)
    img = torch.zeros(32, dtype=torch.int64)

    runs = {
        "train": lambda: tt.run_net(params, None, o_t, d_t, 100, 0.5, 0.3, cfg, draws),
        "eval": lambda: tt.run_net(params, None, o_t, d_t, 100, 1.0, 0.8, tt._eval_cfg(cfg)),
        "nerf": lambda: tn._render_rays(nparams, None, o_t, d_t, img, 100, ncfg, ndraws)}
    calls = {"intersection": 0, "plain": 0}
    plain_intersection, plain_c2 = Sphere.ray_intersection, rs.samples_fg_sphere_plain

    def counted_intersection(self, *a):
        calls["intersection"] += 1
        return plain_intersection(self, *a)

    def counted_plain(*a):
        calls["plain"] += 1
        return plain_c2(*a)

    monkeypatch.setattr(Sphere, "ray_intersection", counted_intersection)
    monkeypatch.setattr(rs, "samples_fg_sphere_plain", counted_plain)
    want = {k: fn() for k, fn in runs.items()}
    assert calls == {"intersection": 0, "plain": 3}
    monkeypatch.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: (
        cuda_fn if cuda_fn is rs.samples_fg_sphere_cuda else plain_fn))
    launches = rs.samples_fg_sphere_cuda.launches
    got = {k: fn() for k, fn in runs.items()}
    assert calls == {"intersection": 0, "plain": 3}
    assert rs.samples_fg_sphere_cuda.launches == launches + 3

    def flat(out):
        if isinstance(out, dict):
            return [t for k in sorted(out) for t in flat(out[k])]
        if isinstance(out, (list, tuple)):
            return [t for x in out for t in flat(x)]
        if isinstance(out, RaySamples):
            return flat([getattr(out, f) for f in ("z", "dt", "mask", "ray_fixed_dt")])
        return [out] if isinstance(out, torch.Tensor) else []

    for k in runs:
        a, b = flat(got[k]), flat(want[k])
        assert len(a) == len(b) >= 4
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.detach().numpy(), y.detach().numpy(), err_msg=k)
    assert int(want["train"][3]["does_intersect"].sum()) > 10
    assert int(want["train"][3]["samples"].mask.sum()) > 50


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


# Kernels J3f and J2f evaluate the SDF inside the trace loop: the encoding's
# features are kernel A's bit for bit, but the MLP sums in order with fmaf
# where the plain version's torch.matmul blocks its sums. So positions agree
# within TOL_FUSED_POS where the flags agree, and the flags (a convergence
# test |s| < 2e-4 or a bound test right at its edge) may differ on at most
# FUSED_FLAG_ROWS rays, each within FUSED_MAX_GAP (every case here had no
# such ray and gaps of at most 7.5e-7).
TOL_FUSED_POS = 1e-5
FUSED_FLAG_ROWS = 2
FUSED_MAX_GAP = 0.01
_PLANE_N = (0.3, 1.0, 0.2)
_PLANE_OFFSET = -0.05


def _planted_sdf(L, seed=0):
    """A small flagship SDF (L levels of 2^12 slots, G = 32) whose value is
    the plane n . p - offset plus small bumps: hidden unit 0 of each layer
    carries 10 + n . p through GELU (the identity at +10) from the point
    columns, which the encoding scales by 1e-3; every level adds a bump
    through unit 0's features, and every other hidden unit of every layer
    reaches the output through weights of ~1e-3, so the kernels' split of
    the units among warps shows in the sdf."""
    from permuto_sdf_tpu_torch.models import fields

    cfg = fields.SDFConfig(capacity=2 ** 12, nr_levels=L, nr_iters_for_c2f=100)
    gen = torch.Generator().manual_seed(seed)
    params = fields.init_sdf(gen, cfg, "cpu")
    mlp = params["mlp_sdf"]
    n = torch.tensor(_PLANE_N)
    n = n / n.norm()
    mlp[0]["w"][:-3, 0] *= 0.05
    mlp[0]["w"][-3:, 0] = n * 1e3
    mlp[0]["b"][0] = 10.0
    for layer in mlp[1:]:
        layer["w"][:, 0] = 1e-3 * torch.randn(layer["w"].shape[0], generator=gen)
        layer["w"][0, 0] = 1.0
        layer["b"][0] = 0.0
    mlp[-1]["b"][0] = -10.0 - _PLANE_OFFSET
    params["encoding"]["lattice_values"] *= 50.0  # a bump of ~1e-3
    return cfg, params


def _plane_grid(V):
    """Voxels whose center is within 1.5 voxels of the planted plane."""
    n = torch.tensor(_PLANE_N)
    n = n / n.norm()
    c = (torch.arange(V, dtype=torch.float32) + 0.5) / V - 0.5
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    dist = x * n[0] + y * n[1] + z * n[2] - _PLANE_OFFSET
    return (dist.abs() < 1.5 / V).reshape(-1)


def _fused_rays(n, seed=3):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    o = o / o.norm(dim=-1, keepdim=True) * 1.2
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.uniform(-0.35, 0.35, (n, 3)).astype(np.float32)) - o, dim=-1)
    return o, d


def _sdf_eval(cfg, max_levels=None):
    from permuto_sdf_tpu_torch.models.fields import SDFEval

    return SDFEval(cfg, max_levels)


def _assert_fused_close(got, want, what):
    """(pos, ..., conv, alive) of a fused trace against the plain trace's."""
    pos_k, conv_k, alive_k = got[0], got[-2], got[-1]
    pos_p, conv_p, alive_p = want[0], want[-2], want[-1]
    flags_differ = (conv_k != conv_p) | (alive_k != alive_p)
    assert int(flags_differ.sum()) <= FUSED_FLAG_ROWS, what
    gap = (pos_k - pos_p).abs().amax(dim=-1)
    assert float(gap[~flags_differ].max()) <= TOL_FUSED_POS, (what, float(gap.max()))
    assert float(gap.max()) <= FUSED_MAX_GAP, (what, float(gap.max()))


@pytest.mark.parametrize("form,grid,K", [("full", True, 6), ("full", False, 4),
                                         ("compacted", True, 4), ("compacted", False, 6)])
def test_kernel_J3f_source_matches_plain(emulated, monkeypatch, form, grid, K):
    """Kernel J3f (the plain tracers' loop with the SDF evaluated in the
    launch) through ``sphere_trace`` and ``sphere_trace_compacted`` of an
    ``SDFEval`` against their plain loops (``sdf_apply`` + J3's plain version): with
    and without a grid, on all L = 6 levels and on K = 4 < L; rays that
    converge on the plane and rays that leave the bound. One launch a
    trace, one a compacted round, and no launch of the unfused J3."""
    cfg, params = _planted_sdf(6)
    o, d = _fused_rays(200)
    gcfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    kw = {}
    if grid:
        kw = dict(grid_cfg=gcfg, grid=og.OccupancyGridState(values=torch.zeros(gcfg.nr_voxels),
                                                           occupancy=_plane_grid(16)))
    kw["ctx"] = (params, 50)
    if form == "full":
        run = lambda: st.sphere_trace(_sdf_eval(cfg, K), o, d, Sphere(), 8, **kw)  # noqa: E731
        launches = 1
    else:
        run = lambda: st.sphere_trace_compacted(_sdf_eval(cfg, K), o, d, Sphere(), 3,  # noqa: E731
                                                3, first_bucket_fraction=0.5, **kw)
        launches = 3
    want = run()
    monkeypatch.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: cuda_fn)
    fused, unfused = st.trace_loop_pos_cuda.launches, st.trace_step_pos_cuda.launches
    got = run()
    assert st.trace_loop_pos_cuda.launches == fused + launches
    assert st.trace_step_pos_cuda.launches == unfused
    _assert_fused_close(got, want, (form, grid, K))
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=TOL_FUSED_POS, rtol=0)
    conv = want[-2] & want[-1]
    assert int(conv.sum()) > 20 and int((~want[-1]).sum()) > 20


def test_kernel_J3f_bucket_form_matches_plain(emulated):
    """J3f on a bucket (every other row, then fill slots that point at the
    state's last row) from positions inside the bound: the bucket's rows
    within TOL_FUSED_POS of the plain loop where the flags agree, and the
    rows outside the bucket and the fill row unchanged, bit for bit."""
    cfg, params = _planted_sdf(4)
    o, d = _fused_rays(96)
    pos0 = o + 0.7 * d
    R = pos0.shape[0]
    idx = torch.cat([torch.arange(0, R, 2), torch.full((16,), R)])
    outs = []
    for loop in (st.trace_loop_pos_cuda, st.trace_loop_pos_plain):
        state = [st._padded(pos0.clone()), st._padded(d.clone()),
                 st._padded(torch.ones(R, dtype=torch.bool), False),
                 torch.zeros(R + 1, dtype=torch.bool), torch.zeros(R + 1)]
        pos_f, dirs_f, alive_f, conv_f, sdf_f = state
        loop(_sdf_eval(cfg), (params, 50), idx, dirs_f, pos_f, alive_f, conv_f, sdf_f, None,
             None, 12, 0.9, 2e-4, st._sphere_bound(Sphere()))
        outs.append(state)
    (pos_k, _, alive_k, conv_k, sdf_k), (pos_p, _, alive_p, conv_p, sdf_p) = outs
    _assert_fused_close((pos_k[:R], conv_k[:R], alive_k[:R]), (pos_p[:R], conv_p[:R],
                                                              alive_p[:R]), "bucket")
    same = (conv_k == conv_p) & (alive_k == alive_p)
    np.testing.assert_allclose(sdf_k[same].numpy(), sdf_p[same].numpy(), atol=TOL_FUSED_POS,
                               rtol=0)
    untouched = torch.ones(R + 1, dtype=torch.bool)
    untouched[idx] = False
    untouched[R] = True  # the fill row
    for a, b in zip(outs[0], [st._padded(pos0), st._padded(d),
                              st._padded(torch.ones(R, dtype=torch.bool), False),
                              torch.zeros(R + 1, dtype=torch.bool), torch.zeros(R + 1)]):
        np.testing.assert_array_equal(a[untouched].numpy(), b[untouched].numpy())
    assert int((conv_p & alive_p).sum()) > 5


def test_kernel_J2f_through_the_adaptive_tracer_matches_plain(emulated, monkeypatch):
    """``sphere_trace_adaptive`` with SDFEval descriptors (a per-round LOD
    schedule of 2, 4 and 6 levels, the full SDF's refine, the grid's jumps
    and prepass): kernel J2f once a round and once for the refine, no
    launch of the unfused J2, against the plain route (the SDF, then J2's
    plain version): positions within TOL_FUSED_POS where the flags agree."""
    cfg, params = _planted_sdf(8)
    o, d = _fused_rays(300, seed=5)
    gcfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    grid = og.OccupancyGridState(values=torch.zeros(gcfg.nr_voxels), occupancy=_plane_grid(16))
    ctx = (params, 50)
    kw = dict(nr_rounds=3, iters_per_round=4, grid_cfg=gcfg, grid=grid, min_bucket=64,
              refine_sdf_eval=_sdf_eval(cfg), refine_ctx=ctx, nr_refine_iters=3,
              round_sdf_evals=tuple(_sdf_eval(cfg, k) for k in (2, 4, 6)), jump_substeps=2,
              prepass_jumps=4, return_n_hit=True)
    stats_p, stats_k = [], []
    want = st.sphere_trace_adaptive(_sdf_eval(cfg, 6), ctx, o, d, Sphere(), stats_out=stats_p,
                                    **kw)
    monkeypatch.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: cuda_fn)
    fused, unfused = st.trace_round_cuda.launches, st.trace_step_cuda.launches
    got = st.sphere_trace_adaptive(_sdf_eval(cfg, 6), ctx, o, d, Sphere(), stats_out=stats_k,
                                   **kw)
    assert st.trace_round_cuda.launches == fused + len(stats_k)
    assert st.trace_step_cuda.launches == unfused
    assert stats_p[-1][0] == "refine" and stats_p[-1][3] > 30
    assert abs(got[4] - want[4]) <= FUSED_FLAG_ROWS
    _assert_fused_close(got[:4], want[:4], "adaptive")
    # the sdf where the flags agree, refreshed at the final positions
    same = (got[2] == want[2]) & (got[3] == want[3]) & want[3]
    np.testing.assert_allclose(got[1][same].numpy(), want[1][same].numpy(), atol=TOL_FUSED_POS,
                               rtol=0)


def test_fused_trace_kernels_refuse_other_sdfs(emulated):
    """J3f and J2f evaluate one SDF: d = 3, the MLP [2L + 3, 32, 32, 32, 1 +
    G]. Other widths and a 4-D SDF raise, and so does ``time_val``."""
    import dataclasses

    from permuto_sdf_tpu_torch.models import fields

    cfg, params = _planted_sdf(4)
    o, d = _fused_rays(32)
    R = o.shape[0]
    state = lambda: (None, d.clone(), o.clone(), torch.ones(R, dtype=torch.bool),  # noqa: E731
                     torch.zeros(R, dtype=torch.bool), None, None, None, 2, 0.9, 2e-4,
                     st._sphere_bound(Sphere()))
    wide = {**params, "mlp_sdf": [dict(layer) for layer in params["mlp_sdf"]]}
    wide["mlp_sdf"][1] = {"w": torch.zeros(32, 64), "b": torch.zeros(64)}
    with pytest.raises(NotImplementedError, match="MLP"):
        st.trace_loop_pos_cuda(_sdf_eval(cfg), (wide, 50), *state())
    cfg4 = dataclasses.replace(cfg, in_channels=4)
    params4 = fields.init_sdf(torch.Generator().manual_seed(0), cfg4, "cpu")
    with pytest.raises(NotImplementedError, match="3-D"):
        st.trace_loop_pos_cuda(_sdf_eval(cfg4), (params4, 50), *state())
    idx = torch.arange(R)
    pad = lambda t: st._padded(t)  # noqa: E731
    with pytest.raises(NotImplementedError, match="MLP"):
        st.trace_round_cuda(_sdf_eval(cfg), (wide, 50), idx, pad(o), pad(d), pad(torch.ones(R)),
                            pad(torch.zeros(R)), pad(torch.ones(R, dtype=torch.bool)),
                            pad(torch.zeros(R, dtype=torch.bool)), pad(torch.zeros(R)), None,
                            None, 2, 0.9, 2e-4, 1, 0.0)
    with pytest.raises(NotImplementedError, match="time_val"):
        st.sphere_trace(_sdf_eval(cfg), o, d, Sphere(), 2, time_val=0.5, ctx=(params, 50))
    with pytest.raises(NotImplementedError, match="time_val"):
        st.sphere_trace_adaptive(_sdf_eval(cfg), (params, 50), o, d, Sphere(), time_val=0.5)


# Kernel If: the flagship trainer's grid refresh in one launch. Its values
# are the fused SDF's (the MLP's sums in fmaf order against the plain
# version's matmuls: TOL_FUSED_POS); a voxel's flag may differ only where
# the threshold lies between the densities of the two values, on at most
# FUSED_FLAG_ROWS voxels.
_IF_INV_S = 300.0  # the occupied band: |sdf| below ~1.7 voxels of the 16^3 grid


def _if_grid(V, seed):
    """A grid of random values and flags, so that writes to voxels no probe
    visits would show."""
    rng = np.random.default_rng(seed)
    return og.OccupancyGridState(
        values=torch.from_numpy(rng.normal(size=V ** 3).astype(np.float32)),
        occupancy=torch.from_numpy(rng.uniform(size=V ** 3) < 0.5))


def _assert_refresh_close(gcfg, got, want, before, lin, thresh):
    """A refreshed grid against the plain version's: the probed voxels'
    values within TOL_FUSED_POS, their flags equal but where the threshold
    lies between the two values' densities, the other voxels unchanged."""
    probed = torch.zeros(gcfg.nr_voxels, dtype=torch.bool)
    probed[lin.long()] = True
    for a, b in ((got.values, before.values), (got.occupancy, before.occupancy)):
        np.testing.assert_array_equal(a[~probed].numpy(), b[~probed].numpy())
    vk, vp = got.values[probed], want.values[probed]
    assert float((vk - vp).abs().max()) <= TOL_FUSED_POS
    flags_differ = got.occupancy[probed] != want.occupancy[probed]
    x = lambda v: torch.clamp(v.abs() - gcfg.half_diagonal, 0.0, 1e10)  # noqa: E731
    dk = og._logistic_density(x(vk), torch.tensor(_IF_INV_S))
    dp = og._logistic_density(x(vp), torch.tensor(_IF_INV_S))
    between = (torch.minimum(dk, dp) <= thresh) & (thresh <= torch.maximum(dk, dp))
    assert not bool((flags_differ & ~between).any())
    assert int(flags_differ.sum()) <= FUSED_FLAG_ROWS


def _launch_counts():
    return (og.grid_refresh_cuda.launches, og.grid_points_cuda.launches,
            og.grid_update_cuda.launches, pe.encode_fwd_cuda.launches)


@pytest.mark.parametrize("K,c2f_active,wrap,jitter", [(6, True, False, True),
                                                      (4, False, True, True),
                                                      (6, False, True, False),
                                                      (4, True, False, False)])
def test_kernel_If_source_matches_plain(emulated, monkeypatch, K, c2f_active, wrap, jitter):
    """Kernel If (the refresh's probes, the flagship SDF at their centers and
    the update, in one launch) against its plain version (entry 1, the SDF,
    entry 2) on the planted plane over a 16^3 grid, where many probes lie
    near the occupancy threshold: on all L = 6 levels and on K = 4 < L, a
    c2f window that is active and one that is fully open, update 0 and one
    whose probe index wraps the uint32, with and without jitter. The jittered
    cases run through the trainer's ``occupancy_update``, the others through
    ``refresh_with_sdf``: one launch of If, none of entry 1, entry 2 or A."""
    from permuto_sdf_tpu_torch.models.fields import SDFEval, _c2f_t
    from permuto_sdf_tpu_torch.train import train_permuto_sdf as tps

    n, every = 512, 8
    update_idx = 2 ** 23 + 1 if wrap else 0  # 2^23 x 512 probes: the index wraps
    it = update_idx * every + 3
    tcfg = tps.PermutoSDFTrainConfig(
        capacity=2 ** 12, nr_levels=6, grid_nr_voxels_per_dim=16, grid_nr_random_samples=n,
        grid_update_every=every, grid_update_max_levels=K if K < 6 else None,
        sdf_nr_iters_for_c2f=4 * it + 100 if c2f_active else 1)
    assert (pe.coarse2fine_window(_c2f_t(it, tcfg.sdf_nr_iters_for_c2f), 6).min() < 1.0) == (
        c2f_active)
    _, params = _planted_sdf(6)
    gcfg = tcfg.grid
    sdf_eval = SDFEval(tcfg.sdf_model,
                       tcfg.grid_update_max_levels or tcfg.imp_sampling_max_levels)
    rng = np.random.default_rng(K + 2 * wrap)
    jit = (torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)) if jitter
           else None)
    before = _if_grid(16, K)
    want = og.grid_refresh_plain(gcfg, _if_grid(16, K), sdf_eval, (params, it), n, update_idx,
                                 jit, _IF_INV_S, 1e-4)
    monkeypatch.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: cuda_fn)
    counts = _launch_counts()
    got = _if_grid(16, K)
    if jitter:
        tps.occupancy_update({"sdf": params}, got, jit, it, _IF_INV_S, tcfg)
    else:
        og.refresh_with_sdf(gcfg, got, sdf_eval, (params, it), n, update_idx, None, _IF_INV_S,
                            1e-4)
    assert _launch_counts() == (counts[0] + 1,) + counts[1:]
    _, lin = og.grid_points_plain(gcfg, n, update_idx, jit)
    _assert_refresh_close(gcfg, got, want, before, lin, 1e-4)
    near = want.values[lin.long()].abs() < 0.15
    assert int(near.sum()) > 50 and 10 < int(want.occupancy[lin.long()].sum()) < n - 10


def test_grid_refresh_of_other_sdfs_takes_the_unfused_route(emulated, monkeypatch):
    """An SDF whose MLP has other widths than the fused kernels evaluate
    (a hidden layer of 64) is refreshed by entry 1, the SDF (kernel A and
    the MLP) and entry 2, one launch each and none of If, exactly as the
    plain version; the route is chosen before any launch."""
    from permuto_sdf_tpu_torch.models.fields import SDFEval
    from permuto_sdf_tpu_torch.models.mlp import init_mlp
    from permuto_sdf_tpu_torch.ops import sdf_net as sn

    cfg, params = _planted_sdf(4)
    params = {**params, "mlp_sdf": init_mlp(torch.Generator().manual_seed(5),
                                            [2 * 4 + 3, 64, 32, 32, 33])}
    assert not sn.fused_sdf_supported(cfg, params)
    gcfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    jit = torch.from_numpy(np.random.default_rng(9).uniform(-0.5, 0.5, (256, 3)).astype(
        np.float32))
    args = (SDFEval(cfg), (params, 50), 256, 7, jit, _IF_INV_S, 1e-4)
    want = og.grid_refresh_plain(gcfg, _if_grid(16, 1), *args)
    monkeypatch.setattr(kernels, "dispatch", lambda dev, cuda_fn, plain_fn: cuda_fn)
    counts = _launch_counts()
    got = og.refresh_with_sdf(gcfg, _if_grid(16, 1), *args)
    assert _launch_counts() == (counts[0], counts[1] + 1, counts[2] + 1, counts[3] + 1)
    for a, b in ((got.values, want.values), (got.occupancy, want.occupancy)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(NotImplementedError, match="MLP"):
        og.grid_refresh_cuda(gcfg, _if_grid(16, 1), *args)


@pytest.mark.parametrize("warps,per_sm", [(4, -1), (8, 0), (4, 0), (8, 2)])
def test_kernel_If_shapes_match_the_port(emulated, cpu_kernels, warps, per_sm):
    """The shapes kernel If was measured against
    (``profiling/grid_refresh_variant.cu``: 4 warps a tile, persistent
    blocks that stride over the tiles; the emulation reports 2 streaming
    multiprocessors) write the port's grid bit for bit."""
    from permuto_sdf_tpu_torch.models.fields import SDFEval
    from permuto_sdf_tpu_torch.ops import sdf_net as sn

    lib = cpu_kernels["grid_refresh_variant"]
    _P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.psdf_grid_refresh_design.argtypes = ([_I, _U, _I] + [_F] * 5 + [_P] * 2 + [_F] * 3
                                             + [_P] * 2 + [_I, _I, _P])
    cfg, params = _planted_sdf(6)
    gcfg = og.OccupancyGridConfig(nr_voxels_per_dim=16)
    n, upd = 300, 5  # a ragged last tile
    jit = torch.from_numpy(np.random.default_rng(2).uniform(-0.5, 0.5, (n, 3)).astype(
        np.float32))
    sdf_eval = SDFEval(cfg, 4)
    want = og.grid_refresh_cuda(gcfg, _if_grid(16, 3), sdf_eval, (params, 30), n, upd, jit,
                                _IF_INV_S, 1e-4)
    got = _if_grid(16, 3)
    net, keep = sn.sdf_net(sdf_eval, (params, 30), torch.device("cpu"))
    err = lib.psdf_grid_refresh_design(
        n, upd, 16, gcfg.voxel_size, gcfg.grid_extent / 2.0, 0.0, 0.0, 0.0, kernels.ptr(jit),
        ctypes.byref(net), _IF_INV_S, gcfg.half_diagonal, 1e-4, kernels.ptr(got.values),
        kernels.ptr(got.occupancy), warps, per_sm, None)
    assert err == 0
    np.testing.assert_array_equal(got.values.numpy(), want.values.numpy())
    np.testing.assert_array_equal(got.occupancy.numpy(), want.occupancy.numpy())
