"""Port parity of the dataset layer: the port's PNG codec
(``datasets/image_io.py``) against ``imageio`` and ``cv2``, the projection
decomposition against ``cv2.decomposeProjectionMatrix`` (through the JAX
loader's ``load_K_Rt_from_P``), DTU scenes written by either package and
read by both, the reel helpers (``quantize_reel``, the two ray samplers,
``crop_reel_to_sphere``, ``shard_reel``), the bench scene and the textured
background, the multiface and custom-scene loaders and ``create_reel``,
each against the JAX package on the same inputs.

The samplers' draws are JAX's ``randint`` draws from its key splits,
passed to the port as ``indices``. Each test states its tolerance.
"""

import json
import os
import shutil
import struct
import zlib

import numpy as np
import imageio.v2 as imageio
import cv2
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from permuto_sdf_tpu.datasets import dtu as jdtu
from permuto_sdf_tpu.datasets import factory as jfactory
from permuto_sdf_tpu.datasets import multiface as jmf
from permuto_sdf_tpu.datasets import synthetic as jsyn
from permuto_sdf_tpu.datasets import tensor_reel as jreel
from permuto_sdf_tpu.experiments import run_custom_dataset as jcustom
from permuto_sdf_tpu_torch.datasets import dtu as tdtu
from permuto_sdf_tpu_torch.datasets import factory as tfactory
from permuto_sdf_tpu_torch.datasets import image_io
from permuto_sdf_tpu_torch.datasets import multiface as tmf
from permuto_sdf_tpu_torch.datasets import synthetic as tsyn
from permuto_sdf_tpu_torch.datasets import tensor_reel as treel
from permuto_sdf_tpu_torch.experiments import run_custom_dataset as tcustom
from torch_shared_steps import shared_dir

# ---------------------------------------------------------------------------
# shared scenes and helpers
# ---------------------------------------------------------------------------


def port_reel(nr_views=3, width=24, height=24):
    """The port's sphere + torus reel (the exported scene's source)."""
    return tsyn.make_synthetic_reel(nr_views=nr_views, width=width, height=height,
                                    device="cpu")


def port_scene(tmp_path_factory, with_mask=True) -> str:
    """A 3-view 24^2 scene exported by the port, once per session."""
    def write(path):
        reel = port_reel()
        if not with_mask:
            reel = treel.TensorReel(reel.rgb, None, reel.K, reel.tf_world_cam)
        tdtu.export_dtu_scene(reel, path)

    return shared_dir(tmp_path_factory, "port_dtu_scene" + ("" if with_mask else "_nomask"),
                      write)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_reels_equal(got, want, K_rtol=0.0, tf_atol=0.0, rgb_atol=0.0):
    """The port's reel (torch) against JAX's (jnp), field by field; K
    within ``K_rtol`` of its largest entry."""
    assert (got.mask is None) == (want.mask is None)
    np.testing.assert_allclose(_np(got.rgb), _np(want.rgb), rtol=0, atol=rgb_atol)
    if got.mask is not None:
        np.testing.assert_array_equal(_np(got.mask), _np(want.mask))
    np.testing.assert_allclose(_np(got.K), _np(want.K), rtol=0,
                               atol=K_rtol * np.abs(_np(want.K)).max())
    np.testing.assert_allclose(_np(got.tf_world_cam), _np(want.tf_world_cam), rtol=0,
                               atol=tf_atol)


def jax_draws(key, reel_j, n):
    """The (image ids, pixel ids) JAX's samplers draw from ``key``
    (tensor_reel.py:122-125 and :178-181)."""
    k_img, k_pix = jax.random.split(key)
    img = jax.random.randint(k_img, (n,), 0, reel_j.nr_images)
    pix = jax.random.randint(k_pix, (n,), 0, reel_j.height * reel_j.width)
    return np.array(img), np.array(pix)


def to_jax(reel_t):
    return jreel.TensorReel(
        rgb=jnp.asarray(_np(reel_t.rgb)),
        mask=None if reel_t.mask is None else jnp.asarray(_np(reel_t.mask)),
        K=jnp.asarray(_np(reel_t.K)), tf_world_cam=jnp.asarray(_np(reel_t.tf_world_cam)),
        img_ids=None if reel_t.img_ids is None else jnp.asarray(_np(reel_t.img_ids)))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_CTYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def _paeth_ref(a: int, b: int, c: int) -> int:
    """The Paeth predictor as the PNG specification states it."""
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode_ref(img: np.ndarray, ftypes) -> bytes:
    """A scalar reference encoder: each row of uint8 [H, W, C] filtered
    with its own type (0-4), the image data split over two IDAT chunks."""
    h, w, c = img.shape
    rows = img.astype(np.int64).reshape(h, w * c)
    out = bytearray()
    for y in range(h):
        f = int(ftypes[y])
        out.append(f)
        for i in range(w * c):
            x = int(rows[y, i])
            a = int(rows[y, i - c]) if i >= c else 0
            b = int(rows[y - 1, i]) if y else 0
            cc = int(rows[y - 1, i - c]) if y and i >= c else 0
            pred = (0, a, b, (a + b) // 2, _paeth_ref(a, b, cc))[f]
            out.append((x - pred) % 256)
    z = zlib.compress(bytes(out), 9)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _CTYPE[c], 0, 0, 0)
    return image_io.PNG_SIGNATURE + b"".join(
        image_io._chunk(k, p) for k, p in
        ((b"IHDR", ihdr), (b"IDAT", z[:len(z) // 2]), (b"IDAT", z[len(z) // 2:]),
         (b"IEND", b"")))


def _image(h, w, c, seed):
    """Smooth gradients plus noise, so the filters see both kinds of data."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 11 + yy * 3 + 40 * k) % 256 for k in range(c)], -1)
    return ((base + rng.integers(0, 40, base.shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_read_png_every_filter_matches_imageio(channels, filt, tmp_path):
    """Bit-equal to the source and to imageio, shapes included (grey 2-D)."""
    img = _image(13, 17, channels, seed=channels)
    ftypes = (np.random.default_rng(7).integers(0, 5, 13) if filt == "mixed"
              else [filt] * 13)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_encode_ref(img, ftypes))
    got, ref = image_io.read_png(path), imageio.imread(path)
    want = img[..., 0] if channels == 1 else img
    assert got.dtype == np.uint8 and got.shape == ref.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("writer", ["imageio", "cv2"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_of_library_files_matches_imageio(writer, channels, tmp_path):
    """Files libpng/zlib-based writers chose the filters for, several read
    in one diagonal walk (three files of one shape, one of another)."""
    paths, want = [], []
    for i, (h, w) in enumerate([(31, 45), (31, 45), (20, 9), (31, 45)]):
        img = _image(h, w, channels, seed=10 * channels + i)
        p = str(tmp_path / f"{i}.png")
        if writer == "imageio":
            imageio.imwrite(p, img[..., 0] if channels == 1 else img)
        else:  # cv2 takes BGR(A)
            cv2.imwrite(p, img[..., 0] if channels == 1 else img[..., [2, 1, 0, 3][:channels]])
        paths.append(p)
        want.append(imageio.imread(p))
    for got, ref in zip(image_io.read_pngs(paths), want):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(image_io.read_png(paths[2]), want[2])


@pytest.mark.parametrize("shape", [(19, 23), (19, 23, 1), (19, 23, 3), (1, 1, 3)])
def test_write_png_reads_back_in_imageio(shape, tmp_path):
    img = _image(*shape[:2], 3, seed=3)[..., :shape[2] if len(shape) == 3 else 1]
    img = img.reshape(shape)
    path = str(tmp_path / "w.png")
    image_io.write_png(path, img)
    want = img.reshape(shape[:2]) if len(shape) == 2 or shape[2] == 1 else img
    np.testing.assert_array_equal(imageio.imread(path), want)
    np.testing.assert_array_equal(image_io.read_png(path), want)
    with open(path, "rb") as f:  # every row Paeth-filtered
        raw = zlib.decompress(b"".join(p for k, p in image_io._chunks(f.read(), path)
                                       if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(shape[0], -1)
    assert (rows[:, 0] == 4).all()


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    p16, pal, pj = (str(tmp_path / n) for n in ("u16.png", "p.png", "x.jpg"))
    cv2.imwrite(p16, (np.arange(12).reshape(3, 4) * 1000).astype(np.uint16))
    Image.fromarray(_image(5, 7, 1, 0)[..., 0]).convert("P").save(pal)
    cv2.imwrite(pj, _image(5, 7, 3, 0))
    for path, what in ((p16, "bit depth 16"), (pal, "colour type 3")):
        with pytest.raises(NotImplementedError, match=what):
            image_io.read_png(path)
    with pytest.raises(NotImplementedError, match="JPEG"):
        image_io.read_png(pj)
    # an interlaced header (Adam7), and a corrupt chunk
    good = _encode_ref(_image(4, 4, 3, 0), [1] * 4)
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    inter = good[:8] + image_io._chunk(b"IHDR", ihdr) + good[33:]
    for name, data, err, what in (("i.png", inter, NotImplementedError, "interlace 1"),
                                  ("c.png", good[:40] + b"\0" + good[41:], ValueError,
                                   "corrupt")):
        with open(tmp_path / name, "wb") as f:
            f.write(data)
        with pytest.raises(err, match=what):
            image_io.read_png(str(tmp_path / name))


# ---------------------------------------------------------------------------
# the projection decomposition
# ---------------------------------------------------------------------------


def _random_P(rng, scale, skew):
    K = np.array([[rng.uniform(300, 3000), skew, rng.uniform(100, 900)],
                  [0, rng.uniform(300, 3000), rng.uniform(100, 700)], [0, 0, 1]])
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    Q *= np.sign(np.linalg.det(Q))
    t = rng.normal(size=(3, 1)) * 2
    return scale * K @ np.concatenate([Q, t], 1)


@pytest.mark.parametrize("scale", [1.0, -1.0, 0.37, -2.5, 1e-3])
@pytest.mark.parametrize("skew", [0.0, 3.5])
def test_load_K_Rt_from_P_matches_cv2(scale, skew):
    """cv2's convention, signs included, within 1e-6 relative; also on
    arbitrary 3x4 matrices (every branch of the sign rule)."""
    rng = np.random.default_rng(int(abs(scale) * 1000) + int(skew))
    Ps = [_random_P(rng, scale, skew) for _ in range(20)]
    Ps += [rng.normal(size=(3, 4)) * 100 * scale for _ in range(20)]
    for P in Ps:
        K_t, pose_t = tdtu.load_K_Rt_from_P(P)
        K_j, pose_j = jdtu.load_K_Rt_from_P(P)
        assert K_t.dtype == K_j.dtype == np.float32
        np.testing.assert_allclose(K_t, K_j, rtol=1e-6, atol=1e-6 * np.abs(K_j).max())
        np.testing.assert_allclose(pose_t, pose_j, rtol=1e-6,
                                   atol=1e-6 * max(1.0, np.abs(pose_j).max()))
    # the example of a negative scale: both focal entries stay negative
    if scale < 0 and skew == 0.0:
        assert (np.diag(tdtu.load_K_Rt_from_P(Ps[0])[0])[:2] < 0).all()


# ---------------------------------------------------------------------------
# DTU scenes
# ---------------------------------------------------------------------------


def test_jax_exported_scene_loads_equally(tmp_path_factory):
    """JAX writes (imageio); both packages read: rgb and masks exact, K and
    poses within 1e-6 relative (the two decompositions agree to ~1e-15
    before the float32 cast)."""
    def write(path):
        jdtu.export_dtu_scene(jsyn.make_synthetic_reel(nr_views=3, width=24, height=20), path)

    scene = shared_dir(tmp_path_factory, "jax_dtu_scene", write)
    for kw in ({}, {"low_res": True}, {"with_mask": False}):
        got = tdtu.load_dtu_scene(scene, device="cpu", **kw)
        want = jdtu.load_dtu_scene(scene, **kw)
        assert_reels_equal(got, want, K_rtol=1e-6, tf_atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"low_res": True}, {"with_mask": False}, "no_mask_files"])
def test_port_exported_scene_loads_in_jax(kw, tmp_path_factory):
    """The port writes; JAX's loader gives the source reel back at its own
    round-trip tolerances (tests/test_datasets.py:239-251: K 2e-3, poses
    1e-4, rgb < 1/254, masks exact), and the port's loader gives JAX's."""
    scene = port_scene(tmp_path_factory, with_mask=kw != "no_mask_files")
    kw = {} if kw == "no_mask_files" else kw
    src = port_reel()
    want = jdtu.load_dtu_scene(scene, **kw)
    got = tdtu.load_dtu_scene(scene, device="cpu", **kw)
    assert_reels_equal(got, want, K_rtol=1e-6, tf_atol=1e-6)
    sub = 2 if kw.get("low_res") else 1
    K_src = _np(src.K).copy()
    K_src[:, :2] /= sub
    np.testing.assert_allclose(np.asarray(want.K), K_src, rtol=0, atol=2e-3)
    np.testing.assert_allclose(np.asarray(want.tf_world_cam), _np(src.tf_world_cam), atol=1e-4)
    rgb_src = _np(src.rgb)[:, ::sub, ::sub]
    assert np.abs(np.asarray(want.rgb) - rgb_src).max() < 1 / 254
    if want.mask is not None:
        np.testing.assert_array_equal(np.asarray(want.mask), _np(src.mask)[:, ::sub, ::sub])
    assert (want.mask is None) == (kw.get("with_mask") is False or "mask" not in
                                   os.listdir(scene))


def test_export_of_a_uint8_reel_and_a_jpeg_scene(tmp_path_factory, tmp_path):
    """export_dtu_scene takes a quantized reel (the same files); a scene of
    JPEG images raises NotImplementedError naming JPEG."""
    scene = port_scene(tmp_path_factory)
    d = str(tmp_path / "q")
    tdtu.export_dtu_scene(treel.quantize_reel(port_reel()), d)
    for sub in ("image", "mask"):
        for name in sorted(os.listdir(os.path.join(scene, sub))):
            np.testing.assert_array_equal(image_io.read_png(os.path.join(d, sub, name)),
                                          imageio.imread(os.path.join(scene, sub, name)))
    j = str(tmp_path / "jpg")
    os.makedirs(os.path.join(j, "image"))
    shutil.copy(os.path.join(scene, "cameras.npz"), j)
    cv2.imwrite(os.path.join(j, "image", "000000.jpg"), _image(8, 8, 3, 0))
    with pytest.raises(NotImplementedError, match="JPEG"):
        tdtu.load_dtu_scene(j, device="cpu")


# ---------------------------------------------------------------------------
# the reel helpers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reels():
    """(port reel, JAX reel) of the same seeded float images and masks."""
    rng = np.random.default_rng(0)
    n, h, w = 3, 12, 16
    rgb = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    mask = (rng.uniform(size=(n, h, w, 1)) > 0.5).astype(np.float32)
    K = np.tile(np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]], np.float32), (n, 1, 1))
    tf = np.stack([jreel.look_at_cam_to_world(e) for e in
                   [(0, 0, -2.0), (1.5, 0.5, -1.5), (-1.0, 1.0, -1.8)]]).astype(np.float32)
    t = treel.TensorReel(torch.from_numpy(rgb), torch.from_numpy(mask), torch.from_numpy(K),
                         torch.from_numpy(tf))
    return t, to_jax(t)


def test_quantize_reel_matches_jax(reels):
    t, j = reels
    got, want = treel.quantize_reel(t), jreel.quantize_reel(j)
    assert got.rgb.dtype == torch.uint8 and got.mask.dtype == torch.uint8
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(want.rgb))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert treel.quantize_reel(got).rgb is got.rgb  # already quantized


def _assert_rays(got, want, idx_equal=True):
    """Origins and directions within 1e-6, gt rgb and mask within 1e-7 (the
    same gathered values), image ids exact."""
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4]))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("apply_mask", [False, True])
def test_random_rays_from_reel_matches_jax(reels, quantized, apply_mask):
    t, j = reels
    if quantized:
        t, j = treel.quantize_reel(t), jreel.quantize_reel(j)
    key = jax.random.PRNGKey(3)
    want = jreel.random_rays_from_reel(j, key, 256, apply_mask=apply_mask)
    got = treel.random_rays_from_reel(t, 256, indices=jax_draws(key, j, 256),
                                      apply_mask=apply_mask)
    assert got[2].dtype == torch.float32
    _assert_rays(got, want)
    if quantized:  # the uint8 reel gives the float reel's rays on 8-bit data
        f = treel.TensorReel(treel._dequant(t.rgb), treel._dequant(t.mask), t.K, t.tf_world_cam)
        ref = treel.random_rays_from_reel(f, 256, indices=jax_draws(key, j, 256),
                                          apply_mask=apply_mask)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("quantized", [False, True])
def test_rays_from_reprojection_reel_matches_jax(reels, quantized):
    """Points in front of some cameras and outside others (the random
    pixel fallback), JAX's draws replayed: equal within 1e-5 (the pixel a
    projection lands on is the same, so the targets are equal)."""
    t, j = reels
    if quantized:
        t, j = treel.quantize_reel(t), jreel.quantize_reel(j)
    pts = np.random.default_rng(1).uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jreel.rays_from_reprojection_reel(j, key, pts)
    got = treel.rays_from_reprojection_reel(t, pts, indices=jax_draws(key, j, 300))
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4]))


def test_shard_reel_reports_global_ids(reels):
    t, j = reels
    got, want = treel.shard_reel(t, 2), jreel.shard_reel(j, 2)
    assert got.nr_images == want.nr_images == 4
    np.testing.assert_array_equal(got.img_ids.numpy(), np.asarray(want.img_ids))
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(want.rgb))
    assert got.to("cpu").img_ids is not None  # .to() carries the ids
    shard_t = treel.TensorReel(*(x[2:] for x in (got.rgb, got.mask, got.K, got.tf_world_cam,
                                                 got.img_ids)))
    shard_j = jreel.TensorReel(*(x[2:] for x in (want.rgb, want.mask, want.K,
                                                 want.tf_world_cam, want.img_ids)))
    key = jax.random.PRNGKey(9)
    g = treel.random_rays_from_reel(shard_t, 64, indices=jax_draws(key, shard_j, 64))
    w = jreel.random_rays_from_reel(shard_j, key, 64)
    _assert_rays(g, w)
    assert set(_np(g[4]).tolist()) <= {2, 0}  # rows 2, 3 are images 2 and 0
    # sharding a shard keeps the global ids
    np.testing.assert_array_equal(treel.shard_reel(shard_t, 1).img_ids.numpy(),
                                  np.asarray(jreel.shard_reel(shard_j, 1).img_ids))


def test_crop_reel_to_sphere_matches_jax():
    src = tsyn.make_synthetic_reel(nr_views=3, width=48, height=40, fov_deg=60.0, device="cpu")
    got = treel.crop_reel_to_sphere(src, radius=0.5)
    want = jreel.crop_reel_to_sphere(to_jax(src), radius=0.5)
    assert got.rgb.shape == want.rgb.shape and got.height < 40 and got.width < 48
    assert_reels_equal(got, want)


# ---------------------------------------------------------------------------
# the synthetic scenes
# ---------------------------------------------------------------------------


def test_bench_scene_and_sky_match_jax():
    """bench_scene_sdf and bg_color_at on 8,192 seeded points within 1e-6;
    the scene's normal within 1e-4 where both packages' are finite (the
    gradient of a norm at a zero vector is NaN in both; where, differs)."""
    p = np.random.default_rng(4).uniform(-0.6, 0.6, (8192, 3)).astype(np.float32)
    np.testing.assert_allclose(tsyn.bench_scene_sdf(torch.from_numpy(p)).numpy(),
                               np.asarray(jsyn.bench_scene_sdf(jnp.asarray(p))), atol=1e-6)
    q = p * 8.0  # points around the sky sphere (r = 4)
    np.testing.assert_allclose(tsyn.bg_color_at(torch.from_numpy(q)).numpy(),
                               np.asarray(jsyn.bg_color_at(jnp.asarray(q))), atol=1e-6)
    n_t = tsyn.scene_normal(torch.from_numpy(p), sdf_fn=tsyn.bench_scene_sdf).numpy()
    n_j = np.asarray(jsyn.scene_normal(jnp.asarray(p), sdf_fn=jsyn.bench_scene_sdf))
    both = np.isfinite(n_t).all(-1) & np.isfinite(n_j).all(-1)
    assert both.mean() > 0.9
    np.testing.assert_allclose(n_t[both], n_j[both], atol=1e-4)


def test_bench_scene_reel_matches_jax():
    """make_synthetic_reel(sdf_fn=bench_scene_sdf, fov_deg=45,
    bg_mode="textured"): the masks agree but for a few silhouette pixels,
    colours within 1e-3 elsewhere (as the sphere + torus reel's test)."""
    kw = dict(nr_views=3, width=32, height=32, fov_deg=45.0, bg_mode="textured")
    want = jsyn.make_synthetic_reel(sdf_fn=jsyn.bench_scene_sdf, **kw)
    got = tsyn.make_synthetic_reel(sdf_fn=tsyn.bench_scene_sdf, device="cpu", **kw)
    mask_j = np.asarray(want.mask)
    agree = got.mask.numpy() == mask_j
    assert agree.mean() > 0.98 and 0.05 < mask_j.mean() < 0.95
    np.testing.assert_allclose(got.K.numpy(), np.asarray(want.K))
    np.testing.assert_allclose(got.tf_world_cam.numpy(), np.asarray(want.tf_world_cam),
                               atol=1e-6)
    ok = np.broadcast_to(agree, got.rgb.shape)
    np.testing.assert_allclose(got.rgb.numpy()[ok], np.asarray(want.rgb)[ok], atol=1e-3)
    bg = ~got.mask.numpy()[..., 0].astype(bool)
    assert got.rgb.numpy()[bg].std(axis=0).min() > 0.02  # textured, not constant


# ---------------------------------------------------------------------------
# multiface, custom scenes, create_reel
# ---------------------------------------------------------------------------


def write_multiface(root, subject, cams, h=24, w=32):
    """A KRT file and one PNG per camera (written by imageio). Each camera
    sits 1.5 units from the origin of the scene frame, looking along +z."""
    sdir = os.path.join(root, subject.subject_name)
    Rx = jmf._rot_x(subject.scene_rotate_x_angle)
    trans = np.asarray(subject.scene_translation)
    lines = []
    for i, cam in enumerate(cams):
        K = np.array([[40.0 + i, 0, w / 2], [0, 41.0, h / 2], [0, 0, 1]])
        C2 = np.array([0.1 * i, -0.05 * i, -1.5])
        C = Rx.T @ (C2 / subject.scene_scale_multiplier - trans)
        R_wc = Rx  # camera-to-scene rotation Rx @ R_wc^T = identity
        Rt = np.concatenate([R_wc, (-R_wc @ C)[:, None]], 1)
        lines += [str(cam)] + [" ".join(repr(float(v)) for v in row) for row in K]
        lines += ["0 0 0 0 0"] + [" ".join(repr(float(v)) for v in row) for row in Rt] + [""]
        d = os.path.join(sdir, "images", subject.sequence, str(cam))
        os.makedirs(d, exist_ok=True)
        imageio.imwrite(os.path.join(d, "000000.png"), _image(h, w, 3, seed=i))
    with open(os.path.join(sdir, "KRT"), "w") as f:
        f.write("\n".join(lines))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_multiface_scene_matches_jax(mode, tmp_path):
    subj = jmf.MultifaceSubject("m--test--0--1--GHS", "E001_Test", (400002,), 0, 150.0,
                                (0.07, 1.6, 2.3), 0.0023)
    write_multiface(str(tmp_path), subj, [400002, 400013, 400060])
    assert tmf.parse_krt(str(tmp_path / subj.subject_name / "KRT")).keys() == \
        jmf.parse_krt(str(tmp_path / subj.subject_name / "KRT")).keys()
    subj_t = tmf.MultifaceSubject(**{f: getattr(subj, f) for f in subj.__dataclass_fields__})
    for kw in ({}, {"low_res": True}):
        got = tmf.load_multiface_scene(str(tmp_path), subj_t, mode=mode, device="cpu", **kw)
        want = jmf.load_multiface_scene(str(tmp_path), subj, mode=mode, **kw)
        assert got.nr_images == (2 if mode == "train" else 1)
        assert_reels_equal(got, want)
    np.testing.assert_allclose(got.tf_world_cam[0, :3, :3].numpy(), np.eye(3), atol=1e-6)


def write_custom(d, n=3, h=16, w=20):
    os.makedirs(os.path.join(d, "images"))
    frames = []
    for i in range(n):
        name = f"v{i}.png"
        imageio.imwrite(os.path.join(d, "images", name), _image(h, w, 3, seed=20 + i))
        tf = jreel.look_at_cam_to_world((1.5 * np.cos(i), 0.3, 1.5 * np.sin(i)))
        frames.append({"file": name, "K": [[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]],
                       "tf_world_cam": tf.tolist()})
    with open(os.path.join(d, "cameras.json"), "w") as f:
        json.dump({"frames": frames}, f)


def test_custom_scene_matches_jax(tmp_path, tmp_path_factory):
    d = str(tmp_path / "custom")
    write_custom(d)
    for kw in ({}, {"scene_scale_multiplier": 0.4, "scene_translation": (0.1, 0.0, -0.2),
                    "subsample": 2}):
        got = tcustom.load_custom_scene(d, device="cpu", **kw)
        want = jcustom.load_custom_scene(d, **kw)
        assert_reels_equal(got, want)
    # no cameras.json: the IDR layout through the DTU loader
    scene = port_scene(tmp_path_factory)
    assert_reels_equal(tcustom.load_custom_scene(scene, 0.4, device="cpu"),
                       jcustom.load_custom_scene(scene, 0.4), K_rtol=1e-6, tf_atol=1e-6)


def test_create_reel_dispatches_like_jax(tmp_path, tmp_path_factory):
    """Every family through both factories on the same files: equal reels
    (the crop on for multiface and phenorobcp1); an unknown name raises
    ValueError in both."""
    scene = port_scene(tmp_path_factory)
    root, name = os.path.split(scene)
    custom = str(tmp_path / "custom")
    write_custom(custom, h=60, w=80)
    mf = str(tmp_path / "mf")
    write_multiface(mf, jmf.SUBJECTS[0], [400049, 400013, 400060], h=60, w=80)
    cases = [("dtu", dict(scene=name, data_root=root, with_mask=True)),
             ("bmvs", dict(data_root=scene, low_res=True)),
             ("multiface", dict(data_root=mf)),
             ("multiface", dict(scene="0", data_root=mf, mode="test", crop_to_bound=False)),
             ("custom", dict(data_root=custom)),
             ("phenorobcp1", dict(data_root=custom)),
             ("easypbr", dict(data_root=custom, low_res=True))]
    for dataset, kw in cases:
        got = tfactory.create_reel(dataset, device="cpu", **kw)
        want = jfactory.create_reel(dataset, **kw)
        assert_reels_equal(got, want, K_rtol=1e-6, tf_atol=1e-6)
        if dataset not in ("dtu", "bmvs"):
            cropped = dataset in ("multiface", "phenorobcp1") and "crop_to_bound" not in kw
            assert (got.width < 80 // (4 if kw.get("low_res") else 1)) == cropped, dataset
    got = tfactory.create_reel("synthetic", low_res=True, device="cpu")
    assert (got.nr_images, got.height, got.width) == (24, 100, 100)
    for factory, kw in ((tfactory, {"device": "cpu"}), (jfactory, {})):
        with pytest.raises(ValueError, match="unknown dataset"):
            factory.create_reel("nope", **kw)
