"""The trainers' command lines, the slice as a whole: the port's flagship
and NeRF ``main`` against the JAX package's on the same argv (a DTU-layout
scene, a config file, ``--set`` overrides, ``--with_mask`` and
``--low_res``), each package's ``train`` replaced by a recorder, and the
port's two ``main`` s trained for a few iterations on the CPU at small
widths, with checkpoints the JAX package reads and ``--resume``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from permuto_sdf_tpu.train import checkpoint as jckpt
from permuto_sdf_tpu.train import train_nerf as jn
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch.train import train_nerf as tn
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt
from test_torch_config import _shared
from test_torch_datasets import assert_reels_equal, port_scene
from test_torch_train import _leaves

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = {"flagship": os.path.join(_REPO, "config", "train_permuto_sdf.cfg"),
        "nerf": os.path.join(_REPO, "config", "train_nerf.cfg")}
# small widths for the CPU runs (as tests/test_torch_train.py's _TINY and
# tests/test_torch_nerf.py's _NERF)
_TINY_SET = ["capacity=1024", "nr_levels=4", "nr_rays=32", "grid_nr_voxels_per_dim=16",
             "max_nr_samples_per_ray=8", "nr_samples_imp_sampling=4", "nr_samples_bg=4",
             "imp_sampling_max_levels=2", "sphere_init_points=512",
             "grid_nr_random_samples=512", "nr_iter_sphere_fit=8", "sdf_nr_iters_for_c2f=20",
             "warmup_iters=4"]
_NERF_SET = ["capacity=1024", "nr_levels=4", "nr_rays=32", "max_nr_samples_per_ray=16",
             "nr_samples_bg=4", "grid_nr_voxels_per_dim=16", "grid_nr_random_samples=512"]


def _record(monkeypatch, module, calls, history):
    def train(reel, cfg, **kw):
        calls.append((reel, cfg, kw))
        return None, None, history

    monkeypatch.setattr(module, "train", train)


@pytest.mark.parametrize("which", ["flagship", "nerf"])
def test_main_hands_train_what_jax_main_does(which, monkeypatch, tmp_path_factory, tmp_path):
    """The same argv through both packages' ``main``: ``train`` gets equal
    configs (every shared field), equal reels (rgb and masks exact, K and
    poses within 1e-6 relative) and equal keywords."""
    scene = port_scene(tmp_path_factory)
    argv = ["--dataset", "dtu", "--scene_dir", scene, "--config", _CFG[which],
            "--set", "nr_rays=64", "--set", "capacity=4096", "--set", "use_color_calibration=0",
            "--with_mask", "--low_res", "--nr_iters", "7",
            "--checkpoint_path", str(tmp_path), "--exp_info", "argv"]
    if which == "flagship":
        argv += ["--set", "lr_milestones=[5,6]", "--set", "train_lod_top_k=24", "--resume"]
    calls_t, calls_j = [], []
    mod_t, mod_j = (tt, jt) if which == "flagship" else (tn, jn)
    _record(monkeypatch, mod_t, calls_t, [])
    _record(monkeypatch, mod_j, calls_j, [])
    mod_t.main(argv, device="cpu")
    monkeypatch.setattr(sys, "argv", ["main"] + argv)
    mod_j.main()
    (reel_t, cfg_t, kw_t), (reel_j, cfg_j, kw_j) = calls_t[0], calls_j[0]
    assert kw_t.pop("device") == torch.device("cpu")
    assert kw_t == kw_j
    assert kw_t["nr_iters"] == 7 and kw_t["experiment_name"].endswith("_argv")
    for name, (a, b) in _shared(cfg_t, cfg_j).items():
        assert a == b, name
    assert (cfg_t.nr_rays, cfg_t.capacity, cfg_t.with_mask) == (64, 4096, True)
    assert reel_t.width == 12 and reel_t.mask is not None  # --low_res, --with_mask
    assert_reels_equal(reel_t, reel_j, K_rtol=1e-6, tf_atol=1e-6)


def test_flagship_main_trains_saves_and_resumes_on_the_cpu(tmp_path_factory, tmp_path, capsys):
    """16 iterations (8 of sphere init) at small widths: finite losses, the
    train state at iteration 16 in JAX's layout (JAX's loader reads it, its
    params equal to what ``main`` returned), then ``--resume`` with no
    value continues at 16."""
    scene = port_scene(tmp_path_factory)
    argv = ["--dataset", "dtu", "--scene_dir", scene, "--with_mask",
            "--config", _CFG["flagship"], "--checkpoint_path", str(tmp_path),
            "--exp_info", "cpu"] + [a for s in _TINY_SET for a in ("--set", s)]
    params, grid, hist = tt.main(argv + ["--nr_iters", "16"], device="cpu")
    assert hist[-1][0] == 15 and all(np.isfinite(h[1]) for h in hist)
    d = os.path.join(str(tmp_path), "permuto_sdf_cpu", "16", "models")
    st = jckpt.load_train_state(d)
    assert int(st["iter"]) == 15 and int(st["nr_rays"]) == 32
    saved, want = _leaves(st["params"]), _leaves(params)
    assert saved.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(saved[k], want[k], err_msg=k)
    assert "colorcal" in st["params"] and st["grid"] is not None
    capsys.readouterr()
    _, _, hist2 = tt.main(argv + ["--nr_iters", "20", "--resume"], device="cpu")
    assert f"resumed from {d} at iter 16" in capsys.readouterr().out
    assert [h[0] for h in hist2] == [19] and np.isfinite(hist2[-1][1])
    assert os.path.isdir(os.path.join(str(tmp_path), "permuto_sdf_cpu", "20", "models"))


def test_nerf_main_trains_and_saves_on_the_cpu(tmp_path_factory, tmp_path):
    """8 NeRF iterations at small widths from the scene: finite losses and
    the models JAX's loader reads, equal to what ``main`` returned."""
    scene = port_scene(tmp_path_factory)
    argv = ["--dataset", "dtu", "--scene_dir", scene, "--config", _CFG["nerf"],
            "--checkpoint_path", str(tmp_path), "--exp_info", "cpu", "--nr_iters", "8"]
    params, grid, hist = tn.main(argv + [a for s in _NERF_SET for a in ("--set", s)],
                                 device="cpu")
    assert hist[-1][0] == 7 and all(np.isfinite(h[1]) for h in hist)
    d = os.path.join(str(tmp_path), "nerf_cpu", "8", "models")
    for name, key in (("nerf_hash_model", "model"), ("colorcal_model", "colorcal")):
        saved, want = _leaves(jckpt.load_model(d, name)), _leaves(params[key])
        assert saved.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(saved[k], want[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(jckpt.load_model(d, "occupancy_grid").occupancy),
                                  grid.occupancy.numpy())


def test_mains_need_the_gpu_for_device_none(monkeypatch):
    """device=None means the GPU: both ``main`` s raise without one, before
    they read or render anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tt.main, tn.main):
        with pytest.raises(RuntimeError, match="GPU"):
            main(["--dataset", "dtu", "--scene_dir", "/nonexistent"])
    with pytest.raises(RuntimeError, match="GPU"):
        tt.main(["--smoke"])
