"""Port parity of the configuration layer (``permuto_sdf_tpu_torch/config.py``
against ``permuto_sdf_tpu/config.py``): the hjson-style files read to the
same dict, and the same file and ``--set`` list put the same values on
both packages' ``PermutoSDFTrainConfig`` and ``NerfTrainConfig``. Exact
equality: the port copies the parser."""

import dataclasses
import glob
import os

import pytest

from permuto_sdf_tpu import config as jconfig
from permuto_sdf_tpu.train import train_nerf as jn
from permuto_sdf_tpu.train import train_permuto_sdf as jt
from permuto_sdf_tpu_torch import config as tconfig
from permuto_sdf_tpu_torch.train import train_nerf as tn
from permuto_sdf_tpu_torch.train import train_permuto_sdf as tt

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HJSON = """// a test config: comments of both kinds, trailing commas, unquoted keys
{
    /* the schedule
       over two lines */
    lr: 2e-3,              // a float
    nr_rays: 1024,
    "with_mask": "true",   // a bool as a string
    lr_milestones: [10, 20, 30,],
    train_lod_top_k: 24,   // a field whose default is None
    sdf_gradient_mode: "forward",  // a string
    url_like: "http://x//y",
}
"""

_SET = ["nr_iter_sphere_fit=100", "mask_weight=0.25", "use_color_calibration=0",
        "enable_curvature=true", "lr_milestones=[1,2,3]", "hit_ray_frac=0.5",
        "sdf_gradient_mode=reverse", "capacity=4096"]
_NERF_SET = ["nr_rays=256", "lr=0.005", "use_color_calibration=0", "with_mask=true",
             "grid_decay=0.5", "capacity=4096"]


def _shared(a, b) -> dict:
    """{field: (a's value, b's value)} over the fields both dataclasses have."""
    names = {f.name for f in dataclasses.fields(a)} & {f.name for f in dataclasses.fields(b)}
    return {n: (getattr(a, n), getattr(b, n)) for n in sorted(names)}


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(_REPO, "config", "*.cfg")))
                         + ["written"])
def test_config_files_read_the_same(path, tmp_path):
    if path == "written":
        path = str(tmp_path / "t.cfg")
        with open(path, "w") as f:
            f.write(_HJSON)
    assert tconfig._strip_hjson(open(path).read()) == jconfig._strip_hjson(open(path).read())
    got, want = tconfig.load_config_dict(path), jconfig.load_config_dict(path)
    assert got == want
    if path.endswith("t.cfg"):
        assert got["lr_milestones"] == [10, 20, 30] and got["url_like"] == "http://x//y"


@pytest.mark.parametrize("which", ["flagship", "nerf"])
def test_apply_file_and_cli_matches_jax(which, tmp_path):
    path = str(tmp_path / "t.cfg")
    if which == "flagship":
        with open(path, "w") as f:
            f.write(_HJSON.replace('    url_like: "http://x//y",\n', ""))
        base_t, base_j, overrides = tt.PermutoSDFTrainConfig(), jt.PermutoSDFTrainConfig(), _SET
    else:
        with open(path, "w") as f:
            f.write("{\n  nr_levels: 8, // levels\n  grid_update_every: 4,\n}\n")
        base_t, base_j, overrides = tn.NerfTrainConfig(), jn.NerfTrainConfig(), _NERF_SET
    got = tconfig.apply_file_and_cli(base_t, path, overrides)
    want = jconfig.apply_file_and_cli(base_j, path, overrides)
    shared = _shared(got, want)
    assert len(shared) >= len(dataclasses.fields(got)) - 1
    for name, (g, w) in shared.items():
        assert g == w and type(g) is type(w), (name, g, w)
    if which == "flagship":
        assert got.lr == 2e-3 and got.with_mask is True and got.train_lod_top_k == 24
        assert got.lr_milestones == (1, 2, 3) and got.sdf_gradient_mode == "reverse"
        assert got.use_color_calibration == 0 and got.capacity == 4096
        assert tconfig.load_config(tt.PermutoSDFTrainConfig, path, overrides, nr_rays=64) == \
            dataclasses.replace(got, nr_rays=64)
    else:
        assert (got.nr_levels, got.grid_update_every, got.nr_rays) == (8, 4, 256)


@pytest.mark.parametrize("which", ["flagship", "nerf"])
def test_config_errors_match_jax(which):
    base_t, base_j = ((tt.PermutoSDFTrainConfig(), jt.PermutoSDFTrainConfig())
                      if which == "flagship" else (tn.NerfTrainConfig(), jn.NerfTrainConfig()))
    for mod, base in ((tconfig, base_t), (jconfig, base_j)):
        with pytest.raises(KeyError, match="unknown config key 'nr_raysx'"):
            mod.apply_file_and_cli(base, None, ["nr_raysx=3"])
        with pytest.raises(ValueError, match="is not key=value"):
            mod.apply_file_and_cli(base, None, ["x"])
