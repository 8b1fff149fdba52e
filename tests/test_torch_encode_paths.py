"""``profiling/torch_encode_paths.py``: its summary of several runs, and its
refusal to run without a GPU (the measurements themselves need the card)."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

SCRIPT = Path(__file__).resolve().parents[1] / "profiling" / "torch_encode_paths.py"


@pytest.fixture(scope="module")
def paths():
    spec = importlib.util.spec_from_file_location("torch_encode_paths", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _result(tree, frame_ms, busy, meshes, host=None):
    return {"encode_paths": {
        "tree": tree, "card": "x", "host": host or {},
        "frame": {"ms_all": [frame_ms, frame_ms + 4.0], "ms_median": frame_ms,
                  "profile": {"device_busy_ms": busy, "A_ms": 1.0}},
        "sdf_from_mesh": {"ms_per_step": 7.0, "profile": None,
                          "mesh_512": [{"grid_ms": g, "mesh_ms": g + 10.0} for g in meshes]}}}


def test_summarize_medians_and_ranges_per_label(paths, tmp_path, capsys):
    runs = [_result("P", 10.0, 5.0, [300.0, 310.0, 320.0], {"encode_fwd_cuda_us": 20.0}),
            _result("C", 12.0, 4.0, [280.0]),
            _result("P", 14.0, 5.5, [330.0]),
            _result("C", 11.0, 4.5, [290.0, 270.0], {"interleaved_table_hit_us": 1.5})]
    files = []
    for i, r in enumerate(runs):
        f = tmp_path / f"{i}.json"
        f.write_text(json.dumps(r) + "\n")
        files.append(str(f))
    assert paths.main(["--summarize", *files]) == 0
    lines = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines())
    assert lines["runs"] == "P 2, C 2"
    assert lines["frame.ms_median"] == "P 12 [10, 14]; C 11.5 [11, 12]"
    assert lines["frame.profile.device_busy_ms"] == "P 5.25 [5, 5.5]; C 4.25 [4, 4.5]"
    # a run's meshes count as their median, then the runs' median
    assert lines["sdf_from_mesh.mesh_512.grid_ms"] == "P 320 [310, 330]; C 280 [280, 280]"
    # a number only one tree has
    assert lines["host.interleaved_table_hit_us"] == "P -; C 1.5 [1.5, 1.5]"
    assert "frame.ms_all" not in lines and "sdf_from_mesh.profile" not in lines


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_refuses_without_a_gpu(paths, capsys):
    assert paths.main(["--root", str(SCRIPT.parents[1])]) == 2
    assert "needs a GPU" in capsys.readouterr().err
