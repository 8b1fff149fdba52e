"""Dataset and checkpoint path registry (counterpart of
``permuto_sdf_tpu/datasets/paths.py``): the ``comp_name -> data root``
map, the training scene lists and the checkpoint registry. Roots come from
the ``PERMUTO_SDF_DATA_ROOT`` / ``PERMUTO_SDF_CKPT_ROOT`` environment
variables or from explicit registration.
"""

from __future__ import annotations

import os

_DATA_PATHS: dict[str, str] = {}
_CKPT_PATHS: dict[str, str] = {}

DTU_SCENES = [
    "dtu_scan24", "dtu_scan37", "dtu_scan40", "dtu_scan55", "dtu_scan63",
    "dtu_scan65", "dtu_scan69", "dtu_scan83", "dtu_scan97", "dtu_scan105",
    "dtu_scan106", "dtu_scan110", "dtu_scan114", "dtu_scan118", "dtu_scan122",
]
BMVS_SCENES = [
    "bmvs_bear", "bmvs_clock", "bmvs_dog", "bmvs_durian", "bmvs_jade",
    "bmvs_man", "bmvs_sculpture", "bmvs_stone",
]
MULTIFACE_SCENES = [f"multiface_{i}" for i in range(8)]


def register_data_path(comp_name: str, path: str):
    _DATA_PATHS[comp_name] = path


def register_checkpoint_path(name: str, path: str):
    _CKPT_PATHS[name] = path


def data_path(comp_name: str | None = None) -> str:
    if comp_name and comp_name in _DATA_PATHS:
        return _DATA_PATHS[comp_name]
    env = os.environ.get("PERMUTO_SDF_DATA_ROOT")
    if env:
        return env
    raise KeyError(
        f"no data root registered for comp_name={comp_name!r}; call "
        "register_data_path() or set PERMUTO_SDF_DATA_ROOT"
    )


def checkpoint_path(name: str | None = None) -> str:
    if name and name in _CKPT_PATHS:
        return _CKPT_PATHS[name]
    return os.environ.get("PERMUTO_SDF_CKPT_ROOT", "./checkpoints")


def scene_list(dataset: str) -> list[str]:
    return {
        "dtu": DTU_SCENES,
        "bmvs": BMVS_SCENES,
        "multiface": MULTIFACE_SCENES,
    }[dataset]
