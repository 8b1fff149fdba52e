"""Read checkpoints written by the JAX package (counterpart of
``permuto_sdf_tpu/train/checkpoint.py::load_pytree``), with numpy only.

A checkpoint is an ``.npz`` holding the leaves ``a0, a1, ...`` and a JSON
structure descriptor ``__structure__``. Dataclass (``dc``) nodes become
plain dicts keyed by their field names and named tuples (``nt``) become
tuples: no class is imported, so reading never runs code of the writer.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def _rebuild(desc: dict, arrays):
    t = desc["t"]
    if t == "none":
        return None
    if t in ("dict", "dc"):
        return {k: _rebuild(v, arrays) for k, v in desc["k"].items()}
    if t == "list":
        return [_rebuild(v, arrays) for v in desc["items"]]
    if t in ("tuple", "nt"):
        return tuple(_rebuild(v, arrays) for v in desc["items"])
    if t == "leaf":
        return np.asarray(arrays[f"a{desc['i']}"])
    raise ValueError(f"unknown checkpoint node type {t!r}")


def load_pytree(path: str) -> Any:
    with np.load(path, allow_pickle=False) as arrays:
        desc = json.loads(bytes(arrays["__structure__"]).decode())
        return _rebuild(desc, arrays)


def load_model(ckpt_folder_full: str, name: str) -> Any:
    return load_pytree(os.path.join(ckpt_folder_full, name + ".npz"))
