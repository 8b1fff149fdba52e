"""Checkpoints in the JAX package's layout (counterpart of
``permuto_sdf_tpu/train/checkpoint.py``), with numpy only.

A checkpoint is an ``.npz`` holding the leaves ``a0, a1, ...`` and a JSON
structure descriptor ``__structure__``, under
``<folder>/<experiment>/<iter>/models/<name>.npz``. Reading turns
dataclass (``dc``) nodes into plain dicts keyed by their field names and
named tuples (``nt``) into tuples: no class is imported, so reading never
runs code of the writer. Writing names the JAX package's classes by their
paths (as strings) for the optimizer state and the occupancy grid, so the
JAX trainer can resume from a checkpoint the port wrote, and the other
way round.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Any

import numpy as np
import torch

# The JAX classes whose nodes the port writes (by type name of the port's
# counterpart).
_JAX_CLASS_PATHS = {
    "AdamState": "permuto_sdf_tpu.train.optimizers:AdamState",
    "OccupancyGridState": "permuto_sdf_tpu.ops.occupancy_grid:OccupancyGridState",
}


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


def _class_path(obj) -> str:
    name = type(obj).__name__
    if name not in _JAX_CLASS_PATHS:
        raise TypeError(f"checkpoint: no JAX counterpart known for {name}")
    return _JAX_CLASS_PATHS[name]


def _flatten(obj, arrays: list) -> dict:
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, dict):
        return {"t": "dict", "k": {str(k): _flatten(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {"t": "nt", "cls": _class_path(obj),
                "items": [_flatten(v, arrays) for v in obj]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "items": [_flatten(v, arrays) for v in obj]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"t": "dc", "cls": _class_path(obj),
                "k": {f.name: _flatten(getattr(obj, f.name), arrays)
                      for f in dataclasses.fields(obj)}}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    arrays.append(np.asarray(obj))
    return {"t": "leaf", "i": len(arrays) - 1}


def save_pytree(path: str, tree: Any):
    """Write ``tree`` (dicts, lists, tuples, the optimizer state, the grid,
    tensors, numbers); written to a buffer and renamed into place."""
    arrays: list = []
    desc = _flatten(tree, arrays)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {f"a{i}": a for i, a in enumerate(arrays)}
    payload["__structure__"] = np.frombuffer(json.dumps(desc).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    with np.load(path, allow_pickle=False) as arrays:
        desc = json.loads(bytes(arrays["__structure__"]).decode())
        return _rebuild(desc, arrays)


def models_dir(ckpt_folder: str, experiment_name: str, iter_nr: int) -> str:
    return os.path.join(ckpt_folder, experiment_name, str(iter_nr), "models")


def save_model(ckpt_folder: str, experiment_name: str, iter_nr: int, name: str,
               params: Any) -> str:
    d = models_dir(ckpt_folder, experiment_name, iter_nr)
    save_pytree(os.path.join(d, name + ".npz"), params)
    return d


def load_model(ckpt_folder_full: str, name: str) -> Any:
    return load_pytree(os.path.join(ckpt_folder_full, name + ".npz"))


def save_train_state(ckpt_folder: str, experiment_name: str, iter_nr: int,
                     state: Any) -> str:
    d = models_dir(ckpt_folder, experiment_name, iter_nr)
    save_pytree(os.path.join(d, "train_state.npz"), state)
    return d


def load_train_state(ckpt_folder_full: str) -> Any:
    return load_pytree(os.path.join(ckpt_folder_full, "train_state.npz"))


def latest_checkpoint_dir(ckpt_folder: str, experiment_name: str):
    """Highest-iteration ``<ckpt>/<exp>/<iter>/models`` dir holding a train
    state, or None."""
    base = os.path.join(ckpt_folder, experiment_name)
    if not os.path.isdir(base):
        return None
    iters = sorted((int(n) for n in os.listdir(base) if n.isdigit() and os.path.isfile(
        os.path.join(base, n, "models", "train_state.npz"))), reverse=True)
    return os.path.join(base, str(iters[0]), "models") if iters else None
