"""Carry parameters from the JAX package into the port.

:func:`params_from_jax` takes a tree of numpy arrays (a JAX params pytree
after ``np.asarray`` on every leaf, or what
:func:`permuto_sdf_tpu_torch.train.checkpoint.load_pytree` returns) and
gives the same tree of float32 torch tensors: the same names and the same
layouts (``lattice_values`` stays ``[L, F, C]``, MLP weights stay
``[fan_in, fan_out]``). :func:`opt_state_from_jax` carries the JAX
``AdamState`` (mu, nu, count) across the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from permuto_sdf_tpu_torch.device import resolve_device


def _convert(node, device):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_convert(v, device) for v in node)
    arr = np.asarray(node)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(device)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def params_from_jax(tree, device=None):
    """Tree of numpy arrays -> same tree of torch tensors on ``device``
    (None means the GPU)."""
    return _convert(tree, resolve_device(device))


def opt_state_from_jax(state, device=None):
    """JAX ``AdamState(mu, nu, count)`` (or the ``(mu, nu, count)`` tuple a
    checkpoint reads back as) -> the port's ``AdamState`` on ``device``
    (None means the GPU); count stays int32 of shape (1,) on the CPU."""
    from permuto_sdf_tpu_torch.train.optimizers import AdamState

    mu, nu, count = state
    return AdamState(mu=params_from_jax(mu, device), nu=params_from_jax(nu, device),
                     count=torch.from_numpy(np.asarray(count, dtype=np.int32).reshape(1)))
