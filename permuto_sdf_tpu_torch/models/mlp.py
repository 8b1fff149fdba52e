"""MLPs as lists of parameter dicts (counterpart of
``permuto_sdf_tpu/models/mlp.py``).

Weights keep the JAX layout ``[fan_in, fan_out]`` (``x @ w + b``), so
parameters carry across unchanged. GELU is the tanh approximation, which is
what ``jax.nn.gelu`` computes by default. Matrix products stay
``torch.matmul`` in float32 (TF32 off), as the JAX package left them to XLA.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _linear_std(fan_in: int, fan_out: int, negative_slope: float) -> float:
    gain = np.sqrt(2.0 / (1.0 + negative_slope ** 2))
    return gain * np.sqrt(2.0 / (fan_in + fan_out))


def init_linear(generator: torch.Generator, fan_in: int, fan_out: int,
                negative_slope: float = 0.0) -> dict:
    """One Linear layer with the reference init (CPU, from ``generator``)."""
    bound = float(_linear_std(fan_in, fan_out, negative_slope) * np.sqrt(3.0))
    w = (torch.rand((fan_in, fan_out), generator=generator) * 2.0 - 1.0) * bound
    return {"w": w, "b": torch.zeros((fan_out,))}


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"]) + p["b"]


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             last_layer_linear_init: bool = True) -> list:
    layers = []
    for i in range(len(dims) - 1):
        is_last = i == len(dims) - 2
        slope = 1.0 if (is_last and last_layer_linear_init) else 0.0
        layers.append(init_linear(generator, dims[i], dims[i + 1], slope))
    return layers


def mlp_apply(layers: list, x: torch.Tensor) -> torch.Tensor:
    """Linear+GELU stack; last layer linear."""
    for i, p in enumerate(layers):
        x = linear_apply(p, x)
        if i != len(layers) - 1:
            x = gelu(x)
    return x


def init_lipshitz_mlp(generator: torch.Generator, in_channels: int,
                      out_channels_per_layer: Sequence[int],
                      last_layer_linear: bool = True) -> list:
    layers = []
    fan_in = in_channels
    for i, fan_out in enumerate(out_channels_per_layer):
        is_last = i == len(out_channels_per_layer) - 1
        slope = 1.0 if (is_last and last_layer_linear) else 0.0
        lin = init_linear(generator, fan_in, fan_out, slope)
        max_w = torch.max(torch.sum(torch.abs(lin["w"]), dim=0))
        layers.append({**lin, "c": torch.ones((1,)) * max_w * 2.0})
        fan_in = fan_out
    return layers


def lipshitz_mlp_apply(layers: list, x: torch.Tensor,
                       last_layer_linear: bool = True) -> torch.Tensor:
    """Each layer's columns rescaled by min(1, softplus(c)/absrowsum)."""
    for i, p in enumerate(layers):
        softplus_c = F.softplus(p["c"])
        absrowsum = torch.sum(torch.abs(p["w"]), dim=0)
        scale = torch.clamp(softplus_c / absrowsum, max=1.0)
        w = p["w"] * scale[None, :]
        x = torch.matmul(x, w) + p["b"]
        if not (i == len(layers) - 1 and last_layer_linear):
            x = gelu(x)
    return x
