"""Adam for trees of tensors (counterpart of
``permuto_sdf_tpu/train/optimizers.py::ManualAdam``, without its unused
weight decay: the trainer decays its two groups itself).

The same math as the JAX optimizer, so one step matches it: betas
0.9/0.99, eps 1e-15 added outside the square root, and the bias
correction folded into one step scale and one effective epsilon,
``p -= (lr sqrt(b2c) / b1c) m / (sqrt(v) + eps sqrt(b2c))``, computed in
float32. The port updates parameters and moments in place (JAX's arrays
are immutable and its update returns new ones).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # shape (1,) int32, as in the JAX state


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class ManualAdam:
    """Adam with the learning rate given at each step."""

    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-15

    def init(self, params) -> AdamState:
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return AdamState(mu=zeros(), nu=zeros(), count=torch.zeros((1,), dtype=torch.int32))

    def step_scalars(self, count: int, lr):
        """(scale, eps_eff) in float32, as JAX forms them."""
        c = np.float32(count)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bias1 = np.float32(1.0) - b1 ** c
        bias2 = np.float32(1.0) - b2 ** c
        scale = np.float32(np.float32(lr) * np.sqrt(bias2) / bias1)
        eps_eff = np.float32(np.float32(self.eps) * np.sqrt(bias2))
        return float(scale), float(eps_eff)

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, lr):
        """One step at learning rate ``lr``, in place. ``grads`` is a tree
        like ``params`` (a None leaf counts as a zero gradient). Returns
        (params, new state)."""
        count = state.count + 1
        scale, eps_eff = self.step_scalars(int(count[0]), lr)
        b1, b2 = self.b1, self.b2
        for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(grads)):
            if g is None:
                g = torch.zeros_like(p)
            m.mul_(b1).add_(g * (1.0 - b1))
            v.mul_(b2).add_((g * (1.0 - b2)) * g)
            p.sub_((m * scale) / (torch.sqrt(v) + eps_eff))
        return params, AdamState(mu=state.mu, nu=state.nu, count=count)
