"""Dense masked ray-sample batches (counterpart of
``permuto_sdf_tpu/ops/ray_samples.py``).

A batch is ``[nr_rays, max_samples]`` with a **prefix validity mask**: all
valid samples of a ray occupy slots ``0..n-1``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class RaySamples:
    """Fields (R = nr_rays, S = max samples per ray):

    origins [R,3], dirs [R,3], z [R,S], dt [R,S], mask [R,S] bool prefix
    mask, ray_fixed_dt [R] (0 when spacing varies), optional sdf [R,S] and
    pos_4d [R,S,4] (background parameterisation)."""

    origins: torch.Tensor
    dirs: torch.Tensor
    z: torch.Tensor
    dt: torch.Tensor
    mask: torch.Tensor
    ray_fixed_dt: torch.Tensor
    sdf: Optional[torch.Tensor] = None
    pos_4d: Optional[torch.Tensor] = None

    @property
    def nr_rays(self) -> int:
        return self.z.shape[0]

    @property
    def max_samples(self) -> int:
        return self.z.shape[1]

    def nr_samples_per_ray(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)

    def positions(self) -> torch.Tensor:
        """[R, S, 3] world positions (zero at invalid slots)."""
        p = self.origins[:, None, :] + self.z[..., None] * self.dirs[:, None, :]
        return torch.where(self.mask[..., None], p, torch.zeros_like(p))

    def flat_positions(self) -> torch.Tensor:
        return self.positions().reshape(-1, 3)

    def flat_dirs(self) -> torch.Tensor:
        return self.dirs[:, None, :].expand(*self.z.shape, 3).reshape(-1, 3)

    def flat_mask(self) -> torch.Tensor:
        return self.mask.reshape(-1)

    def with_sdf(self, sdf_flat: torch.Tensor) -> "RaySamples":
        return dataclasses.replace(self, sdf=sdf_flat.reshape(self.z.shape))


def prefix_mask(nr: torch.Tensor, max_samples: int) -> torch.Tensor:
    """[R] counts -> [R, max_samples] prefix mask."""
    return torch.arange(max_samples, device=nr.device)[None, :] < nr[:, None]
