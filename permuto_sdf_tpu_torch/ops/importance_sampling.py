"""SDF-guided two-round importance sampling (counterpart of
``permuto_sdf_tpu/ops/importance_sampling.py``, on the eval path's branch:
``masked=True``, ``carry_sdf=False``, no jitter).

Round 1 evaluates the SDF at the uniform samples, turns it into NeuS
section alphas, builds a normalized CDF and draws ``nr_imp_samples``; the
merged set gets another ``nr_imp_samples`` from a second round with
``inv_s_multiplier = 2``. Plain PyTorch in this slice (hot op E of the
port's kernel table).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from permuto_sdf_tpu_torch.ops import volume_rendering as vr
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples


def _weights_cdf(samples: RaySamples, sdf, inv_s_multiplier: float):
    alpha = vr.sdf2alpha_sectional(samples, sdf, inv_s_multiplier=inv_s_multiplier)
    alpha = torch.clamp(alpha, 0.0, 1.0)
    T, _ = vr.cumprod_alpha2transmittance(1.0 - alpha + 1e-7, samples.mask)
    weights = alpha * T
    _, w_sum_per_sample = vr.sum_over_each_ray(weights, samples.mask)
    weights = weights / torch.clamp(w_sum_per_sample, min=1e-6)
    return vr.compute_cdf(weights, samples.mask)


def importance_sampling_sdf_model(
    sdf_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    samples: RaySamples, t_exit, nr_imp_samples: int = 16,
) -> RaySamples:
    """``sdf_fn(pts_flat, flat_mask)`` -> sdf [N] or [N, 1]. Returns the
    merged samples (max_samples + 2 * nr_imp_samples per ray), without sdf."""
    sdf = sdf_fn(samples.flat_positions(), samples.flat_mask()).reshape(samples.mask.shape)
    samples = samples.with_sdf(sdf)
    cdf = _weights_cdf(samples, sdf, inv_s_multiplier=1.0)
    imp = vr.importance_sample(samples, cdf, nr_imp_samples)
    sdf_imp = sdf_fn(imp.flat_positions(), imp.flat_mask()).reshape(imp.mask.shape)
    imp = imp.with_sdf(sdf_imp)
    combined = vr.combine_uniform_samples_with_imp(samples, imp, t_exit)

    cdf2 = _weights_cdf(combined, combined.sdf, inv_s_multiplier=2.0)
    imp2 = vr.importance_sample(combined, cdf2, nr_imp_samples)
    # the renderer re-evaluates the merged set, so the sdf is dropped
    return vr.combine_uniform_samples_with_imp(dataclasses.replace(combined, sdf=None),
                                               dataclasses.replace(imp2, sdf=None), t_exit)
