"""SDF-guided two-round importance sampling (counterpart of
``permuto_sdf_tpu/ops/importance_sampling.py``, on the ``masked=True``
branch that the trainer and the renderers take; the jitter of the two
rounds is passed in).

Round 1 evaluates the SDF at the uniform samples, turns it into NeuS
section alphas, builds a normalized CDF and draws ``nr_imp_samples``; the
merged set gets another ``nr_imp_samples`` from a second round with
``inv_s_multiplier = 2``. On the card each round is kernel E1 and each
merge kernel E2 (``kernels/csrc/importance_sampling.cu``, hot op E of the
port's kernel table): four launches per call. Their plain versions compose
the functions of :mod:`~permuto_sdf_tpu_torch.ops.volume_rendering`, which
mirror the JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from permuto_sdf_tpu_torch import kernels
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


def _check(dev, floats, bools):
    for t in floats:
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError("importance sampling: float32 inputs on one device")
    for t in bools:
        if t.device != dev or t.dtype != torch.bool:
            raise ValueError("importance sampling: bool masks on the same device")


def importance_round_plain(samples: RaySamples, sdf, nr_imp_samples: int, jitter=None,
                           inv_s_multiplier: float = 1.0):
    """Plain version of kernel E1: one round's CDF of the section alphas,
    inverted at the (jittered) strata -> (z_imp [R, n], mask_imp [R, n])."""
    cdf = _weights_cdf(samples, sdf, inv_s_multiplier)
    imp = vr.importance_sample(samples, cdf, nr_imp_samples, jitter)
    return imp.z, imp.mask


def importance_round_cuda(samples: RaySamples, sdf, nr_imp_samples: int, jitter=None,
                          inv_s_multiplier: float = 1.0):
    """Kernel E1 launch: same returns as :func:`importance_round_plain`.
    Counts launches in ``importance_round_cuda.launches``."""
    R, S = samples.mask.shape
    n = int(nr_imp_samples)
    if S < 2:
        raise ValueError("importance sampling: needs at least 2 samples per ray")
    dev = samples.mask.device
    z, dt, mask = samples.z.contiguous(), samples.dt.contiguous(), samples.mask.contiguous()
    fixed_dt = samples.ray_fixed_dt.contiguous()
    sdf = sdf.reshape(R, S).contiguous()
    if jitter is not None:
        jitter = jitter.reshape(R, n).contiguous()
    _check(dev, (z, dt, fixed_dt, sdf, jitter), (mask,))
    z_imp = torch.empty((R, n), dtype=torch.float32, device=dev)
    mask_imp = torch.empty((R, n), dtype=torch.bool, device=dev)
    lib = kernels.load("importance_sampling")
    err = lib.psdf_importance_round(
        R, S, n, kernels.ptr(z), kernels.ptr(dt), kernels.ptr(mask), kernels.ptr(fixed_dt),
        kernels.ptr(sdf), kernels.ptr(jitter), float(inv_s_multiplier), kernels.ptr(z_imp),
        kernels.ptr(mask_imp), kernels.current_stream(dev))
    kernels.check(lib, err, "importance round (kernel E1)")
    importance_round_cuda.launches += 1
    return z_imp, mask_imp


importance_round_cuda.launches = 0


def importance_round(samples: RaySamples, sdf, nr_imp_samples: int, jitter=None,
                     inv_s_multiplier: float = 1.0) -> RaySamples:
    """One importance round -> the drawn samples (dt 0, no sdf)."""
    fn = kernels.dispatch(samples.mask.device, importance_round_cuda, importance_round_plain)
    z, mask = fn(samples, sdf, nr_imp_samples, jitter, inv_s_multiplier)
    return RaySamples(origins=samples.origins, dirs=samples.dirs, z=z, dt=torch.zeros_like(z),
                      mask=mask, ray_fixed_dt=samples.ray_fixed_dt)


def merge_samples_cuda(samples: RaySamples, samples_imp: RaySamples, t_exit) -> RaySamples:
    """Kernel E2 launch: the result of
    :func:`~permuto_sdf_tpu_torch.ops.volume_rendering.combine_uniform_samples_with_imp`
    (its plain version). Counts launches in ``merge_samples_cuda.launches``."""
    R, S1 = samples.mask.shape
    S2 = samples_imp.mask.shape[1]
    dev = samples.mask.device
    carry = samples.sdf is not None and samples_imp.sdf is not None
    ins = [samples.z, samples.mask, samples.sdf if carry else None,
           samples_imp.z, samples_imp.mask, samples_imp.sdf if carry else None]
    ins = [t.reshape(R, -1).contiguous() if t is not None else None for t in ins]
    t_exit = t_exit.reshape(R).contiguous()
    fixed_dt = samples.ray_fixed_dt.contiguous()
    _check(dev, (ins[0], ins[2], ins[3], ins[5], t_exit, fixed_dt), (ins[1], ins[4]))
    S = S1 + S2
    z = torch.empty((R, S), dtype=torch.float32, device=dev)
    dt = torch.empty((R, S), dtype=torch.float32, device=dev)
    mask = torch.empty((R, S), dtype=torch.bool, device=dev)
    sdf = torch.empty((R, S), dtype=torch.float32, device=dev) if carry else None
    lib = kernels.load("importance_sampling")
    err = lib.psdf_merge_samples(R, S1, S2, *(kernels.ptr(t) for t in ins), kernels.ptr(t_exit),
                                 kernels.ptr(fixed_dt), kernels.ptr(z), kernels.ptr(dt),
                                 kernels.ptr(mask), kernels.ptr(sdf), kernels.current_stream(dev))
    kernels.check(lib, err, "merge samples (kernel E2)")
    merge_samples_cuda.launches += 1
    return RaySamples(origins=samples.origins, dirs=samples.dirs, z=z, dt=dt, mask=mask,
                      ray_fixed_dt=samples.ray_fixed_dt, sdf=sdf)


merge_samples_cuda.launches = 0


def merge_samples(samples: RaySamples, samples_imp: RaySamples, t_exit) -> RaySamples:
    """Merge two sample sets per ray in z order (stable) and recompute dt;
    carries sdf when both sets have it."""
    fn = kernels.dispatch(samples.mask.device, merge_samples_cuda,
                          vr.combine_uniform_samples_with_imp)
    return fn(samples, samples_imp, t_exit)


def importance_sampling_sdf_model(
    sdf_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    samples: RaySamples, t_exit, nr_imp_samples: int = 16, jitter=None,
    carry_sdf: bool = False,
) -> RaySamples:
    """``sdf_fn(pts_flat, flat_mask)`` -> sdf [N] or [N, 1]. ``jitter`` is
    None (the eval render) or the two rounds' offsets ``(u1, u2)``, each
    ``[R, nr_imp_samples]`` in +-1/(2(n+1)) (JAX draws them from the two
    halves of its key, ``importance_sampling.py:63``). Returns the merged
    samples (max_samples + 2 * nr_imp_samples per ray); with ``carry_sdf``
    the second round's samples are evaluated too and the result carries
    every sample's sdf, else it has none."""
    u1, u2 = jitter if jitter is not None else (None, None)
    sdf = sdf_fn(samples.flat_positions(), samples.flat_mask()).reshape(samples.mask.shape)
    samples = samples.with_sdf(sdf)
    imp = importance_round(samples, sdf, nr_imp_samples, u1, 1.0)
    sdf_imp = sdf_fn(imp.flat_positions(), imp.flat_mask()).reshape(imp.mask.shape)
    combined = merge_samples(samples, imp.with_sdf(sdf_imp), t_exit)

    imp2 = importance_round(combined, combined.sdf, nr_imp_samples, u2, 2.0)
    if carry_sdf:
        sdf_imp2 = sdf_fn(imp2.flat_positions(), imp2.flat_mask()).reshape(imp2.mask.shape)
        return merge_samples(combined, imp2.with_sdf(sdf_imp2), t_exit)
    # the renderer re-evaluates the merged set, so the sdf is dropped
    return merge_samples(dataclasses.replace(combined, sdf=None), imp2, t_exit)
