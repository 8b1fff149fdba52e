"""SDF-guided two-round importance sampling (counterpart of
``permuto_sdf_tpu/ops/importance_sampling.py``, on the ``masked=True``
branch that the trainer and the renderers take; the jitter of the two
rounds is passed in).

Round 1 evaluates the SDF at the uniform samples, turns it into NeuS
section alphas, builds a normalized CDF and draws ``nr_imp_samples``; the
merged set gets another ``nr_imp_samples`` from a second round with
``inv_s_multiplier = 2``. On the card round 1 is kernel E1 and the merges
and round 2 are kernel E2 (``kernels/csrc/importance_sampling.cu``, hot
op E of the port's kernel table), which draws round 2 from the merged ray
it holds: two launches per call, three when the second round's samples
are evaluated (``carry_sdf``). Their plain versions compose the functions
of :mod:`~permuto_sdf_tpu_torch.ops.volume_rendering`, which mirror the
JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.ops import volume_rendering as vr
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples

# round 2's inv_s multiplier (round 1's is 1), as in the JAX stage
ROUND2_INV_S_MULTIPLIER = 2.0


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


def _draws(samples: RaySamples, z, mask) -> RaySamples:
    """A round's drawn samples (dt 0, no sdf)."""
    return RaySamples(origins=samples.origins, dirs=samples.dirs, z=z, dt=torch.zeros_like(z),
                      mask=mask, ray_fixed_dt=samples.ray_fixed_dt)


def importance_round(samples: RaySamples, sdf, nr_imp_samples: int, jitter=None,
                     inv_s_multiplier: float = 1.0) -> RaySamples:
    """One importance round -> the drawn samples (dt 0, no sdf)."""
    fn = kernels.dispatch(samples.mask.device, importance_round_cuda, importance_round_plain)
    return _draws(samples, *fn(samples, sdf, nr_imp_samples, jitter, inv_s_multiplier))


def merge_samples_plain(samples: RaySamples, samples_imp: RaySamples, t_exit, nr_draws: int = 0,
                        jitter=None, merge_draws: bool = False):
    """Plain version of kernel E2, composed of the plain functions. The
    merge (:func:`~permuto_sdf_tpu_torch.ops.volume_rendering.combine_uniform_samples_with_imp`);
    with ``nr_draws`` > 0 also round 2 on the merged set
    (:func:`importance_round_plain` at ``ROUND2_INV_S_MULTIPLIER``),
    returning (merged, draws), or with ``merge_draws`` the merge of the
    draws into the merged set, without sdf."""
    merged = vr.combine_uniform_samples_with_imp(samples, samples_imp, t_exit)
    if nr_draws == 0:
        return merged
    draws = _draws(merged, *importance_round_plain(merged, merged.sdf, nr_draws, jitter,
                                                    ROUND2_INV_S_MULTIPLIER))
    if not merge_draws:
        return merged, draws
    return vr.combine_uniform_samples_with_imp(dataclasses.replace(merged, sdf=None), draws,
                                               t_exit)


def merge_samples_cuda(samples: RaySamples, samples_imp: RaySamples, t_exit, nr_draws: int = 0,
                       jitter=None, merge_draws: bool = False):
    """Kernel E2 launch in one of its three forms: same returns as
    :func:`merge_samples_plain`. Counts launches in
    ``merge_samples_cuda.launches``."""
    R, S1 = samples.mask.shape
    S2 = samples_imp.mask.shape[1]
    n = int(nr_draws)
    dev = samples.mask.device
    carry = samples.sdf is not None and samples_imp.sdf is not None
    if n > 0 and not carry:
        raise ValueError("merge samples: drawing a round needs the sdf of both sets")
    ins = [samples.z, samples.mask, samples.sdf if carry else None,
           samples_imp.z, samples_imp.mask, samples_imp.sdf if carry else None]
    for t, width in zip(ins, (S1, S1, S1, S2, S2, S2)):
        if t is not None and tuple(t.shape) != (R, width):
            raise ValueError(f"merge samples: a per-sample input of shape {tuple(t.shape)}, "
                             f"expected {(R, width)}")
    ins = [t.contiguous() if t is not None else None for t in ins]
    t_exit, fixed_dt = t_exit.contiguous(), samples.ray_fixed_dt.contiguous()
    if t_exit.numel() != R or fixed_dt.numel() != R:
        raise ValueError("merge samples: t_exit and ray_fixed_dt need one value per ray")
    if n > 0 and jitter is not None:
        jitter = jitter.contiguous()
        if tuple(jitter.shape) != (R, n):
            raise ValueError(f"merge samples: jitter of shape {tuple(jitter.shape)}, "
                             f"expected {(R, n)}")
    else:
        jitter = None
    _check(dev, (ins[0], ins[2], ins[3], ins[5], t_exit, fixed_dt, jitter), (ins[1], ins[4]))
    merge_draws = bool(merge_draws) and n > 0
    T = S1 + S2 + n if merge_draws else S1 + S2
    form_b = n > 0 and not merge_draws
    z = torch.empty((R, T), dtype=torch.float32, device=dev)
    dt = torch.empty((R, T), dtype=torch.float32, device=dev)
    mask = torch.empty((R, T), dtype=torch.bool, device=dev)
    sdf = (torch.empty((R, T), dtype=torch.float32, device=dev) if carry and not merge_draws
           else None)
    z_imp = torch.empty((R, n), dtype=torch.float32, device=dev) if form_b else None
    mask_imp = torch.empty((R, n), dtype=torch.bool, device=dev) if form_b else None
    lib = kernels.load("importance_sampling")
    err = lib.psdf_merge_samples(
        R, S1, S2, n, *(kernels.ptr(t) for t in ins), kernels.ptr(t_exit), kernels.ptr(fixed_dt),
        kernels.ptr(jitter), ROUND2_INV_S_MULTIPLIER, int(merge_draws), kernels.ptr(z),
        kernels.ptr(dt), kernels.ptr(mask), kernels.ptr(sdf), kernels.ptr(z_imp),
        kernels.ptr(mask_imp), kernels.current_stream(dev))
    kernels.check(lib, err, "merge samples (kernel E2)")
    merge_samples_cuda.launches += 1
    merged = RaySamples(origins=samples.origins, dirs=samples.dirs, z=z, dt=dt, mask=mask,
                        ray_fixed_dt=samples.ray_fixed_dt, sdf=sdf)
    if form_b:
        return merged, _draws(merged, z_imp, mask_imp)
    return merged


merge_samples_cuda.launches = 0


def merge_samples(samples: RaySamples, samples_imp: RaySamples, t_exit, nr_draws: int = 0,
                  jitter=None, merge_draws: bool = False):
    """Merge two sample sets per ray in z order (stable) and recompute dt;
    carries sdf when both sets have it (form a). With ``nr_draws`` > 0 (both
    sets carrying sdf) the merged set also gets round 2 of the importance
    stage, ``nr_draws`` samples with ``jitter``: returns (merged, draws)
    (form b) or, with ``merge_draws``, the merged set with the draws merged
    in, without sdf (form c). One launch of kernel E2 on the card in each
    form."""
    fn = kernels.dispatch(samples.mask.device, merge_samples_cuda, merge_samples_plain)
    return fn(samples, samples_imp, t_exit, nr_draws, jitter, merge_draws)


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
    every sample's sdf, else it has none.

    On the card: round 1 is kernel E1; the first merge and round 2 are one
    launch of kernel E2, which also merges round 2's draws in without
    ``carry_sdf`` (2 launches), or returns them for their sdf, which a
    second E2 merges (3 launches)."""
    u1, u2 = jitter if jitter is not None else (None, None)

    def with_sdf(smp):  # contiguous once here, not in every kernel's wrapper
        return smp.with_sdf(sdf_fn(smp.flat_positions(), smp.flat_mask()).reshape(
            smp.mask.shape).contiguous())

    samples = with_sdf(samples)
    imp = with_sdf(importance_round(samples, samples.sdf, nr_imp_samples, u1, 1.0))
    if not carry_sdf:
        # the renderer re-evaluates the merged set, so the sdf is dropped
        return merge_samples(samples, imp, t_exit, nr_imp_samples, u2, merge_draws=True)
    combined, imp2 = merge_samples(samples, imp, t_exit, nr_imp_samples, u2)
    return merge_samples(combined, with_sdf(imp2), t_exit)
