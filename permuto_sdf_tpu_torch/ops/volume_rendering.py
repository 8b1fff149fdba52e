"""Volume-rendering math on dense masked ray batches (counterpart of
``permuto_sdf_tpu/ops/volume_rendering.py``; the eval-render subset).

The NeuS and NeRF weights together with the weighted integration of rgb
and gradients per ray are kernel D on the card
(``kernels/csrc/volume_rendering.cu``): :func:`neus_render` and
:func:`nerf_render`. Their plain versions compose the functions below,
which mirror the JAX ones one to one. Every function assumes the
prefix-mask invariant of :class:`RaySamples`.
"""

from __future__ import annotations

import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.ops.ray_samples import RaySamples
from permuto_sdf_tpu_torch.utils.losses import map_range_val


def _last_idx(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sum(mask, dim=-1) - 1, min=0)


def cumprod_alpha2transmittance(one_minus_alpha, mask):
    """Exclusive masked cumprod -> (T [R, S], bg_transmittance [R]); the
    last valid sample's own factor is not multiplied into bg_T."""
    x = torch.where(mask, one_minus_alpha, torch.ones_like(one_minus_alpha))
    cp = torch.cumprod(x, dim=-1)
    T_shifted = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=-1)
    T = torch.where(mask, T_shifted, torch.zeros_like(T_shifted))
    nr = torch.sum(mask, dim=-1)
    bg_T = torch.gather(T_shifted, 1, _last_idx(mask)[:, None])[:, 0]
    bg_T = torch.where(nr > 0, bg_T, torch.ones_like(bg_T))
    return T, bg_T


def integrate_with_weights(values, weights, mask):
    """sum_i w_i * v_i per ray: values [R, S, C], weights [R, S] -> [R, C]."""
    w = torch.where(mask, weights, torch.zeros_like(weights))
    return torch.sum(values * w[..., None], dim=1)


def sum_over_each_ray(values, mask):
    """(sum per ray, its per-sample broadcast) for values [R, S]."""
    s = torch.sum(torch.where(mask, values, torch.zeros_like(values)), dim=1)
    return s, s[:, None].expand(values.shape)


def compute_cdf(weights, mask):
    """Exclusive prefix sum of the weights per ray."""
    w = torch.where(mask, weights, torch.zeros_like(weights))
    incl = torch.cumsum(w, dim=-1)
    return torch.where(mask, incl - w, torch.zeros_like(w))


def alpha_from_density(density, dt, mask):
    a = 1.0 - torch.exp(-density * dt)
    return torch.where(mask, a, torch.zeros_like(a))


def sdf2alpha_sectional(samples: RaySamples, sdf, inv_s_multiplier: float = 1.0):
    """NeuS section alpha from consecutive sdf values (importance sampling),
    inv_s mapped from the ray's uniform dt in [1e-4, 1e-2] to [1024, 64].
    The last valid sample of each ray gets alpha 0."""
    mask = samples.mask
    z = samples.z
    s = map_range_val(samples.ray_fixed_dt, 0.0001, 0.01, 1024.0, 64.0)
    s = (s * inv_s_multiplier)[:, None]
    sdf = sdf.reshape(z.shape)
    next_sdf = torch.cat([sdf[:, 1:], sdf[:, -1:]], dim=-1)
    dt = samples.dt
    mid_sdf = (sdf + next_sdf) * 0.5
    cos_val = (next_sdf - sdf) / torch.clamp(dt, min=1e-6)
    cos_val = torch.clamp(cos_val, -1e3, 0.0)
    prev_esti = mid_sdf - cos_val * dt * 0.5
    next_esti = mid_sdf + cos_val * dt * 0.5
    prev_cdf = torch.sigmoid(prev_esti * s)
    next_cdf = torch.sigmoid(next_esti * s)
    alpha = (prev_cdf - next_cdf + 1e-6) / (prev_cdf + 1e-6)
    nr = torch.sum(mask, dim=-1)
    not_last = torch.arange(z.shape[1], device=z.device)[None, :] < (nr - 1)[:, None]
    return torch.where(mask & not_last, alpha, torch.zeros_like(alpha))


def neus_compute_weights_from_cos(samples: RaySamples, sdf, true_cos, inv_s,
                                  cos_anneal_ratio):
    """-> (weights [R, S], weights_sum [R, 1], bg_transmittance [R])."""
    mask = samples.mask
    R, S = mask.shape
    sdf = sdf.reshape(R, S)
    dists = samples.dt
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
    T, bg_T = cumprod_alpha2transmittance(1.0 - alpha + 1e-7, mask)
    weights = alpha * T
    weights_sum = torch.sum(torch.where(mask, weights, torch.zeros_like(weights)),
                            dim=-1, keepdim=True)
    return weights, weights_sum, bg_T


def neus_compute_weights(samples: RaySamples, sdf, sdf_gradients, inv_s,
                         cos_anneal_ratio):
    """NeuS weights with the analytic cos = dir . grad(sdf)."""
    R, S = samples.mask.shape
    grads = sdf_gradients.reshape(R, S, 3)
    d = samples.dirs[:, None, :]
    true_cos = (d[..., 0] * grads[..., 0] + d[..., 1] * grads[..., 1]) + d[..., 2] * grads[..., 2]
    return neus_compute_weights_from_cos(samples, sdf, true_cos, inv_s,
                                         cos_anneal_ratio)


def nerf_compute_weights(samples: RaySamples, density):
    """NeRF weights: alpha = 1 - exp(-sigma dt)."""
    mask = samples.mask
    density = density.reshape(mask.shape)
    alpha = alpha_from_density(density, samples.dt, mask)
    T, bg_T = cumprod_alpha2transmittance(1.0 - alpha + 1e-7, mask)
    weights = alpha * T
    weights_sum = torch.sum(torch.where(mask, weights, torch.zeros_like(weights)),
                            dim=-1, keepdim=True)
    return weights, weights_sum, bg_T


# ---------------------------------------------------------------------------
# Kernel D: weights + integration (NeuS mode for the foreground, NeRF mode
# for the background)
# ---------------------------------------------------------------------------

def neus_render_plain(samples, sdf, sdf_gradients, rgb, inv_s, cos_anneal_ratio):
    """Plain version of kernel D, NeuS mode. -> (weights [R,S], weights_sum
    [R,1], bg_T [R], rgb_int [R,3], grad_int [R,3])."""
    R, S = samples.mask.shape
    w, wsum, bg_T = neus_compute_weights(samples, sdf, sdf_gradients, inv_s,
                                         cos_anneal_ratio)
    rgb_int = integrate_with_weights(rgb.reshape(R, S, 3), w, samples.mask)
    grad_int = integrate_with_weights(sdf_gradients.reshape(R, S, 3), w, samples.mask)
    return w, wsum, bg_T, rgb_int, grad_int


def nerf_render_plain(samples, density, rgb):
    """Plain version of kernel D, NeRF mode. -> (weights, weights_sum,
    bg_T, rgb_int)."""
    R, S = samples.mask.shape
    w, wsum, bg_T = nerf_compute_weights(samples, density)
    rgb_int = integrate_with_weights(rgb.reshape(R, S, 3), w, samples.mask)
    return w, wsum, bg_T, rgb_int


def render_weights_cuda(mode: int, samples: RaySamples, val, grads, rgb,
                        inv_s: float, cos_anneal_ratio: float):
    """Kernel D launch (mode 0 NeuS, 1 NeRF). Counts launches in
    ``render_weights_cuda.launches``."""
    R, S = samples.mask.shape
    dev = samples.mask.device
    val = val.reshape(R, S).contiguous()
    rgb = rgb.reshape(R, S, 3).contiguous()
    dt = samples.dt.contiguous()
    mask = samples.mask.contiguous()
    dirs = samples.dirs.contiguous()
    if grads is not None:
        grads = grads.reshape(R, S, 3).contiguous()
    for t in (val, rgb, dt, dirs) + ((grads,) if grads is not None else ()):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("render weights: float32 inputs on the mask's device")
    if mask.dtype != torch.bool:
        raise ValueError("render weights: mask must be bool")
    weights = torch.empty((R, S), dtype=torch.float32, device=dev)
    wsum = torch.empty((R, 1), dtype=torch.float32, device=dev)
    bg_T = torch.empty((R,), dtype=torch.float32, device=dev)
    rgb_int = torch.empty((R, 3), dtype=torch.float32, device=dev)
    grad_int = (torch.empty((R, 3), dtype=torch.float32, device=dev)
                if mode == 0 else None)
    lib = kernels.load("volume_rendering")
    err = lib.psdf_render_weights(
        mode, R, S, kernels.ptr(val), kernels.ptr(grads), kernels.ptr(dirs), kernels.ptr(dt),
        kernels.ptr(mask), kernels.ptr(rgb), float(inv_s), float(cos_anneal_ratio),
        kernels.ptr(weights), kernels.ptr(wsum), kernels.ptr(bg_T), kernels.ptr(rgb_int),
        kernels.ptr(grad_int), kernels.current_stream(dev))
    kernels.check(lib, err, "render weights (kernel D)")
    render_weights_cuda.launches += 1
    return weights, wsum, bg_T, rgb_int, grad_int


render_weights_cuda.launches = 0


def _on_cuda(samples: RaySamples) -> bool:
    dev = samples.mask.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"render weights: unsupported device {dev}")
    return dev.type == "cuda"


def neus_render(samples: RaySamples, sdf, sdf_gradients, rgb, inv_s: float,
                cos_anneal_ratio: float):
    """NeuS weights + integrated rgb and gradient per ray -> (weights,
    weights_sum, bg_T, rgb_int, grad_int). ``inv_s`` is a python float."""
    if _on_cuda(samples):
        return render_weights_cuda(0, samples, sdf, sdf_gradients, rgb, inv_s,
                                   cos_anneal_ratio)
    return neus_render_plain(samples, sdf, sdf_gradients, rgb, inv_s,
                             cos_anneal_ratio)


def nerf_render(samples: RaySamples, density, rgb):
    """NeRF weights + integrated rgb per ray -> (weights, weights_sum, bg_T,
    rgb_int)."""
    if _on_cuda(samples):
        return render_weights_cuda(1, samples, density, None, rgb, 0.0, 0.0)[:4]
    return nerf_render_plain(samples, density, rgb)


# ---------------------------------------------------------------------------
# SingleVarianceNetwork
# ---------------------------------------------------------------------------

def init_variance(init_val: float = 0.3, device=None):
    return {"variance": torch.full((1,), init_val, dtype=torch.float32, device=device)}


def variance_inv_s(params, forced_variance=None) -> float:
    """inv_s = clip(exp(10 v), 1e-6, 1e6) in float32, as a python float."""
    if forced_variance is None:
        v = params["variance"].detach().float().cpu()[0]
    else:
        v = torch.tensor(forced_variance, dtype=torch.float32)
    return float(torch.clamp(torch.exp(v * 10.0), 1e-6, 1e6))


# ---------------------------------------------------------------------------
# Importance sampling + merge (plain PyTorch in this slice)
# ---------------------------------------------------------------------------

def importance_sample(samples: RaySamples, cdf, nr_importance_samples: int) -> RaySamples:
    """Invert the per-ray CDF at the stratified positions (i+1)/(n+1) (no
    jitter: the eval render), snapped to within ray_fixed_dt of the nearest
    bracketing sample."""
    R, S = samples.mask.shape
    n = nr_importance_samples
    dev = cdf.device
    strata = (torch.arange(n, dtype=torch.float32, device=dev) + 1.0) / float(n + 1)
    u = strata[None, :].expand(R, n)
    u = torch.clamp(u, 1e-6, 1.0 - 1e-5).contiguous()
    nr = samples.nr_samples_per_ray()
    cdf_valid = torch.where(samples.mask, cdf, torch.full_like(cdf, float("inf")))
    imax = torch.searchsorted(cdf_valid.contiguous(), u, right=True)
    imax = torch.minimum(torch.clamp(imax, min=1),
                         torch.clamp(nr - 1, min=1)[:, None])
    imin = imax - 1
    cdf_min = torch.gather(cdf, 1, imin)
    cdf_max = torch.gather(cdf, 1, imax)
    z_min = torch.gather(samples.z, 1, imin)
    z_max = torch.gather(samples.z, 1, imax)
    diff = cdf_max - cdf_min
    denom = torch.where(torch.abs(diff) < 1e-12, torch.full_like(diff, 1e-12), diff)
    z_imp = z_min + (u - cdf_min) / denom * (z_max - z_min)
    fixed_dt = samples.ray_fixed_dt[:, None]
    dist_to_zmin = z_imp - z_min
    dist_to_zmax = z_max - z_imp
    snap_lo = z_min + torch.minimum(dist_to_zmin, fixed_dt)
    snap_hi = z_max - torch.minimum(dist_to_zmax, fixed_dt)
    z_imp = torch.where(dist_to_zmin < dist_to_zmax, snap_lo, snap_hi)
    valid = (nr > 0)[:, None].expand(R, n)
    z_imp = torch.where(valid, z_imp, torch.zeros_like(z_imp))
    return RaySamples(origins=samples.origins, dirs=samples.dirs, z=z_imp,
                      dt=torch.zeros_like(z_imp), mask=valid,
                      ray_fixed_dt=samples.ray_fixed_dt)


def combine_uniform_samples_with_imp(samples: RaySamples, samples_imp: RaySamples,
                                     t_exit) -> RaySamples:
    """Merge two sample sets per ray, sorted by z (stable, like jnp.argsort).
    dt = min(z_next - z, fixed_dt); the last sample's dt is
    clamp(t_exit - z_last, 0, fixed_dt). Carries sdf when both inputs do."""
    R = samples.nr_rays
    S = samples.max_samples + samples_imp.max_samples
    z = torch.cat([samples.z, samples_imp.z], dim=-1)
    mask = torch.cat([samples.mask, samples_imp.mask], dim=-1)
    z_sortable = torch.where(mask, z, torch.full_like(z, float("inf")))
    order = torch.argsort(z_sortable, dim=-1, stable=True)
    z = torch.gather(torch.where(mask, z, torch.zeros_like(z)), 1, order)
    mask = torch.gather(mask, 1, order)
    sdf = None
    if samples.sdf is not None and samples_imp.sdf is not None:
        sdf = torch.gather(torch.cat([samples.sdf, samples_imp.sdf], dim=-1), 1, order)
    fixed_dt = samples.ray_fixed_dt[:, None]
    z_next = torch.cat([z[:, 1:], z[:, -1:]], dim=-1)
    dt = torch.minimum(z_next - z, fixed_dt)
    last_idx = _last_idx(mask)
    is_last = (torch.arange(S, device=z.device)[None, :] == last_idx[:, None]) & mask
    rem = torch.minimum(torch.clamp(t_exit.reshape(-1, 1) - z, min=0.0), fixed_dt)
    dt = torch.where(is_last, rem, dt)
    dt = torch.where(mask, dt, torch.zeros_like(dt))
    return RaySamples(origins=samples.origins, dirs=samples.dirs, z=z, dt=dt,
                      mask=mask, ray_fixed_dt=samples.ray_fixed_dt, sdf=sdf)

