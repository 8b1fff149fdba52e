"""Volume-rendering math on dense masked ray batches (counterpart of
``permuto_sdf_tpu/ops/volume_rendering.py``).

The NeuS and NeRF weights together with the weighted integration of rgb
and gradients per ray are kernel D on the card
(``kernels/csrc/volume_rendering.cu``): :func:`neus_render` and
:func:`nerf_render`, autograd functions whose backward is kernel D'.
Their plain versions compose the functions below, which mirror the JAX
ones one to one; the plain backward is PyTorch's autograd of the plain
forward. The training step's train-time LOD adds kernel L
(:func:`train_lod_select`: finite-difference cos, ranking weights, the
top-K and random extra slots of each ray) and kernel D2 (:func:`neus_render_mixed`:
the weights of the mixed carried/full-resolution chain and the selected
slots' integration), whose backward is kernel D2'. Every function assumes
the prefix-mask invariant of :class:`RaySamples`.
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


def sdf2alpha_sectional(samples: RaySamples, sdf, *, inv_s_multiplier: float = 1.0):
    """NeuS section alpha from consecutive sdf values (importance sampling),
    inv_s mapped from the ray's uniform dt in [1e-4, 1e-2] to [1024, 64]
    (JAX's ``dynamic_inv_s=True``; its third positional parameter is
    ``inv_s``, so the multiplier is keyword-only here).
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


def finite_difference_cos(samples: RaySamples, sdf):
    sdf = sdf.reshape(samples.mask.shape)
    sdf_next = torch.cat([sdf[:, 1:], sdf[:, -1:]], dim=-1)
    return (sdf_next - sdf) / torch.clamp(samples.dt, min=1e-6)


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


def _check_render_inputs(dev, tensors, mask):
    for t in tensors:
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError("render weights: float32 inputs on the mask's device")
    if mask.dtype != torch.bool:
        raise ValueError("render weights: mask must be bool")


def render_weights_cuda(mode: int, samples: RaySamples, val, grads, rgb,
                        inv_s: float, cos_anneal_ratio: float):
    """Kernel D launch (mode 0 NeuS, 1 NeRF). Counts launches in
    ``render_weights_cuda.launches``."""
    mask = samples.mask.contiguous()
    R, S = mask.shape
    dev = mask.device
    val, rgb, dt, dirs = (val.contiguous(), rgb.contiguous(), samples.dt.contiguous(),
                          samples.dirs.contiguous())
    shapes = [(val, R * S), (rgb, R * S * 3), (dt, R * S), (dirs, R * 3)]
    if mode == 0:
        grads = grads.contiguous()
        shapes.append((grads, R * S * 3))
    else:
        grads = None
    for t, numel in shapes:
        if t.numel() != numel:
            raise ValueError(f"render weights: an input of shape {tuple(t.shape)} for {R} rays "
                             f"of {S} samples")
    _check_render_inputs(dev, (val, rgb, dt, dirs, grads), mask)
    weights = torch.empty((R, S), dtype=torch.float32, device=dev)
    wsum = torch.empty((R, 1), dtype=torch.float32, device=dev)
    bg_T = torch.empty((R,), dtype=torch.float32, device=dev)
    rgb_int = torch.empty((R, 3), dtype=torch.float32, device=dev)
    grad_int = torch.empty((R, 3), dtype=torch.float32, device=dev) if mode == 0 else None
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


def render_weights_bwd_plain(mode: int, samples: RaySamples, val, grads, rgb,
                             inv_s: float, cos_anneal_ratio: float, g_weights, g_wsum,
                             g_bg_T, g_rgb, g_grad=None):
    """Plain version of kernel D': autograd of the plain forward. Takes the
    cotangents of (weights, weights_sum, bg_T, rgb_int[, grad_int]) and
    returns (d val [R,S], d grads [R,S,3] or None, d rgb [R,S,3])."""
    R, S = samples.mask.shape
    with torch.enable_grad():
        v = val.detach().reshape(R, S).requires_grad_(True)
        c = rgb.detach().reshape(R, S, 3).requires_grad_(True)
        if mode == 0:
            gr = grads.detach().reshape(R, S, 3).requires_grad_(True)
            outs = neus_render_plain(samples, v, gr, c, inv_s, cos_anneal_ratio)
            cots = (g_weights, g_wsum, g_bg_T, g_rgb, g_grad)
            inputs = (v, gr, c)
        else:
            outs = nerf_render_plain(samples, v, c)
            cots = (g_weights, g_wsum, g_bg_T, g_rgb)
            inputs = (v, c)
        d = torch.autograd.grad(outs, inputs, [t.reshape(o.shape) for t, o in zip(cots, outs)],
                                allow_unused=True)
    d = [torch.zeros_like(x) if y is None else y for x, y in zip(inputs, d)]
    if mode == 0:
        return d[0], d[1], d[2]
    return d[0], None, d[1]


def render_weights_bwd_cuda(mode: int, samples: RaySamples, val, grads, rgb,
                            inv_s: float, cos_anneal_ratio: float, g_weights, g_wsum,
                            g_bg_T, g_rgb, g_grad=None):
    """Kernel D' launch: same returns as :func:`render_weights_bwd_plain`.
    Counts launches in ``render_weights_bwd_cuda.launches``."""
    R, S = samples.mask.shape
    dev = samples.mask.device
    val = val.reshape(R, S).contiguous()
    rgb = rgb.reshape(R, S, 3).contiguous()
    dt = samples.dt.contiguous()
    mask = samples.mask.contiguous()
    dirs = samples.dirs.contiguous()
    cots = [g_weights.reshape(R, S).contiguous(), g_wsum.reshape(R).contiguous(),
            g_bg_T.reshape(R).contiguous(), g_rgb.reshape(R, 3).contiguous()]
    if mode == 0:
        grads = grads.reshape(R, S, 3).contiguous()
        cots.append(g_grad.reshape(R, 3).contiguous())
    else:
        grads = None
        cots.append(None)
    _check_render_inputs(dev, (val, rgb, dt, dirs, grads, *cots), mask)
    d_val = torch.empty((R, S), dtype=torch.float32, device=dev)
    d_grads = torch.empty((R, S, 3), dtype=torch.float32, device=dev) if mode == 0 else None
    d_rgb = torch.empty((R, S, 3), dtype=torch.float32, device=dev)
    lib = kernels.load("volume_rendering")
    err = lib.psdf_render_weights_bwd(
        mode, R, S, kernels.ptr(val), kernels.ptr(grads), kernels.ptr(dirs), kernels.ptr(dt),
        kernels.ptr(mask), kernels.ptr(rgb), float(inv_s), float(cos_anneal_ratio),
        *(kernels.ptr(t) for t in cots), kernels.ptr(d_val), kernels.ptr(d_grads),
        kernels.ptr(d_rgb), kernels.current_stream(dev))
    kernels.check(lib, err, "render weights backward (kernel D')")
    render_weights_bwd_cuda.launches += 1
    return d_val, d_grads, d_rgb


render_weights_bwd_cuda.launches = 0


def _on_cuda(samples: RaySamples) -> bool:
    dev = samples.mask.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"render weights: unsupported device {dev}")
    return dev.type == "cuda"


def _weights_view(dirs, dt, mask) -> RaySamples:
    """The fields of a sample batch that the weights read."""
    return RaySamples(origins=dirs, dirs=dirs, z=dt, dt=dt, mask=mask,
                      ray_fixed_dt=dt[:, 0])


class _RenderWeightsFn(torch.autograd.Function):
    """Kernel D (mode 0 NeuS: 5 outputs, mode 1 NeRF: 4) with a backward of
    kernel D' (plain versions on the CPU). The samples are constants."""

    @staticmethod
    def forward(ctx, mode, val, grads, rgb, dirs, dt, mask, inv_s, cos_anneal_ratio):
        ctx.save_for_backward(val, grads, rgb, dirs, dt, mask)
        ctx.args = (mode, inv_s, cos_anneal_ratio)
        smp = _weights_view(dirs, dt, mask)
        if _on_cuda(smp):
            out = render_weights_cuda(mode, smp, val, grads, rgb, inv_s, cos_anneal_ratio)
        elif mode == 0:
            out = neus_render_plain(smp, val, grads, rgb, inv_s, cos_anneal_ratio)
        else:
            out = nerf_render_plain(smp, val, rgb)
        return tuple(out[:5 if mode == 0 else 4])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cots):
        val, grads, rgb, dirs, dt, mask = ctx.saved_tensors
        mode, inv_s, cos_anneal_ratio = ctx.args
        smp = _weights_view(dirs, dt, mask)
        fn = render_weights_bwd_cuda if _on_cuda(smp) else render_weights_bwd_plain
        d_val, d_grads, d_rgb = fn(mode, smp, val, grads, rgb, inv_s, cos_anneal_ratio,
                                   *(c.contiguous() for c in cots))
        return (None, d_val.reshape(val.shape),
                d_grads.reshape(grads.shape) if d_grads is not None else None,
                d_rgb.reshape(rgb.shape), None, None, None, None, None)


def neus_render(samples: RaySamples, sdf, sdf_gradients, rgb, inv_s: float,
                cos_anneal_ratio: float):
    """NeuS weights + integrated rgb and gradient per ray -> (weights,
    weights_sum, bg_T, rgb_int, grad_int). ``inv_s`` is a python float.
    Differentiable in sdf, sdf_gradients and rgb (kernel D')."""
    _on_cuda(samples)
    return _RenderWeightsFn.apply(0, sdf, sdf_gradients, rgb, samples.dirs, samples.dt,
                                  samples.mask, float(inv_s), float(cos_anneal_ratio))


def nerf_render(samples: RaySamples, density, rgb):
    """NeRF weights + integrated rgb per ray -> (weights, weights_sum, bg_T,
    rgb_int). Differentiable in density and rgb (kernel D')."""
    _on_cuda(samples)
    return _RenderWeightsFn.apply(1, density, None, rgb, samples.dirs, samples.dt,
                                  samples.mask, 0.0, 0.0)


# ---------------------------------------------------------------------------
# Kernel L: the train-time LOD's selection; kernels D2 and D2': the mixed
# chain's weights and integration, and their backward
# ---------------------------------------------------------------------------

def _top_slots(values, n: int):
    """``lax.top_k``'s slots: the n largest per row, ties by lower index (a
    stable descending sort)."""
    return torch.sort(values, dim=1, descending=True, stable=True).indices[:, :n]


def train_lod_select_plain(samples: RaySamples, sdf, inv_s: float, cos_anneal_ratio: float,
                           scores, K: int, E: int):
    """Plain version of kernel L -> (cos_fd [R, S], sel [R, K+E] int64): the
    K slots of largest NeuS weight of the carried ``sdf`` with a
    finite-difference cos (-1 at invalid slots), then the E slots of largest
    ``scores`` [R, S] among the valid slots outside them."""
    mask = samples.mask
    cos_fd = finite_difference_cos(samples, sdf)
    w_rank = neus_compute_weights_from_cos(samples, sdf, cos_fd, inv_s, cos_anneal_ratio)[0]
    sel = _top_slots(torch.where(mask, w_rank, -1.0), K)
    if E > 0:
        rest = torch.where(mask, scores.scatter(1, sel, -1.0), -1.0)
        sel = torch.cat([sel, _top_slots(rest, E)], dim=1)
    return cos_fd, sel


def train_lod_select_cuda(samples: RaySamples, sdf, inv_s: float, cos_anneal_ratio: float,
                          scores, K: int, E: int):
    """Kernel L launch: same returns as :func:`train_lod_select_plain`.
    Counts launches in ``train_lod_select_cuda.launches``."""
    R, S = samples.mask.shape
    dev = samples.mask.device
    if not (0 < K <= S and 0 <= E <= S - K):
        raise ValueError(f"train LOD select: need 0 < K <= S and K + E <= S, got {K}, {E}, {S}")
    sdf = sdf.reshape(R, S).contiguous()
    dt = samples.dt.contiguous()
    mask = samples.mask.contiguous()
    if E > 0:
        scores = scores.reshape(R, S).contiguous()
    else:
        scores = None
    _check_render_inputs(dev, (sdf, dt, scores), mask)
    cos_fd = torch.empty((R, S), dtype=torch.float32, device=dev)
    sel = torch.empty((R, K + E), dtype=torch.int64, device=dev)
    lib = kernels.load("volume_rendering")
    err = lib.psdf_train_lod_select(
        R, S, K, E, kernels.ptr(sdf), kernels.ptr(dt), kernels.ptr(mask), kernels.ptr(scores),
        float(inv_s), float(cos_anneal_ratio), kernels.ptr(cos_fd), kernels.ptr(sel),
        kernels.current_stream(dev))
    kernels.check(lib, err, "train LOD select (kernel L)")
    train_lod_select_cuda.launches += 1
    return cos_fd, sel


train_lod_select_cuda.launches = 0


def train_lod_select(samples: RaySamples, sdf, inv_s: float, cos_anneal_ratio: float,
                     scores, K: int, E: int):
    """The train-time LOD's fine set of each ray (kernel L on the card) ->
    (cos_fd [R, S], sel [R, K+E] int64 slot ids, unique per ray). ``scores``
    [R, S] in [0, 1) pick the E extras (None when E is 0)."""
    if E > 0 and scores is None:
        raise ValueError("train LOD select: E > 0 random extras need scores")
    fn = kernels.dispatch(samples.mask.device, train_lod_select_cuda, train_lod_select_plain)
    return fn(samples, sdf, inv_s, cos_anneal_ratio, scores, K, E)


def _fine_ids(samples: RaySamples, sel):
    """Flat slot ids [R*KE] of the fine set, their validity, and which fine
    row represents its slot in the chain: the last of the rows that select
    it (a ray with fewer valid samples than K + E selects slots twice;
    JAX's scatter keeps the last write, and its gradient)."""
    R, S = samples.mask.shape
    KE = sel.shape[1]
    idx = (torch.arange(R, device=sel.device)[:, None] * S + sel).reshape(-1)
    later = torch.triu(torch.ones((KE, KE), dtype=torch.bool, device=sel.device), diagonal=1)
    dup_later = ((sel[:, :, None] == sel[:, None, :]) & later).any(dim=-1).reshape(-1)
    valid = samples.flat_mask()[idx]
    return idx, valid, valid & ~dup_later


def _into_chain(base, idx, rep, values):
    """``base`` [M] with ``values`` [R*KE] at the slots of the representative
    rows ``rep`` (one row per slot, so the write is deterministic)."""
    return base.index_put((idx[rep],), values[rep])


def neus_render_mixed_plain(samples: RaySamples, sdf_carried, cos_fd, sel, sdf_c, grads_c,
                            rgb_c, inv_s: float, cos_anneal_ratio: float):
    """Plain version of kernel D2: the NeuS weights of the mixed chain (the
    fine set's sdf and cos = dir . grad at the selected valid slots, the
    carried sdf and ``cos_fd`` elsewhere) and the selected valid slots'
    integration -> (weights [R,S], weights_sum [R,1], bg_T [R], rgb_int
    [R,3], grad_int [R,3])."""
    R, S = samples.mask.shape
    KE = sel.shape[1]
    idx, vc, rep = _fine_ids(samples, sel)
    grads_c = grads_c.reshape(-1, 3)
    d = samples.dirs[:, None, :].expand(R, KE, 3).reshape(-1, 3)
    cos_sel = (d[:, 0] * grads_c[:, 0] + d[:, 1] * grads_c[:, 1]) + d[:, 2] * grads_c[:, 2]
    sdf_flat = _into_chain(sdf_carried.reshape(-1), idx, rep, sdf_c.reshape(-1))
    cos_flat = _into_chain(cos_fd.reshape(-1), idx, rep, cos_sel)
    w, wsum, bg_T = neus_compute_weights_from_cos(samples, sdf_flat.reshape(R, S),
                                                  cos_flat.reshape(R, S), inv_s,
                                                  cos_anneal_ratio)
    w_sel = torch.where(vc, w.reshape(-1)[idx], 0.0).reshape(R, KE, 1)
    rgb_int = torch.sum(w_sel * rgb_c.reshape(R, KE, 3), dim=1)
    grad_int = torch.sum(w_sel * grads_c.reshape(R, KE, 3), dim=1)
    return w, wsum, bg_T, rgb_int, grad_int


def _mixed_inputs(samples, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c):
    R, S = samples.mask.shape
    KE = sel.shape[1]
    ins = dict(sdf_carried=sdf_carried.reshape(R, S).contiguous(),
               cos_fd=cos_fd.reshape(R, S).contiguous(), sel=sel.contiguous(),
               sdf_c=sdf_c.reshape(R * KE).contiguous(),
               grads_c=grads_c.reshape(R * KE, 3).contiguous(),
               rgb_c=rgb_c.reshape(R * KE, 3).contiguous(), dirs=samples.dirs.contiguous(),
               dt=samples.dt.contiguous(), mask=samples.mask.contiguous())
    dev = samples.mask.device
    _check_render_inputs(dev, [t for k, t in ins.items() if k not in ("sel", "mask")],
                         ins["mask"])
    if sel.dtype != torch.int64 or sel.device != dev:
        raise ValueError("mixed render: sel must be int64 on the mask's device")
    return R, S, KE, ins


def _mixed_ptrs(ins):
    return [kernels.ptr(ins[k]) for k in ("sdf_carried", "cos_fd", "sel", "sdf_c", "grads_c",
                                          "rgb_c", "dirs", "dt", "mask")]


def neus_render_mixed_cuda(samples: RaySamples, sdf_carried, cos_fd, sel, sdf_c, grads_c,
                           rgb_c, inv_s: float, cos_anneal_ratio: float):
    """Kernel D2 launch: same returns as :func:`neus_render_mixed_plain`.
    Counts launches in ``neus_render_mixed_cuda.launches``."""
    R, S, KE, ins = _mixed_inputs(samples, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c)
    dev = samples.mask.device
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((R, S), (R, 1), (R,), (R, 3), (R, 3))]
    lib = kernels.load("volume_rendering")
    err = lib.psdf_render_mixed(R, S, KE, *_mixed_ptrs(ins), float(inv_s),
                                float(cos_anneal_ratio), *(kernels.ptr(t) for t in outs),
                                kernels.current_stream(dev))
    kernels.check(lib, err, "mixed render (kernel D2)")
    neus_render_mixed_cuda.launches += 1
    return tuple(outs)


neus_render_mixed_cuda.launches = 0


def neus_render_mixed_bwd_plain(samples: RaySamples, sdf_carried, cos_fd, sel, sdf_c, grads_c,
                                rgb_c, inv_s: float, cos_anneal_ratio: float, g_weights,
                                g_wsum, g_bg_T, g_rgb, g_grad):
    """Plain version of kernel D2': autograd of the plain forward. Takes the
    cotangents of its five outputs and returns (d sdf_c [R*KE], d grads_c
    [R*KE,3], d rgb_c [R*KE,3])."""
    with torch.enable_grad():
        ins = [t.detach().reshape(-1, *shape).requires_grad_(True)
               for t, shape in ((sdf_c, ()), (grads_c, (3,)), (rgb_c, (3,)))]
        outs = neus_render_mixed_plain(samples, sdf_carried, cos_fd, sel, *ins, inv_s,
                                       cos_anneal_ratio)
        cots = (g_weights, g_wsum, g_bg_T, g_rgb, g_grad)
        d = torch.autograd.grad(outs, ins, [c.reshape(o.shape) for c, o in zip(cots, outs)],
                                allow_unused=True)
    return tuple(torch.zeros_like(x) if y is None else y for x, y in zip(ins, d))


def neus_render_mixed_bwd_cuda(samples: RaySamples, sdf_carried, cos_fd, sel, sdf_c, grads_c,
                               rgb_c, inv_s: float, cos_anneal_ratio: float, g_weights,
                               g_wsum, g_bg_T, g_rgb, g_grad):
    """Kernel D2' launch: same returns as :func:`neus_render_mixed_bwd_plain`.
    Counts launches in ``neus_render_mixed_bwd_cuda.launches``."""
    R, S, KE, ins = _mixed_inputs(samples, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c)
    dev = samples.mask.device
    cots = [g_weights.reshape(R, S).contiguous(), g_wsum.reshape(R).contiguous(),
            g_bg_T.reshape(R).contiguous(), g_rgb.reshape(R, 3).contiguous(),
            g_grad.reshape(R, 3).contiguous()]
    _check_render_inputs(dev, cots, ins["mask"])
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((R * KE,), (R * KE, 3), (R * KE, 3))]
    lib = kernels.load("volume_rendering")
    err = lib.psdf_render_mixed_bwd(R, S, KE, *_mixed_ptrs(ins), float(inv_s),
                                    float(cos_anneal_ratio), *(kernels.ptr(t) for t in cots),
                                    *(kernels.ptr(t) for t in outs), kernels.current_stream(dev))
    kernels.check(lib, err, "mixed render backward (kernel D2')")
    neus_render_mixed_bwd_cuda.launches += 1
    return tuple(outs)


neus_render_mixed_bwd_cuda.launches = 0


class _RenderMixedFn(torch.autograd.Function):
    """Kernel D2 with a backward of kernel D2' (plain versions on the CPU).
    Differentiable in the fine set's sdf, gradients and rgb; the carried
    sdf, ``cos_fd``, the selection and the samples are constants."""

    @staticmethod
    def forward(ctx, sdf_c, grads_c, rgb_c, sdf_carried, cos_fd, sel, dirs, dt, mask, inv_s,
                cos_anneal_ratio):
        ctx.save_for_backward(sdf_c, grads_c, rgb_c, sdf_carried, cos_fd, sel, dirs, dt, mask)
        ctx.args = (inv_s, cos_anneal_ratio)
        smp = _weights_view(dirs, dt, mask)
        fn = neus_render_mixed_cuda if _on_cuda(smp) else neus_render_mixed_plain
        return tuple(fn(smp, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c, inv_s,
                        cos_anneal_ratio))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cots):
        sdf_c, grads_c, rgb_c, sdf_carried, cos_fd, sel, dirs, dt, mask = ctx.saved_tensors
        smp = _weights_view(dirs, dt, mask)
        fn = neus_render_mixed_bwd_cuda if _on_cuda(smp) else neus_render_mixed_bwd_plain
        d_sdf, d_grads, d_rgb = fn(smp, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c,
                                   *ctx.args, *(c.contiguous() for c in cots))
        return (d_sdf.reshape(sdf_c.shape), d_grads.reshape(grads_c.shape),
                d_rgb.reshape(rgb_c.shape)) + (None,) * 8


def neus_render_mixed(samples: RaySamples, sdf_carried, cos_fd, sel, sdf_c, grads_c, rgb_c,
                      inv_s: float, cos_anneal_ratio: float):
    """The train-time LOD's render (kernel D2 on the card): the NeuS weights
    of the mixed chain and the selected slots' integration -> (weights,
    weights_sum, bg_T, rgb_int, grad_int). ``sel [R, KE]`` are the slots of
    the fine set whose ``sdf_c [R*KE(,1)]``, ``grads_c`` and ``rgb_c [R*KE,
    3]`` the fields computed; ``inv_s`` is a python float. Differentiable in
    sdf_c, grads_c and rgb_c (kernel D2')."""
    _on_cuda(samples)
    return _RenderMixedFn.apply(sdf_c, grads_c, rgb_c, sdf_carried.detach(), cos_fd.detach(),
                                sel, samples.dirs, samples.dt, samples.mask, float(inv_s),
                                float(cos_anneal_ratio))


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
# Importance sampling + merge: the plain versions of kernels E1 and E2
# (ops/importance_sampling.py launches them)
# ---------------------------------------------------------------------------

def importance_sample(samples: RaySamples, cdf, nr_importance_samples: int,
                      jitter=None) -> RaySamples:
    """Invert the per-ray CDF at the stratified positions (i+1)/(n+1), moved
    by ``jitter [R, n]`` (offsets in +-1/(2(n+1)), the training draw; None
    for the eval render), snapped to within ray_fixed_dt of the nearest
    bracketing sample."""
    R, S = samples.mask.shape
    n = nr_importance_samples
    dev = cdf.device
    strata = (torch.arange(n, dtype=torch.float32, device=dev) + 1.0) / float(n + 1)
    u = strata[None, :].expand(R, n)
    if jitter is not None:
        u = u + jitter
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

