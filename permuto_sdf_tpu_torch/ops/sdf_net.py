"""The fields as the fused kernels read them: kernels J3f and J2f (the
sphere tracers' loops, ``ops/sphere_trace.py``) and If (the grid refresh,
``ops/occupancy_grid.py``) evaluate ``SDFEval(cfg, max_levels)`` inside
their launch (``kernels/csrc/sdf_net.cuh``), kernel I2f (NeRF's grid
refresh, the same file) NeRF's density field
(``kernels/csrc/density_net.cuh``). This module gives them a field's
tensors as an :class:`SdfNet` or a :class:`DensityNet` and says which
fields they evaluate.
"""

from __future__ import annotations

import ctypes

import torch

from permuto_sdf_tpu_torch.models.fields import (
    NerfHashConfig, SDFConfig, SDFEval, _c2f_t, _sdf_levels,
)
from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

HIDDEN = 32  # the SDF MLP's hidden width (kHid in csrc/sdf_net.cuh)
DENSITY_HIDDEN = 64  # the density MLP's hidden width (kDensityHid there)


class SdfNet(ctypes.Structure):
    """The SDF's tensors that the fused kernels read (``SdfNet`` in
    ``csrc/sdf_net.cuh``); their entry points take a pointer to it."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "table", "shift", "scales", "window", "E", "w0", "b0", "w1", "b1", "w2", "b2", "w3",
        "b3")] + [("capacity", ctypes.c_int), ("L", ctypes.c_int), ("K", ctypes.c_int),
                  ("w3_cols", ctypes.c_int), ("concat_scaling", ctypes.c_float)]


class DensityNet(SdfNet):
    """NeRF's density field as kernel I2f reads it (``DensityNet`` in
    ``csrc/sdf_net.cuh``): the layout of :class:`SdfNet`, the MLP's hidden
    width 64 and every level encoded (K = L)."""


def _mlp_widths(cfg: SDFConfig):
    L = cfg.nr_levels
    return [(2 * L + 3, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, HIDDEN),
            (HIDDEN, 1 + cfg.geom_feat_size_out)]


def _density_widths(cfg: NerfHashConfig):
    L = cfg.nr_levels
    return [(2 * L + 3, DENSITY_HIDDEN), (DENSITY_HIDDEN, DENSITY_HIDDEN),
            (DENSITY_HIDDEN, DENSITY_HIDDEN), (DENSITY_HIDDEN, 1 + cfg.nr_feat_for_rgb)]


def _refusal(spec, mlp, want, what):
    """Why the fused kernels cannot evaluate a field of encoding ``spec``
    and MLP ``mlp`` (they take the widths ``want``), or None."""
    if spec.pos_dim != 3 or spec.nr_feat_per_level != 2:
        return f"evaluate the {what} of 3-D points with 2 features a level"
    widths = [tuple(layer["w"].shape) for layer in mlp]
    if widths != want or any(tuple(layer["b"].shape) != (w[1],) for layer, w in zip(mlp, want)):
        return f"evaluate the {what} MLP {want}, not {widths}"
    return None


def _sdf_refusal(cfg: SDFConfig, params_sdf):
    return _refusal(cfg.encoding, params_sdf["mlp_sdf"], _mlp_widths(cfg), "SDF")


def _density_refusal(cfg: NerfHashConfig, params):
    return _refusal(cfg.encoding, params["mlp_feat_and_density"], _density_widths(cfg),
                    "density")


def fused_sdf_supported(cfg: SDFConfig, params_sdf) -> bool:
    """Whether kernels J3f, J2f and If evaluate this SDF: d = 3, 2 features
    a level and the MLP [2L + 3, 32, 32, 32, 1 + G] (every flagship
    config). Decided from the config and the parameters' shapes, before any
    launch."""
    return _sdf_refusal(cfg, params_sdf) is None


def fused_density_supported(cfg: NerfHashConfig, params) -> bool:
    """Whether kernel I2f evaluates this density field (a NerfHash model's
    ``params``): d = 3, 2 features a level and the MLP [2L + 3, 64, 64, 64,
    1 + nr_feat_for_rgb] (every foreground ``NerfHashConfig``). Decided
    from the config and the parameters' shapes, before any launch."""
    return _density_refusal(cfg, params) is None


def _field_net(cls, spec, K, window, enc, mlp, w3_cols, dev, what):
    """(``cls`` pointing at the field's tensors, the tensors)."""
    scales, E, window = pe.encoding_constants(spec, window, dev)
    tensors = [pe.interleaved_table(enc["lattice_values"]), enc["shift_per_level"].detach(),
               scales, window, E] + [layer[k].detach() for layer in mlp for k in ("w", "b")]
    tensors = [t.contiguous() for t in tensors]
    for t in tensors:
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"the fused {what} kernels: the field's tensors must be float32 "
                             f"on the state's device")
    net = cls(*(t.data_ptr() for t in tensors), capacity=spec.capacity, L=spec.nr_levels, K=K,
              w3_cols=w3_cols, concat_scaling=float(spec.concat_points_scaling))
    return net, tensors


def sdf_net(sdf_eval: SDFEval, ctx, dev):
    """The kernels' view of the SDF ``sdf_eval`` with ``ctx = (params_sdf,
    iter_nr)`` -> (:class:`SdfNet`, the tensors it points at, which the
    caller keeps alive until the launch). Raises NotImplementedError for an
    SDF that :func:`fused_sdf_supported` refuses."""
    cfg = sdf_eval.cfg
    params_sdf, it = ctx
    why = _sdf_refusal(cfg, params_sdf)
    if why is not None:
        raise NotImplementedError(f"the fused SDF kernels (J2f, J3f, If) {why}")
    L = cfg.nr_levels
    K = _sdf_levels(cfg, sdf_eval.max_levels) or L
    window = pe.coarse2fine_window(_c2f_t(it, cfg.nr_iters_for_c2f), L)
    return _field_net(SdfNet, cfg.encoding, K, window, params_sdf["encoding"],
                      params_sdf["mlp_sdf"], _mlp_widths(cfg)[3][1], dev, "SDF")


def density_net(cfg: NerfHashConfig, params, iter_nr, dev):
    """Kernel I2f's view of the density field of a NerfHash model
    ``params`` at ``iter_nr`` (its c2f window, every level) ->
    (:class:`DensityNet`, the tensors it points at, which the caller keeps
    alive until the launch). Raises NotImplementedError for a field that
    :func:`fused_density_supported` refuses."""
    why = _density_refusal(cfg, params)
    if why is not None:
        raise NotImplementedError(f"the fused density kernel (I2f) {why}")
    L = cfg.nr_levels
    window = pe.coarse2fine_window(_c2f_t(iter_nr, cfg.nr_iters_for_c2f), L)
    return _field_net(DensityNet, cfg.encoding, L, window, params["encoding"],
                      params["mlp_feat_and_density"], _density_widths(cfg)[3][1], dev, "density")
