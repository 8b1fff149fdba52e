"""The flagship SDF as the fused kernels read it: kernels J3f and J2f (the
sphere tracers' loops, ``ops/sphere_trace.py``) and If (the grid refresh,
``ops/occupancy_grid.py``) evaluate ``SDFEval(cfg, max_levels)`` inside
their launch (``kernels/csrc/sdf_net.cuh``). This module gives them the
SDF's tensors as a :class:`SdfNet` and says which SDFs they evaluate.
"""

from __future__ import annotations

import ctypes

import torch

from permuto_sdf_tpu_torch.models.fields import SDFConfig, SDFEval, _c2f_t, _sdf_levels
from permuto_sdf_tpu_torch.ops import permuto_encoding as pe

HIDDEN = 32  # the SDF MLP's hidden width (kHid in csrc/sdf_net.cuh)


class SdfNet(ctypes.Structure):
    """The SDF's tensors that the fused kernels read (``SdfNet`` in
    ``csrc/sdf_net.cuh``); their entry points take a pointer to it."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "table", "shift", "scales", "window", "E", "w0", "b0", "w1", "b1", "w2", "b2", "w3",
        "b3")] + [("capacity", ctypes.c_int), ("L", ctypes.c_int), ("K", ctypes.c_int),
                  ("w3_cols", ctypes.c_int), ("concat_scaling", ctypes.c_float)]


def _mlp_widths(cfg: SDFConfig):
    L = cfg.nr_levels
    return [(2 * L + 3, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, HIDDEN),
            (HIDDEN, 1 + cfg.geom_feat_size_out)]


def _refusal(cfg: SDFConfig, params_sdf):
    """Why the fused kernels cannot evaluate this SDF, or None."""
    if cfg.in_channels != 3 or cfg.encoding.nr_feat_per_level != 2:
        return "evaluate the SDF of 3-D points with 2 features a level"
    mlp = params_sdf["mlp_sdf"]
    widths = [tuple(layer["w"].shape) for layer in mlp]
    want = _mlp_widths(cfg)
    if widths != want or any(tuple(layer["b"].shape) != (w[1],) for layer, w in zip(mlp, want)):
        return f"evaluate the SDF MLP {want}, not {widths}"
    return None


def fused_sdf_supported(cfg: SDFConfig, params_sdf) -> bool:
    """Whether kernels J3f, J2f and If evaluate this SDF: d = 3, 2 features
    a level and the MLP [2L + 3, 32, 32, 32, 1 + G] (every flagship
    config). Decided from the config and the parameters' shapes, before any
    launch."""
    return _refusal(cfg, params_sdf) is None


def sdf_net(sdf_eval: SDFEval, ctx, dev):
    """The kernels' view of the SDF ``sdf_eval`` with ``ctx = (params_sdf,
    iter_nr)`` -> (:class:`SdfNet`, the tensors it points at, which the
    caller keeps alive until the launch). Raises NotImplementedError for an
    SDF that :func:`fused_sdf_supported` refuses."""
    cfg = sdf_eval.cfg
    params_sdf, it = ctx
    why = _refusal(cfg, params_sdf)
    if why is not None:
        raise NotImplementedError(f"the fused SDF kernels (J2f, J3f, If) {why}")
    spec, L = cfg.encoding, cfg.nr_levels
    mlp = params_sdf["mlp_sdf"]
    K = _sdf_levels(cfg, sdf_eval.max_levels) or L
    window = pe.coarse2fine_window(_c2f_t(it, cfg.nr_iters_for_c2f), L)
    scales, E, window = pe.encoding_constants(spec, window, dev)
    enc = params_sdf["encoding"]
    tensors = [pe.interleaved_table(enc["lattice_values"]), enc["shift_per_level"].detach(),
               scales, window, E] + [layer[k].detach() for layer in mlp for k in ("w", "b")]
    tensors = [t.contiguous() for t in tensors]
    for t in tensors:
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError("the fused SDF kernels: the SDF's tensors must be float32 on the "
                             "state's device")
    net = SdfNet(*(t.data_ptr() for t in tensors), capacity=spec.capacity, L=L, K=K,
                 w3_cols=_mlp_widths(cfg)[3][1], concat_scaling=float(spec.concat_points_scaling))
    return net, tensors
