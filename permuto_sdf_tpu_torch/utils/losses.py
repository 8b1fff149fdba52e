"""Counterpart of ``permuto_sdf_tpu/utils/losses.py``: only the helper the
eval render needs (the losses come with the training slice)."""

from __future__ import annotations

import torch


def map_range_val(x: torch.Tensor, in_start, in_end, out_start, out_end):
    """Linear remap of a tensor with clamping."""
    x = torch.clamp(x, in_start, in_end)
    return out_start + ((out_end - out_start) / (in_end - in_start)) * (x - in_start)
