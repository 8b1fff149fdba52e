"""Device resolution for the port's entry points.

Entry points take ``device=None``, which means the card (``"cuda"``). They
never fall back to the CPU quietly: without a GPU, ``device=None`` raises.
Tests pass ``device="cpu"`` explicitly, which runs every kernel's plain
PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "permuto_sdf_tpu_torch: device=None means the GPU, but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch path explicitly")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("permuto_sdf_tpu_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    return device
