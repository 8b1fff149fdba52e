"""Order-preserving compaction of a boolean mask into a fixed-size index
list: the counterpart of ``jnp.nonzero(mask, size=size, fill_value=n)``,
which the JAX package calls to pick the sphere tracer's buckets, the lit
rays it shades and the training step's sample budget.

On the card this is kernel H0 (``kernels/csrc/compaction.cu``); the plain
PyTorch version below is the CPU path and the kernel's reference. Neither
synchronises with the host: the count comes back as a device tensor.
"""

from __future__ import annotations

import torch

from permuto_sdf_tpu_torch import kernels

_TILE = 2048  # mask entries per block of the kernel


def nonzero_static_plain(mask: torch.Tensor, size: int, fill_value=None):
    """Plain version of kernel H0 -> (idx [size] int64, count [] int32)."""
    n = mask.shape[0]
    fill = n if fill_value is None else int(fill_value)
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (pos < size)
    idx = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, torch.where(keep, pos, torch.full_like(pos, size)),
                 torch.arange(n, device=mask.device))
    return idx[:size], mask.sum().to(torch.int32)


def nonzero_static_cuda(mask: torch.Tensor, size: int, fill_value=None):
    """Kernel H0 launch -> (idx [size] int64, count [] int32). Counts
    launches in ``nonzero_static_cuda.launches``."""
    n = mask.shape[0]
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("compaction: mask must be a contiguous 1-D bool tensor")
    if size < 0 or n >= 2 ** 31 or size >= 2 ** 31:
        raise ValueError("compaction: sizes must fit in int32")
    fill = n if fill_value is None else int(fill_value)
    dev = mask.device
    idx = torch.empty((size,), dtype=torch.int64, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    tiles = torch.empty((max(1, -(-n // _TILE)),), dtype=torch.int32, device=dev)
    lib = kernels.load("compaction")
    err = lib.psdf_compact(n, kernels.ptr(mask), int(size), fill, kernels.ptr(tiles),
                           kernels.ptr(idx), kernels.ptr(count), kernels.current_stream(dev))
    kernels.check(lib, err, "compaction (kernel H0)")
    nonzero_static_cuda.launches += 1
    return idx, count.reshape(())


nonzero_static_cuda.launches = 0


def nonzero_static(mask: torch.Tensor, size: int, fill_value=None):
    """The first ``size`` true positions of the 1-D ``mask`` in ascending
    order, ``fill_value`` (default ``len(mask)``) in the unused slots ->
    (idx [size] int64, number of true entries [] int32)."""
    fn = kernels.dispatch(mask.device, nonzero_static_cuda, nonzero_static_plain)
    return fn(mask.contiguous(), size, fill_value)
