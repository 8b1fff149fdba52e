"""Order-preserving compaction of a boolean mask into a fixed-size index
list: the counterpart of ``jnp.nonzero(mask, size=size, fill_value=n)``,
which the JAX package calls to pick the sphere tracer's buckets, the lit
rays it shades and the training step's sample budget.

On the card this is kernel H0 (``kernels/csrc/compaction.cu``), which can
combine the mask with a second one in its loads (the tracers' ``alive &
~conv`` and ``conv & alive``); the plain PyTorch version below is the CPU
path and the kernel's reference. Neither synchronises with the host: the
count comes back as a device tensor.

Kernels H1 and H2 (same file) move whole rows of per-ray arrays between a
ray batch and a bucket of its rays listed by such a compaction: the
trainer's hit-ray ``_take_rays`` and ``_scatter_rays``.
"""

from __future__ import annotations

import math
import struct

import torch

from permuto_sdf_tpu_torch import kernels

_TILE = 2048  # mask entries per block of the kernel
# How kernel H0 combines the second mask with the first (``CompactMode`` in
# ``kernels/csrc/compaction.cu``)
_MASK_ONLY, _AND, _AND_NOT = 0, 1, 2


def _combined(mask, other, negate_other: bool):
    if other is None:
        return mask
    return mask & (~other if negate_other else other)


def nonzero_static_plain(mask: torch.Tensor, size: int, fill_value=None, other=None,
                         negate_other: bool = False):
    """Plain version of kernel H0 -> (idx [size] int64, count [] int32)."""
    mask = _combined(mask, other, negate_other)
    n = mask.shape[0]
    fill = n if fill_value is None else int(fill_value)
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (pos < size)
    idx = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, torch.where(keep, pos, torch.full_like(pos, size)),
                 torch.arange(n, device=mask.device))
    return idx[:size], mask.sum().to(torch.int32)


def nonzero_static_cuda(mask: torch.Tensor, size: int, fill_value=None, other=None,
                        negate_other: bool = False):
    """Kernel H0 launch -> (idx [size] int64, count [] int32). Counts
    launches in ``nonzero_static_cuda.launches``."""
    n = mask.shape[0]
    for m in (mask,) if other is None else (mask, other):
        if m.dtype != torch.bool or m.dim() != 1 or not m.is_contiguous():
            raise ValueError("compaction: masks must be contiguous 1-D bool tensors")
    if other is not None and (other.shape != mask.shape or other.device != mask.device):
        raise ValueError("compaction: the second mask must match the first")
    if size < 0 or n >= 2 ** 31 or size >= 2 ** 31:
        raise ValueError("compaction: sizes must fit in int32")
    mode = _MASK_ONLY if other is None else (_AND_NOT if negate_other else _AND)
    fill = n if fill_value is None else int(fill_value)
    dev = mask.device
    idx = torch.empty((size,), dtype=torch.int64, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    tiles = torch.empty((max(1, -(-n // _TILE)),), dtype=torch.int32, device=dev)
    lib = kernels.load("compaction")
    err = lib.psdf_compact(n, kernels.ptr(mask), kernels.ptr(other), mode, int(size), fill,
                           kernels.ptr(tiles), kernels.ptr(idx), kernels.ptr(count),
                           kernels.current_stream(dev))
    kernels.check(lib, err, "compaction (kernel H0)")
    nonzero_static_cuda.launches += 1
    return idx, count.reshape(())


nonzero_static_cuda.launches = 0


def nonzero_static(mask: torch.Tensor, size: int, fill_value=None, other=None,
                   negate_other: bool = False):
    """The first ``size`` true positions of the 1-D ``mask`` in ascending
    order, ``fill_value`` (default ``len(mask)``) in the unused slots ->
    (idx [size] int64, number of true entries [] int32). With ``other``
    (1-D bool, the mask's length) the positions of ``mask & other``, or of
    ``mask & ~other`` with ``negate_other``, formed inside kernel H0."""
    fn = kernels.dispatch(mask.device, nonzero_static_cuda, nonzero_static_plain)
    return fn(mask.contiguous(), size, fill_value,
              None if other is None else other.contiguous(), negate_other)


# ---------------------------------------------------------------------------
# Kernels H1 (take) and H2 (scatter): whole rows of per-ray arrays between a
# ray batch and a bucket of it, the hit-ray compaction's `_take_rays` and
# `_scatter_rays`
# ---------------------------------------------------------------------------

def _chunk_bytes(*addrs) -> int:
    """The widest of 16, 8, 4 and 1 bytes that divides every address and
    size in ``addrs``: kernel H1's and H2's chunk of an array."""
    a = 0
    for x in addrs:
        a |= x
    return next(w for w in (16, 8, 4, 1) if a % w == 0)


def _row_arrays(srcs, dsts, fills=None) -> kernels.RowArrays:
    """The arrays' struct: their pointers, row bytes, H2's fills, and each
    array's chunk width and first chunk in a row."""
    if len(srcs) > kernels.MAX_ROW_ARRAYS:
        raise ValueError(f"rows: at most {kernels.MAX_ROW_ARRAYS} arrays per launch")
    a = kernels.RowArrays()
    chunks = 0
    for k, (s, d) in enumerate(zip(srcs, dsts)):
        if not (s.is_contiguous() and d.is_contiguous()) or s.dtype != d.dtype:
            raise ValueError("rows: contiguous arrays of one dtype each")
        a.src[k], a.dst[k] = s.data_ptr(), d.data_ptr()
        a.row_bytes[k] = row_bytes = math.prod(d.shape[1:]) * d.element_size()
        fill = 0.0 if fills is None else float(fills[k])
        if fill != 0.0 and d.dtype != torch.float32:
            raise ValueError("rows: a nonzero fill needs a float32 array")
        a.fill[k] = struct.unpack("<I", struct.pack("<f", fill))[0]
        a.chunk[k] = width = _chunk_bytes(s.data_ptr(), d.data_ptr(), row_bytes)
        a.first_chunk[k] = chunks
        chunks += row_bytes // width
    a.row_chunks = chunks
    a.count = len(srcs)
    return a


def _check_idx(ray_idx):
    if ray_idx.dtype != torch.int64 or ray_idx.dim() != 1 or not ray_idx.is_contiguous():
        raise ValueError("rows: ray_idx must be a contiguous 1-D int64 tensor")


def take_rows_plain(arrays, ray_idx):
    """Plain version of kernel H1: each array's rows at ``ray_idx``, a row
    of zeros where ``ray_idx`` >= the array's length (JAX's
    ``_pad_one(a)[ray_idx]``)."""
    return [torch.cat([a, torch.zeros((1,) + a.shape[1:], dtype=a.dtype, device=a.device)]
                      )[ray_idx] for a in arrays]


def take_rows_cuda(arrays, ray_idx):
    """Kernel H1 launch: same returns as :func:`take_rows_plain`, for arrays
    that share their first dimension, in one launch (none when there is no
    byte to move). Counts launches in ``take_rows_cuda.launches``."""
    _check_idx(ray_idx)
    arrays = [a.contiguous() for a in arrays]
    n = arrays[0].shape[0]
    if any(a.shape[0] != n or a.device != ray_idx.device for a in arrays):
        raise ValueError("rows: the arrays share their first dimension and the ids' device")
    B = ray_idx.shape[0]
    outs = [torch.empty((B,) + a.shape[1:], dtype=a.dtype, device=a.device) for a in arrays]
    rows = _row_arrays(arrays, outs)
    if B == 0 or rows.row_chunks == 0:
        return outs
    lib = kernels.load("compaction")
    err = lib.psdf_take_rows(rows, kernels.ptr(ray_idx), B, n,
                             kernels.current_stream(ray_idx.device))
    kernels.check(lib, err, "take rows (kernel H1)")
    take_rows_cuda.launches += 1
    return outs


take_rows_cuda.launches = 0


def take_rows(arrays, ray_idx):
    """The rows at ``ray_idx`` [B] int64 of each array (all [n, ...]); ids
    >= n give a row of zeros."""
    fn = kernels.dispatch(ray_idx.device, take_rows_cuda, take_rows_plain)
    return fn(list(arrays), ray_idx)


def scatter_rows_plain(arrays, ray_idx, n: int, fills):
    """Plain version of kernel H2: [n, ...] arrays holding ``fills`` and,
    at rows ``ray_idx`` < n, the bucket's rows (JAX's ``_scatter_rays``)."""
    outs = []
    for x, fill in zip(arrays, fills):
        base = torch.full((n + 1,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
        outs.append(base.index_put((ray_idx,), x)[:n])
    return outs


def scatter_rows_cuda(arrays, ray_idx, n: int, fills):
    """Kernel H2 launch: same returns as :func:`scatter_rows_plain`, for
    ``ray_idx`` ascending with its valid ids distinct (as a compaction lists
    them), in one launch (none when there is no byte to move). Counts
    launches in ``scatter_rows_cuda.launches``."""
    _check_idx(ray_idx)
    arrays = [a.contiguous() for a in arrays]
    B = ray_idx.shape[0]
    if any(a.shape[0] != B or a.device != ray_idx.device for a in arrays):
        raise ValueError("rows: the bucket arrays share the ids' length and device")
    outs = [torch.empty((n,) + a.shape[1:], dtype=a.dtype, device=a.device) for a in arrays]
    rows = _row_arrays(arrays, outs, fills)
    if n == 0 or rows.row_chunks == 0:
        return outs
    lib = kernels.load("compaction")
    err = lib.psdf_scatter_rows(rows, kernels.ptr(ray_idx), B, n,
                                kernels.current_stream(ray_idx.device))
    kernels.check(lib, err, "scatter rows (kernel H2)")
    scatter_rows_cuda.launches += 1
    return outs


scatter_rows_cuda.launches = 0


class _ScatterRowsFn(torch.autograd.Function):
    """Kernel H2 with a backward of kernel H1 (the cotangent rows at the
    valid ids, zeros at the fill slots); plain versions on the CPU."""

    @staticmethod
    def forward(ctx, ray_idx, n, fills, *arrays):
        ctx.save_for_backward(ray_idx)
        fn = kernels.dispatch(ray_idx.device, scatter_rows_cuda, scatter_rows_plain)
        return tuple(fn(list(arrays), ray_idx, n, fills))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cots):
        (ray_idx,) = ctx.saved_tensors
        return (None, None, None, *take_rows([c.contiguous() for c in cots], ray_idx))


def scatter_rows(arrays, ray_idx, n: int, fills):
    """Bucket rows back to an n-ray batch: each [B, ...] array lands at rows
    ``ray_idx`` [B] int64 (ascending, the valid ids distinct, as
    :func:`nonzero_static` lists them; ids >= n are dropped), the other rows
    hold its fill. Differentiable in the arrays."""
    return list(_ScatterRowsFn.apply(ray_idx, int(n), tuple(fills), *arrays))
