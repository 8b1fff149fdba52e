"""Multi-resolution permutohedral-lattice hash encoding (counterpart of
``permuto_sdf_tpu/ops/permuto_encoding.py``).

A d-dimensional point is scaled by ``1/sigma_l`` and shifted per level,
elevated onto the hyperplane H_d, located in its enclosing simplex (d+1
vertices), each vertex hashed into a ``capacity``-slot table of 2 features,
and the features blended with the barycentric weights. Levels are
concatenated (level major, feature minor), followed by the scaled point.

Two hand-written CUDA kernels implement it on the card
(``kernels/csrc/permuto_encoding.cu``): kernel A, the forward; kernel B,
the gradient with respect to the points (for the SDF normals). Each has a
plain PyTorch version here, which runs for CPU tensors and is what the
kernels are held against. The plain versions compute the lattice in the
same float order as the kernels, and the hash in int64 with a 32-bit mask
after every multiply, so the slot ids equal the kernel's (uint32 wrap)
and the JAX package's bit for bit.

The table keeps the JAX parameter layout ``[L, F, C]``. Table gradients
(training) are not part of this slice and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from permuto_sdf_tpu_torch import kernels

# Hash primes of the JAX package (instant-ngp style multiply-xor).
_HASH_PRIMES = (2654435761, 805459861, 3674653429, 2097192037, 1434869437,
                2165219737)
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PermutoEncodingSpec:
    """Static configuration of the encoding (the lowering knobs of the JAX
    spec, such as ``row_gather``, select XLA gather forms and have no
    counterpart here: every form returns the same f32 values)."""

    pos_dim: int
    capacity: int = 2 ** 18
    nr_levels: int = 24
    nr_feat_per_level: int = 2
    coarsest_scale: float = 1.0
    finest_scale: float = 0.0001
    apply_random_shift_per_level: bool = True
    concat_points: bool = True
    concat_points_scaling: float = 1.0

    def __post_init__(self):
        if self.capacity & (self.capacity - 1):
            raise ValueError("capacity must be a power of 2")
        if self.pos_dim > len(_HASH_PRIMES):
            raise ValueError(f"pos_dim must be <= {len(_HASH_PRIMES)}")

    @property
    def scales(self) -> np.ndarray:
        """Per-level sigma, geometric from coarse to fine."""
        return np.geomspace(self.coarsest_scale, self.finest_scale, self.nr_levels)

    @property
    def output_dims(self) -> int:
        out = self.nr_levels * self.nr_feat_per_level
        if self.concat_points:
            out += self.pos_dim
        return out


def init_encoding_params(generator: torch.Generator, spec: PermutoEncodingSpec,
                         device=None) -> dict:
    """Hash tables ``lattice_values [L, F, C]`` ~ U(-1e-4, 1e-4) and the
    fixed per-level shifts ``shift_per_level [L, d]`` ~ N(0, 10^2). Drawn on
    the CPU from ``generator`` and moved to ``device``."""
    table = torch.rand((spec.nr_levels, spec.nr_feat_per_level, spec.capacity),
                       generator=generator, dtype=torch.float32) * 2e-4 - 1e-4
    if spec.apply_random_shift_per_level:
        shift = torch.randn((spec.nr_levels, spec.pos_dim), generator=generator,
                            dtype=torch.float32) * 10.0
    else:
        shift = torch.zeros((spec.nr_levels, spec.pos_dim), dtype=torch.float32)
    return {"lattice_values": table.to(device), "shift_per_level": shift.to(device)}


def _elevation_matrix(d: int) -> np.ndarray:
    """Static (d+1, d) matrix E with ``elevated = E @ pos_scaled``."""
    sf = (d + 1) / np.sqrt((np.arange(1, d + 1)) * (np.arange(1, d + 1) + 1))
    E = np.zeros((d + 1, d), dtype=np.float64)
    for i in range(d + 1):
        for j in range(1, d + 1):
            if j > i:
                E[i, j - 1] = 1.0
            elif j == i:
                E[i, j - 1] = -float(i)
    return (E * sf[None, :]).astype(np.float32)


def coarse2fine_window(t, nr_levels: int) -> np.ndarray:
    """Per-level ease-in weights [nr_levels] (f32) for c2f parameter ``t``."""
    alpha = np.float32(t) * np.float32(nr_levels)
    x = np.clip(alpha - np.arange(nr_levels, dtype=np.float32), 0.0, 1.0)
    x = x.astype(np.float32)
    return (np.float32(0.5) * (np.float32(1.0) - np.cos(np.float32(np.pi) * x))
            ).astype(np.float32)


_CONSTS: dict = {}


def device_constant(key, make, device) -> torch.Tensor:
    """Small constant tensors (E, sigmas, windows) uploaded once per device."""
    k = (key, str(device))
    t = _CONSTS.get(k)
    if t is None:
        t = torch.tensor(np.asarray(make()), dtype=torch.float32).to(device)
        _CONSTS[k] = t
    return t


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def _mul32(u: torch.Tensor, prime: int) -> torch.Tensor:
    """(u * prime) mod 2^32 for int64 ``u`` in [0, 2^32) without int64
    overflow: split the prime into 16-bit halves."""
    lo = u * (prime & 0xFFFF)
    hi = ((u * (prime >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _simplex_plain(lat, E: torch.Tensor, capacity: int):
    """Simplex lookup of lattice points given as d tensors of one shape.

    Returns (rank [d+1 tensors int32], bary [d+1 tensors], slots [d+1
    tensors int64]). Same float order as ``find_simplex`` in the kernel."""
    d = len(lat)
    dp1 = float(d + 1)
    elevated = []
    for i in range(d + 1):
        acc = E[i, 0] * lat[0]
        for j in range(1, d):
            acc = acc + E[i, j] * lat[j]
        elevated.append(acc)
    rem0f = []
    total = None
    for i in range(d + 1):
        v = elevated[i] / dp1
        up = torch.ceil(v) * dp1
        down = torch.floor(v) * dp1
        r = torch.where(up - elevated[i] < elevated[i] - down, up, down)
        rem0f.append(r)
        total = r if total is None else total + r
    sum_val = (total / dp1).to(torch.int32)
    diff = [elevated[i] - rem0f[i] for i in range(d + 1)]
    rank, rem0 = [], []
    for i in range(d + 1):
        r = torch.zeros_like(sum_val)
        for j in range(d + 1):
            if j > i:
                r = r + (diff[i] < diff[j]).to(torch.int32)
            elif j < i:
                r = r + (diff[j] >= diff[i]).to(torch.int32)
        r = r + sum_val
        q = rem0f[i].to(torch.int32)
        low, high = r < 0, r > d
        r = torch.where(low, r + (d + 1), torch.where(high, r - (d + 1), r))
        q = torch.where(low, q + (d + 1), torch.where(high, q - (d + 1), q))
        rank.append(r)
        rem0.append(q)
    delta = [(elevated[i] - rem0[i].to(elevated[i].dtype)) / dp1 for i in range(d + 1)]
    bfull = []
    for k in range(d + 2):
        acc = torch.zeros_like(delta[0])
        for i in range(d + 1):
            acc = (acc + torch.where(rank[i] == d - k, delta[i], 0.0)
                   - torch.where(rank[i] == d + 1 - k, delta[i], 0.0))
        bfull.append(acc)
    bary = [(bfull[0] + 1.0) + bfull[d + 1]] + bfull[1:d + 1]
    slots = []
    for r in range(d + 1):
        h = None
        for i in range(d):
            key = rem0[i] + r
            key = torch.where(rank[i] > d - r, key - (d + 1), key)
            term = _mul32(key.to(torch.int64) & _MASK32, _HASH_PRIMES[i])
            h = term if h is None else h ^ term
        slots.append(h & (capacity - 1))
    return rank, bary, slots


def _lattice_points(points, shift, scales, K):
    """d tensors [K, N]: points / sigma_l + shift_l."""
    d = points.shape[1]
    return [points[:, j][None, :] / scales[:K, None] + shift[:K, j][:, None]
            for j in range(d)]


def _gather(table_flat, K, C, slot, f):
    """table[l, f, slot] for slot [K, N]."""
    base = (torch.arange(K, device=slot.device)[:, None] * 2 + f) * C
    return table_flat[base + slot]


def flat_slot_ids(points, table, shift, scales, E, K):
    """[K, d+1, N] int64 flat ids ``l*C + slot`` of the vertices each point
    reads (for counting the bytes a call must move)."""
    C = table.shape[-1]
    _, _, slots = _simplex_plain(_lattice_points(points, shift, scales, K), E, C)
    level = torch.arange(K, device=points.device)[:, None] * C
    return torch.stack([s + level for s in slots], dim=1)


def encode_fwd_plain(points, table, shift, scales, window, E, K: int,
                     concat_scaling: float, concat: bool) -> torch.Tensor:
    """Plain version of kernel A. points [N, d] -> [N, 2K (+d)]."""
    N, d = points.shape
    C = table.shape[-1]
    _, bary, slots = _simplex_plain(_lattice_points(points, shift, scales, K), E, C)
    flat = table[:K].reshape(-1)
    feats = []
    for f in range(2):
        acc = bary[0] * _gather(flat, K, C, slots[0], f)
        for r in range(1, d + 1):
            acc = acc + bary[r] * _gather(flat, K, C, slots[r], f)
        if window is not None:
            acc = acc * window[:K, None]
        feats.append(acc)
    out = torch.stack(feats, dim=1).reshape(K * 2, N).t()  # [N, K*F], level major
    if concat:
        out = torch.cat([out, points * concat_scaling], dim=-1)
    return out.contiguous()


def encode_point_grad_plain(points, table, shift, scales, window, E, K: int,
                            concat_scaling: float, concat: bool,
                            g: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B: d/dpoints of sum(g * encode(points))."""
    N, d = points.shape
    C = table.shape[-1]
    dp1 = float(d + 1)
    rank, _, slots = _simplex_plain(_lattice_points(points, shift, scales, K), E, C)
    flat = table[:K].reshape(-1)
    g_lv = g[:, :2 * K].t().reshape(K, 2, N)
    if window is not None:
        g_lv = g_lv * window[:K, None, None]
    g0, g1 = g_lv[:, 0], g_lv[:, 1]
    gb = [g0 * _gather(flat, K, C, slots[r], 0) + g1 * _gather(flat, K, C, slots[r], 1)
          for r in range(d + 1)]
    gb_stack = torch.stack(gb, dim=0)  # [d+1, K, N]
    gel = []
    for i in range(d + 1):
        lo = (d - rank[i]).to(torch.int64)
        hi = ((d + 1 - rank[i]) % (d + 1)).to(torch.int64)
        g_lo = torch.gather(gb_stack, 0, lo[None]).squeeze(0)
        g_hi = torch.gather(gb_stack, 0, hi[None]).squeeze(0)
        gel.append((g_lo - g_hi) / dp1)
    cols = []
    for j in range(d):
        gl = E[0, j] * gel[0]
        for i in range(1, d + 1):
            gl = gl + E[i, j] * gel[i]
        gl = gl / scales[:K, None]  # [K, N]
        acc = gl[0]
        for l in range(1, K):
            acc = acc + gl[l]
        if concat:
            acc = acc + g[:, 2 * K + j] * concat_scaling
        cols.append(acc)
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors launch the kernel; CPU tensors run the plain
# version; nothing else is accepted)
# ---------------------------------------------------------------------------

def _check_inputs(points, table, shift, scales, window, E, K):
    if points.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError("permuto encode: points and table must be float32")
    if points.dim() != 2 or points.shape[1] not in (3, 4):
        raise ValueError(f"permuto encode: points must be [N, 3|4], got {tuple(points.shape)}")
    if table.dim() != 3 or table.shape[1] != 2 or K > table.shape[0]:
        raise ValueError("permuto encode: table must be [L, 2, C] with L >= K")
    for t in (points, table, shift, scales, E) + ((window,) if window is not None else ()):
        if t.device != points.device or not t.is_contiguous():
            raise ValueError("permuto encode: all inputs must be contiguous "
                             "and on the points' device")


def encode_fwd_cuda(points, table, shift, scales, window, E, K: int,
                    concat_scaling: float, concat: bool) -> torch.Tensor:
    """Kernel A launch. Counts launches in ``encode_fwd_cuda.launches``."""
    _check_inputs(points, table, shift, scales, window, E, K)
    N, d = points.shape
    stride = 2 * K + (d if concat else 0)
    out = torch.empty((N, stride), dtype=torch.float32, device=points.device)
    lib = kernels.load("permuto_encoding")
    err = lib.psdf_encode_fwd(
        d, kernels.ptr(points), N, kernels.ptr(table), table.shape[-1],
        kernels.ptr(shift), kernels.ptr(scales), kernels.ptr(window), kernels.ptr(E), K,
        float(concat_scaling), int(concat), kernels.ptr(out), stride,
        kernels.current_stream(points.device))
    kernels.check(lib, err, "permuto encode forward (kernel A)")
    encode_fwd_cuda.launches += 1
    return out


encode_fwd_cuda.launches = 0


def encode_point_grad_cuda(points, table, shift, scales, window, E, K: int,
                           concat_scaling: float, concat: bool,
                           g: torch.Tensor) -> torch.Tensor:
    """Kernel B launch. Counts launches in ``encode_point_grad_cuda.launches``."""
    _check_inputs(points, table, shift, scales, window, E, K)
    N, d = points.shape
    g = g.contiguous()
    if g.shape != (N, 2 * K + (d if concat else 0)) or g.dtype != torch.float32:
        raise ValueError(f"permuto encode grad: bad cotangent {tuple(g.shape)}")
    grad = torch.empty((N, d), dtype=torch.float32, device=points.device)
    lib = kernels.load("permuto_encoding")
    err = lib.psdf_encode_point_grad(
        d, kernels.ptr(points), N, kernels.ptr(table), table.shape[-1],
        kernels.ptr(shift), kernels.ptr(scales), kernels.ptr(window), kernels.ptr(E), K,
        float(concat_scaling), int(concat), kernels.ptr(g), g.shape[1], kernels.ptr(grad),
        kernels.current_stream(points.device))
    kernels.check(lib, err, "permuto encode point gradient (kernel B)")
    encode_point_grad_cuda.launches += 1
    return grad


encode_point_grad_cuda.launches = 0


def _dispatch(points, cuda_fn, plain_fn):
    if points.is_cuda:
        return cuda_fn
    if points.device.type == "cpu":
        return plain_fn
    raise ValueError(f"permuto encode: unsupported device {points.device}")


class _PermutoEncodeFn(torch.autograd.Function):
    """Encode with a point gradient from kernel B (plain version on CPU).
    The table gets no gradient in this slice."""

    @staticmethod
    def forward(ctx, points, table, shift, scales, window, E, K, concat_scaling,
                concat):
        ctx.save_for_backward(points, table, shift, scales, window, E)
        ctx.args = (K, concat_scaling, concat)
        fn = _dispatch(points, encode_fwd_cuda, encode_fwd_plain)
        return fn(points, table, shift, scales, window, E, K, concat_scaling, concat)

    @staticmethod
    def backward(ctx, g):
        points, table, shift, scales, window, E = ctx.saved_tensors
        K, concat_scaling, concat = ctx.args
        fn = _dispatch(points, encode_point_grad_cuda, encode_point_grad_plain)
        grad = fn(points, table, shift, scales, window, E, K, concat_scaling,
                  concat, g.contiguous())
        return grad, None, None, None, None, None, None, None, None


def encoding_constants(spec: PermutoEncodingSpec, window, device):
    """(sigmas [L], E, window or None) as device tensors, uploaded once."""
    scales = device_constant(("scales", spec.nr_levels, spec.coarsest_scale,
                              spec.finest_scale),
                             lambda: spec.scales.astype(np.float32), device)
    E = device_constant(("E", spec.pos_dim),
                        lambda: _elevation_matrix(spec.pos_dim), device)
    if window is not None and not isinstance(window, torch.Tensor):
        w = np.asarray(window, np.float32)
        window = device_constant(("window", w.tobytes()), lambda: w, device)
    return scales, E, window


def permuto_encode(params: dict, points: torch.Tensor, spec: PermutoEncodingSpec,
                   window=None, max_levels: Optional[int] = None,
                   zero_fill: bool = True) -> torch.Tensor:
    """Encode ``points [N, d]`` -> ``[N, output_dims]``.

    ``window`` is the per-level c2f weight (numpy or tensor, default ones);
    ``max_levels`` evaluates only the K coarsest levels, zero-filling the
    rest unless ``zero_fill=False`` (then the output is ``[N, 2K (+d)]``).
    Differentiable in ``points`` (kernel B on the card)."""
    d = spec.pos_dim
    if points.shape[-1] != d:
        raise ValueError(f"points must be [N, {d}]")
    if spec.nr_feat_per_level != 2:
        raise NotImplementedError("the port's encoding kernels take 2 features per level")
    table = params["lattice_values"]
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("hash-table gradients come with the training slice")
    L_full = spec.nr_levels
    K = L_full if max_levels is None else min(max_levels, L_full)
    scales, E, window = encoding_constants(spec, window, points.device)
    out = _PermutoEncodeFn.apply(
        points.contiguous(), table.contiguous(),
        params["shift_per_level"].detach().contiguous(), scales, window, E, K,
        float(spec.concat_points_scaling), bool(spec.concat_points))
    if K < L_full and zero_fill:
        zeros = out.new_zeros((out.shape[0], (L_full - K) * 2))
        parts = [out[:, :2 * K], zeros]
        if spec.concat_points:
            parts.append(out[:, 2 * K:])
        out = torch.cat(parts, dim=-1)
    return out
