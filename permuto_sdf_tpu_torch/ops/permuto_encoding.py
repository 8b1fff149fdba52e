"""Multi-resolution permutohedral-lattice hash encoding (counterpart of
``permuto_sdf_tpu/ops/permuto_encoding.py``).

A d-dimensional point is scaled by ``1/sigma_l`` and shifted per level,
elevated onto the hyperplane H_d, located in its enclosing simplex (d+1
vertices), each vertex hashed into a ``capacity``-slot table of 2 features,
and the features blended with the barycentric weights. Levels are
concatenated (level major, feature minor), followed by the scaled point.

Four hand-written CUDA kernels implement it on the card
(``kernels/csrc/permuto_encoding.cu``): kernel A, the forward; kernel B,
the gradient with respect to the points (for the SDF normals); kernel F,
the gradient with respect to the table; kernel G, the backward of kernel
B (the eikonal and curvature losses differentiate the SDF normals). Each
has a plain PyTorch version here, which runs for CPU tensors and is what
the kernels are held against. The plain versions compute the lattice in
the same float order as the kernels, and the hash in int64 with a 32-bit
mask after every multiply, so the slot ids equal the kernel's (uint32
wrap) and the JAX package's bit for bit.

Autograd: :func:`permuto_encode` is kernel A with a backward of F (table)
and B (points). :func:`permuto_point_grad` is kernel B as a function of
the table and of the feature cotangent ``g``, with a backward of G. Under
``grad_level_parity`` (alternating-level table gradients) F and G take the
levels ``(phase, period)`` that get table gradients and skip the others. The
SDF's normals are built from the two (``models/fields.py``), which is the
reverse-mode gradient JAX forms, without differentiating a backward pass.

The table keeps the JAX parameter layout ``[L, F, C]``.
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
    # Alternating-level table gradients: with ``grad_level_parity`` set,
    # only the levels l with ``l % grad_level_period == parity % period``
    # get table gradients (kernels F and G skip the others, whose gradient
    # stays exactly zero); the forward and the point gradient are unchanged.
    # Active when period > 1 and at least ``period`` levels are encoded.
    grad_level_parity: Optional[int] = None
    grad_level_period: int = 2

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


def _grad_levels(spec: PermutoEncodingSpec, K: int) -> tuple:
    """(phase, period) of the levels that get table gradients when K levels
    are encoded: period 1 means every level."""
    period = spec.grad_level_period
    if spec.grad_level_parity is None or period <= 1 or K < period:
        return 0, 1
    return spec.grad_level_parity % period, period


def _active_levels(K: int, levels: tuple, device) -> torch.Tensor:
    """Indices of the levels < K that get table gradients."""
    phase, period = levels
    lv = torch.arange(K, device=device)
    return lv if period <= 1 else lv[lv % period == phase]


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


def encode_table_grad_plain(points, table, shift, scales, window, E, K: int,
                            g: torch.Tensor, levels: tuple = (0, 1)) -> torch.Tensor:
    """Plain version of kernel F: d table [L, 2, C] of sum(g * encode)
    (``index_add_`` of the gather's transpose); levels >= K, and levels
    outside ``levels = (phase, period)``, get zero."""
    N, d = points.shape
    L, _, C = table.shape
    _, bary, slots = _simplex_plain(_lattice_points(points, shift, scales, K), E, C)
    g_lv = g[:, :2 * K].t().reshape(K, 2, N)
    if window is not None:
        g_lv = g_lv * window[:K, None, None]
    act = _active_levels(K, levels, points.device)
    out = torch.zeros(L * 2 * C, dtype=torch.float32, device=points.device)
    for f in range(2):
        base = (act[:, None] * 2 + f) * C
        for r in range(d + 1):
            out.index_add_(0, (base + slots[r][act]).reshape(-1),
                           (bary[r][act] * g_lv[act, f]).reshape(-1))
    return out.reshape(L, 2, C)


def encode_double_backward_plain(points, table, shift, scales, window, E, K: int,
                                 concat_scaling: float, concat: bool,
                                 g: torch.Tensor, u: torch.Tensor, levels: tuple = (0, 1)):
    """Plain version of kernel G: the VJP of kernel B's output (the point
    gradient) with cotangent ``u [N, d]``, with respect to the table (the
    levels of ``levels = (phase, period)`` only) and to the feature
    cotangent ``g`` (every level). Returns (d table [L, 2, C], d g)."""
    N, d = points.shape
    L, _, C = table.shape
    dp1 = float(d + 1)
    rank, _, slots = _simplex_plain(_lattice_points(points, shift, scales, K), E, C)
    flat = table[:K].reshape(-1)
    w = window[:K] if window is not None else torch.ones(K, device=points.device)
    Eu = []
    for i in range(d + 1):
        acc = E[i, 0] * u[:, 0]
        for j in range(1, d):
            acc = acc + E[i, j] * u[:, j]
        Eu.append(acc)
    c = [Eu[i][None, :] / scales[:K, None] / dp1 for i in range(d + 1)]  # [K, N]
    lo = [(d - rank[i]) for i in range(d + 1)]
    hi = [(d + 1 - rank[i]) % (d + 1) for i in range(d + 1)]
    h = []
    for r in range(d + 1):
        acc = torch.zeros_like(c[0])
        for i in range(d + 1):
            acc = acc + torch.where(lo[i] == r, c[i], 0.0)
            acc = acc - torch.where(hi[i] == r, c[i], 0.0)
        h.append(acc)
    dg_cols = []
    for f in range(2):
        acc = h[0] * _gather(flat, K, C, slots[0], f)
        for r in range(1, d + 1):
            acc = acc + h[r] * _gather(flat, K, C, slots[r], f)
        dg_cols.append(w[:, None] * acc)
    d_g = torch.stack(dg_cols, dim=1).reshape(2 * K, N).t()
    if concat:
        d_g = torch.cat([d_g, u * concat_scaling], dim=-1)
    g_lv = g[:, :2 * K].t().reshape(K, 2, N)
    act = _active_levels(K, levels, points.device)
    d_table = torch.zeros(L * 2 * C, dtype=torch.float32, device=points.device)
    for f in range(2):
        base = (act[:, None] * 2 + f) * C
        for r in range(d + 1):
            d_table.index_add_(0, (base + slots[r][act]).reshape(-1),
                               ((h[r][act] * w[act, None]) * g_lv[act, f]).reshape(-1))
    return d_table.reshape(L, 2, C), d_g.contiguous()


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


def encode_table_grad_cuda(points, table, shift, scales, window, E, K: int,
                           g: torch.Tensor, levels: tuple = (0, 1)) -> torch.Tensor:
    """Kernel F launch: d table [L, 2, C] (levels >= K and levels outside
    ``levels = (phase, period)`` zero). Counts launches in
    ``encode_table_grad_cuda.launches``."""
    _check_inputs(points, table, shift, scales, window, E, K)
    N, d = points.shape
    _check_cotangent(g, N, 2 * K, points.device)
    d_table = torch.zeros_like(table)
    lib = kernels.load("permuto_encoding")
    err = lib.psdf_encode_table_grad(
        d, kernels.ptr(points), N, table.shape[-1], kernels.ptr(shift), kernels.ptr(scales),
        kernels.ptr(window), kernels.ptr(E), K, kernels.ptr(g), g.shape[1],
        int(levels[0]), int(levels[1]), kernels.ptr(d_table),
        kernels.current_stream(points.device))
    kernels.check(lib, err, "permuto encode table gradient (kernel F)")
    encode_table_grad_cuda.launches += 1
    return d_table


encode_table_grad_cuda.launches = 0


def encode_double_backward_cuda(points, table, shift, scales, window, E, K: int,
                                concat_scaling: float, concat: bool,
                                g: torch.Tensor, u: torch.Tensor, levels: tuple = (0, 1)):
    """Kernel G launch: (d table [L, 2, C] at the levels of ``levels =
    (phase, period)``, d g). Counts launches in
    ``encode_double_backward_cuda.launches``."""
    _check_inputs(points, table, shift, scales, window, E, K)
    N, d = points.shape
    _check_cotangent(g, N, 2 * K + (d if concat else 0), points.device, exact=True)
    if u.shape != (N, d) or u.dtype != torch.float32 or not u.is_contiguous():
        raise ValueError(f"permuto encode double backward: bad cotangent {tuple(u.shape)}")
    d_table = torch.zeros_like(table)
    d_g = torch.empty_like(g)
    lib = kernels.load("permuto_encoding")
    err = lib.psdf_encode_double_backward(
        d, kernels.ptr(points), N, kernels.ptr(table), table.shape[-1],
        kernels.ptr(shift), kernels.ptr(scales), kernels.ptr(window), kernels.ptr(E), K,
        float(concat_scaling), int(concat), kernels.ptr(g), g.shape[1], kernels.ptr(u),
        int(levels[0]), int(levels[1]), kernels.ptr(d_table), kernels.ptr(d_g),
        kernels.current_stream(points.device))
    kernels.check(lib, err, "permuto encode double backward (kernel G)")
    encode_double_backward_cuda.launches += 1
    return d_table, d_g


encode_double_backward_cuda.launches = 0


def _check_cotangent(g, N, min_cols, device, exact=False):
    if (g.dim() != 2 or g.shape[0] != N or g.shape[1] < min_cols
            or (exact and g.shape[1] != min_cols)
            or g.dtype != torch.float32 or g.device != device or not g.is_contiguous()):
        raise ValueError(f"permuto encode: bad feature cotangent {tuple(g.shape)}")


class _PermutoEncodeFn(torch.autograd.Function):
    """Encode (kernel A) with a backward of kernel F for the table and
    kernel B for the points (plain versions on the CPU). The backward is
    not differentiated again: second-order terms go through
    :class:`_PointGradFn`."""

    @staticmethod
    def forward(ctx, points, table, shift, scales, window, E, K, concat_scaling,
                concat, levels):
        ctx.save_for_backward(points, table, shift, scales, window, E)
        ctx.args = (K, concat_scaling, concat, levels)
        fn = kernels.dispatch(points.device, encode_fwd_cuda, encode_fwd_plain)
        return fn(points, table, shift, scales, window, E, K, concat_scaling, concat)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        points, table, shift, scales, window, E = ctx.saved_tensors
        K, concat_scaling, concat, levels = ctx.args
        g = g.contiguous()
        d_points = d_table = None
        if ctx.needs_input_grad[0]:
            fn = kernels.dispatch(points.device, encode_point_grad_cuda, encode_point_grad_plain)
            d_points = fn(points, table, shift, scales, window, E, K, concat_scaling,
                          concat, g)
        if ctx.needs_input_grad[1]:
            fn = kernels.dispatch(points.device, encode_table_grad_cuda, encode_table_grad_plain)
            d_table = fn(points, table, shift, scales, window, E, K, g, levels)
        return d_points, d_table, None, None, None, None, None, None, None, None


class _PointGradFn(torch.autograd.Function):
    """d/dpoints of sum(g * encode(points)) (kernel B) as a function of the
    table and of ``g``, with a backward of kernel G. Its gradient with
    respect to the points is zero: the barycentric weights are piecewise
    linear in the points."""

    @staticmethod
    def forward(ctx, points, table, g, shift, scales, window, E, K, concat_scaling,
                concat, levels):
        ctx.save_for_backward(points, table, g, shift, scales, window, E)
        ctx.args = (K, concat_scaling, concat, levels)
        fn = kernels.dispatch(points.device, encode_point_grad_cuda, encode_point_grad_plain)
        return fn(points, table, shift, scales, window, E, K, concat_scaling, concat, g)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, u):
        points, table, g, shift, scales, window, E = ctx.saved_tensors
        K, concat_scaling, concat, levels = ctx.args
        if not (ctx.needs_input_grad[1] or ctx.needs_input_grad[2]):
            return (None,) * 11
        fn = kernels.dispatch(points.device, encode_double_backward_cuda,
                              encode_double_backward_plain)
        d_table, d_g = fn(points, table, shift, scales, window, E, K, concat_scaling,
                          concat, g, u.contiguous(), levels)
        return (None, d_table if ctx.needs_input_grad[1] else None,
                d_g if ctx.needs_input_grad[2] else None) + (None,) * 8


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


def _encode_args(params: dict, points: torch.Tensor, spec: PermutoEncodingSpec,
                 window, max_levels: Optional[int]):
    d = spec.pos_dim
    if points.shape[-1] != d:
        raise ValueError(f"points must be [N, {d}]")
    if spec.nr_feat_per_level != 2:
        raise NotImplementedError("the port's encoding kernels take 2 features per level")
    K = spec.nr_levels if max_levels is None else min(max_levels, spec.nr_levels)
    scales, E, window = encoding_constants(spec, window, points.device)
    return (points.contiguous(), params["lattice_values"].contiguous(),
            params["shift_per_level"].detach().contiguous(), scales, window, E, K,
            float(spec.concat_points_scaling), bool(spec.concat_points), _grad_levels(spec, K))


def permuto_encode(params: dict, points: torch.Tensor, spec: PermutoEncodingSpec,
                   window=None, max_levels: Optional[int] = None,
                   zero_fill: bool = True) -> torch.Tensor:
    """Encode ``points [N, d]`` -> ``[N, output_dims]``.

    ``window`` is the per-level c2f weight (numpy or tensor, default ones);
    ``max_levels`` evaluates only the K coarsest levels, zero-filling the
    rest unless ``zero_fill=False`` (then the output is ``[N, 2K (+d)]``).
    Differentiable in ``points`` (kernel B on the card) and in the table
    (kernel F); the per-level shifts are fixed, as in the JAX package."""
    points, table, shift, scales, window, E, K, cs, concat, levels = _encode_args(
        params, points, spec, window, max_levels)
    out = _PermutoEncodeFn.apply(points, table, shift, scales, window, E, K, cs, concat,
                                 levels)
    L_full = spec.nr_levels
    if K < L_full and zero_fill:
        zeros = out.new_zeros((out.shape[0], (L_full - K) * 2))
        parts = [out[:, :2 * K], zeros]
        if spec.concat_points:
            parts.append(out[:, 2 * K:])
        out = torch.cat(parts, dim=-1)
    return out


def permuto_point_grad(params: dict, points: torch.Tensor, g: torch.Tensor,
                       spec: PermutoEncodingSpec, window=None,
                       max_levels: Optional[int] = None) -> torch.Tensor:
    """d/dpoints of ``sum(g * permuto_encode(..., zero_fill=False))`` ->
    ``[N, d]`` (kernel B), differentiable in the table and in ``g`` (kernel
    G). ``g`` has the narrow layout ``[N, 2K (+d)]``."""
    points, table, shift, scales, window, E, K, cs, concat, levels = _encode_args(
        params, points, spec, window, max_levels)
    return _PointGradFn.apply(points, table, g.contiguous(), shift, scales, window, E, K,
                              cs, concat, levels)
