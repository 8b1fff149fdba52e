"""Isosurface extraction from an SDF model (counterpart of
``permuto_sdf_tpu/ops/marching_cubes.py``).

The grid is cut into ``block``-sized sub-grids whose SDF is evaluated on
the device (kernel A and the SDF MLP under ``torch.no_grad``), quantized to
int16 and back as the JAX package does, and kept on the device; then
**marching tetrahedra** runs over the whole grid: each cube is split into 6
positively oriented tetrahedra, each emitting 0-2 triangles from a 16-case
table generated from the inside/outside topology, wound so the normals
point toward positive values (outward).

The semantics are those of the JAX package's native path
(``permuto_sdf_tpu/native/marching_tets.cpp``), which it takes wherever a
C++ compiler exists: triangles in the loop order (cube x, y, z, then
tetrahedron, triangle, edge), each edge canonicalised by global corner id
before a float32 interpolation clamped to [0, 1], vertices welded by the
key ``llround(g * 1e6)`` per grid axis in order of first emission (the
vertices of a dropped degenerate face stay), and the world transform
``origin + g * spacing`` rounded once (the host build contracts it into a
fused multiply-add). On the card this is kernel M
(``kernels/csrc/marching_tets.cu``: M1 counts the triangles of each tile
of cubes and each 32-cube word, M2 emits them and inserts every emitted
vertex into a hash table keyed by its exact key, which leaves each key's
first emission), then a ranking of the first emissions into vertex numbers
(:func:`weld_first`: a cumulative sum and gathers, no sort); on the CPU the
plain version below, which welds with :func:`weld` (``torch.unique``).

Meshes come back as tensors on the grid's device: vertices [V, 3] float32
in world units, faces [F, 3] int64.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from permuto_sdf_tpu_torch import kernels
from permuto_sdf_tpu_torch.device import resolve_device

# Six-tetrahedra decomposition of the unit cube around the 0-7 diagonal.
# Cube corners indexed by (x, y, z) bits: corner k = (k&1, (k>>1)&1, (k>>2)&1).
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int64
)
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]],
    dtype=np.int64,
)

# The 6 edges of a tetrahedron as (vertex, vertex) pairs.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)


def _check_positive_orientation():
    for tet in _TETS:
        v = _CUBE_CORNERS[tet].astype(np.float64)
        det = np.linalg.det(np.stack([v[1] - v[0], v[2] - v[0], v[3] - v[0]]))
        assert det > 0, f"tet {tet} not positively oriented (det={det})"


def _build_case_table() -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tri_edges [16, 2, 3], n_tris [16]).

    tri_edges[case, t] holds the 3 tet-edge ids of triangle t (-1 padded).
    Winding is derived geometrically: on a canonical positively-oriented
    tetrahedron, the triangle normal must point from the inside vertices
    toward the outside ones (toward positive SDF).
    """
    canon = np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )
    det = np.linalg.det(np.stack([canon[1] - canon[0], canon[2] - canon[0], canon[3] - canon[0]]))
    assert det > 0

    edge_id = {}
    for e, (a, b) in enumerate(_TET_EDGES):
        edge_id[(a, b)] = e
        edge_id[(b, a)] = e

    tri_edges = -np.ones((16, 2, 3), dtype=np.int64)
    n_tris = np.zeros(16, dtype=np.int64)

    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not (case & (1 << i))]
        sdf = np.where([case & (1 << i) for i in range(4)], -1.0, 1.0)
        # direction the normal should have: from inside centroid to outside
        want = canon[outside].mean(0) - canon[inside].mean(0)

        crossed = [
            (i, o) for i in inside for o in outside
        ]  # each (inside, outside) pair is a crossed edge

        def midpoint(i, o):
            t = (0.0 - sdf[i]) / (sdf[o] - sdf[i])
            return canon[i] + t * (canon[o] - canon[i])

        if len(crossed) == 3:
            pts = [midpoint(i, o) for i, o in crossed]
            tris = [(0, 1, 2)]
        else:  # 4 crossed edges: two inside (i,j), two outside (a,b)
            i, j = inside
            a, b = outside
            cycle = [(i, a), (i, b), (j, b), (j, a)]
            crossed = cycle
            pts = [midpoint(x, y) for x, y in cycle]
            tris = [(0, 1, 2), (0, 2, 3)]

        for t, (p, q, r) in enumerate(tris):
            n = np.cross(np.asarray(pts[q]) - pts[p], np.asarray(pts[r]) - pts[p])
            order = (p, q, r) if np.dot(n, want) > 0 else (p, r, q)
            tri_edges[case, t] = [edge_id[crossed[k]] for k in order]
        n_tris[case] = len(tris)

    return tri_edges, n_tris


_check_positive_orientation()
_TRI_EDGES, _N_TRIS = _build_case_table()

# Per (tetrahedron, tet edge) its two cube corners, ordered by global corner
# id: corner offsets compare lexicographically in (x, y, z) exactly as the
# ids (x ny + y) nz + z do once ny, nz >= 2 (the C++ walk's edge swap).
_EDGE_CORNERS = np.zeros((6, 6, 2), dtype=np.int64)
for _t in range(6):
    for _e, (_a, _b) in enumerate(_TET_EDGES):
        _ca, _cb = _TETS[_t, _a], _TETS[_t, _b]
        if tuple(_CUBE_CORNERS[_ca]) > tuple(_CUBE_CORNERS[_cb]):
            _ca, _cb = _cb, _ca
        _EDGE_CORNERS[_t, _e] = (_ca, _cb)

# A cube's triangles by its 8 corners' "below the level" bits (corner k at
# bit k): their count (0 exactly for the inactive cubes, all corners below
# or none) and, in the C++ order (tetrahedron, then triangle), each edge's
# two cube corners ordered by global corner id as ca | cb << 3 (12
# triangles at most; unused entries 0).
_CUBE_TRIS = np.zeros(256, dtype=np.int64)
_CUBE_TRI_CORNERS = np.zeros((256, 12, 3), dtype=np.uint8)
for _lo in range(256):
    for _t, _tet in enumerate(_TETS):
        _case = sum(((_lo >> int(c)) & 1) << i for i, c in enumerate(_tet))
        for _k in range(_N_TRIS[_case]):
            for _e in range(3):
                _ca, _cb = _EDGE_CORNERS[_t, _TRI_EDGES[_case, _k, _e]]
                _CUBE_TRI_CORNERS[_lo, _CUBE_TRIS[_lo], _e] = _ca | _cb << 3
            _CUBE_TRIS[_lo] += 1

_TILE_ROWS = 8  # cube rows (y) per tile of kernel M (kRows in marching_tets.cu)
_WORD = 32  # cubes (z) per word of M1's counts
_EMPTY_SLOT = 2 ** 31 - 1  # a free slot of M2's table (kEmpty)


def _f32(x) -> float:
    return float(np.float32(x))


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add), for
    float32 ``a`` and float32-exact ``b``, ``c``: the product is exact in
    float64, the sum rounded to odd there (a TwoSum error term decides the
    sticky bit), and the cast to float32 then rounds as one rounding would."""
    p = a.to(torch.float64) * b
    s = p + c
    bp = s - c
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, np.inf), torch.full_like(s, -np.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def _llround(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero of a non-negative float64 tensor -> int64
    (C's ``llround``; ``x - floor(x)`` is exact)."""
    r = torch.floor(x)
    return (r + ((x - r) >= 0.5).to(torch.float64)).to(torch.int64)


def _placement(origin, spacing):
    """(origin, spacing) as the float32 numbers the C++ walk receives."""
    return tuple(_f32(o) for o in origin), tuple(_f32(s) for s in spacing)


def _empty(device):
    return (torch.zeros((0, 3), dtype=torch.float32, device=device),
            torch.zeros((0, 3), dtype=torch.int64, device=device))


def _key_firsts(keys: torch.Tensor):
    """(first emission of each distinct key [U] int64, each emission's key
    index [E])."""
    uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
    first = torch.full((uniq.shape[0],), keys.shape[0], dtype=torch.int64, device=keys.device)
    first.scatter_reduce_(0, inverse, torch.arange(keys.shape[0], device=keys.device),
                          reduce="amin")
    return first, inverse


def weld(verts: torch.Tensor, keys: torch.Tensor, degenerate: torch.Tensor):
    """Emitted vertices -> a welded mesh: vertices [E, 3] (world, in
    emission order, three per triangle), their keys [E, 3] int64 and the
    triangles' degenerate flags [T] -> (vertices [V, 3], faces [F, 3]
    int64). A vertex is numbered by the first emission of its key and takes
    that emission's position (the C++ ``Welder``); degenerate faces are
    dropped, their vertices kept."""
    if keys.shape[0] == 0:
        return _empty(verts.device)
    first, inverse = _key_firsts(keys)
    order = torch.argsort(first)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    faces = rank[inverse].reshape(-1, 3)[~degenerate.to(torch.bool)]
    return verts[first[order]], faces


def weld_first(verts: torch.Tensor, first: torch.Tensor, degenerate: torch.Tensor,
               overflow: torch.Tensor):
    """The welded mesh from each emission's first emission of its key
    (``first`` [E] int32, as M2's table leaves it) and M2's overflow flag
    ([1] int32): the same (vertices, faces) as :func:`weld`, by a
    cumulative sum and gathers over the emissions, with no sort. One host
    read fetches the flag and the two counts, which size the selections;
    raises if the flag is set."""
    if first.shape[0] == 0:
        return _empty(verts.device)
    is_first = first == torch.arange(first.shape[0], dtype=first.dtype, device=first.device)
    number = torch.cumsum(is_first, 0) - 1  # a first emission's vertex number
    kept = ~degenerate.to(torch.bool)
    nv, nf, full = torch.stack([number[-1] + 1, kept.sum(), overflow[0].to(torch.int64)]).tolist()
    if full:
        raise RuntimeError(f"marching tetrahedra (kernel M2): the weld table is full (a key "
                           f"of the {first.shape[0]} emitted vertices found no slot)")
    faces = number.index_select(0, first).reshape(-1, 3)
    return (verts.index_select(0, torch.nonzero_static(is_first, size=nv).squeeze(1)),
            faces.index_select(0, torch.nonzero_static(kept, size=nf).squeeze(1)))


# ---------------------------------------------------------------------------
# The plain version of kernel M
# ---------------------------------------------------------------------------

def _slab_emit(values, x0, x1, level_t, spacing, origin):
    """Triangles of the cubes with x in [x0, x1), in emission order ->
    (world [3T, 3] f32, keys [3T, 3] int64, degenerate [T] bool)."""
    dev = values.device
    ny, nz = values.shape[1], values.shape[2]
    cv = torch.stack([values[x0 + dx:x1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
                      for dx, dy, dz in _CUBE_CORNERS.tolist()], dim=-1)  # [X, Y, Z, 8]
    lo = cv < level_t
    active = lo.any(-1) & (~lo).any(-1)
    base = torch.nonzero(active)  # [A, 3], x-major
    if base.shape[0] == 0:
        return None
    base[:, 0] += x0
    cva, loa = cv[active], lo[active].to(torch.int64)  # [A, 8]
    tets = torch.from_numpy(_TETS).to(dev)
    case = (loa[:, tets] << torch.arange(4, device=dev)).sum(-1)  # [A, 6]
    ntri = torch.from_numpy(_N_TRIS).to(dev)[case]
    c_idx, t_idx, k_idx = torch.nonzero(torch.arange(2, device=dev) < ntri[..., None],
                                        as_tuple=True)  # (cube, tet, triangle) in order
    edges = torch.from_numpy(_TRI_EDGES).to(dev)[case[c_idx, t_idx], k_idx]  # [T, 3]
    ec = torch.from_numpy(_EDGE_CORNERS).to(dev)[t_idx[:, None], edges]  # [T, 3, 2]
    ca, cb = ec[..., 0], ec[..., 1]
    da = cva[c_idx[:, None], ca]
    db = cva[c_idx[:, None], cb]
    denom = db - da
    denom = torch.where(denom.abs() < _f32(1e-12), torch.full_like(denom, _f32(1e-12)), denom)
    w = torch.clamp((level_t - da) / denom, 0.0, 1.0)  # [T, 3]
    corners = torch.from_numpy(_CUBE_CORNERS).to(dev)
    pa = (base[c_idx][:, None, :] + corners[ca]).to(torch.float32)  # [T, 3, 3]
    diff = (corners[cb] - corners[ca]).to(torch.float32)
    g = (pa + w[..., None] * diff).reshape(-1, 3)  # grid units, w * diff exact
    keys = _llround(g.to(torch.float64) * 1e6)
    world = torch.stack([_fma_f32(g[:, a], spacing[a], origin[a]) for a in range(3)], dim=-1)
    k3 = keys.reshape(-1, 3, 3)
    same = lambda i, j: (k3[:, i] == k3[:, j]).all(-1)  # noqa: E731
    degenerate = same(0, 1) | same(1, 2) | same(0, 2)
    return world, keys, degenerate


def _slabs(nx: int, slab: int):
    return [(x0, min(x0 + slab, nx - 1)) for x0 in range(0, nx - 1, slab)]


def _tiling(shape):
    """(cube rows, words per row, tiles) of kernel M's tiling of a grid."""
    nx, ny, nz = shape
    if min(nx, ny, nz) < 2:
        return 0, 0, 0
    return ((nx - 1) * (ny - 1), -(-(nz - 1) // _WORD),
            (nx - 1) * -(-(ny - 1) // _TILE_ROWS))


def mt_count_plain(values: torch.Tensor, level: float, slab: int = 16):
    """Plain version of kernel M1: (word_tris [cube rows * words] int16, the
    triangles of each 32-cube word of each cube row (x-major), tile_tris
    [tiles] int32, those of each tile of _TILE_ROWS rows)."""
    values = values.to(torch.float32).contiguous()
    nx, ny, nz = values.shape
    dev = values.device
    _, words, _ = _tiling(values.shape)
    if words == 0:
        return (torch.zeros((0,), dtype=torch.int16, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    level_t = torch.tensor(_f32(level), dtype=torch.float32, device=dev)
    tets = torch.from_numpy(_TETS).to(dev)
    n_tris = torch.from_numpy(_N_TRIS).to(dev)
    groups = -(-(ny - 1) // _TILE_ROWS)
    word_parts, tile_parts = [], []
    for x0, x1 in _slabs(nx, slab):
        lo = torch.stack([values[x0 + dx:x1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz] < level_t
                          for dx, dy, dz in _CUBE_CORNERS.tolist()], dim=-1).to(torch.int64)
        case = (lo[..., tets] << torch.arange(4, device=dev)).sum(-1)  # [X, Y, Z, 6]
        counts = n_tris[case].sum(-1)  # [X, Y, Z]
        counts = torch.nn.functional.pad(counts, (0, words * _WORD - (nz - 1)))
        per_word = counts.reshape(x1 - x0, ny - 1, words, _WORD).sum(-1)
        word_parts.append(per_word.reshape(-1))
        per_row = torch.nn.functional.pad(per_word.sum(-1), (0, groups * _TILE_ROWS - (ny - 1)))
        tile_parts.append(per_row.reshape(x1 - x0, groups, _TILE_ROWS).sum(-1).reshape(-1))
    return torch.cat(word_parts).to(torch.int16), torch.cat(tile_parts).to(torch.int32)


def mt_emit_plain(values: torch.Tensor, level: float, origin, spacing, slab: int = 16):
    """Plain version of kernel M2 (without M1's inputs): every triangle in
    emission order -> (world [3T, 3] float32, keys [3T, 3] int64,
    degenerate [T] bool)."""
    values = values.to(torch.float32).contiguous()
    nx, ny, nz = values.shape
    dev = values.device
    origin, spacing = _placement(origin, spacing)
    level_t = torch.tensor(_f32(level), dtype=torch.float32, device=dev)
    parts = [] if min(nx, ny, nz) < 2 else [
        _slab_emit(values, x0, x1, level_t, spacing, origin) for x0, x1 in _slabs(nx, slab)]
    parts = [p for p in parts if p is not None]
    if not parts:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    return tuple(torch.cat(t) for t in zip(*parts))


def mt_first_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain version of what M2's table leaves: each emission's first
    emission of its key, [E] int32."""
    if keys.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=keys.device)
    first, inverse = _key_firsts(keys)
    return first[inverse].to(torch.int32)


def marching_tetrahedra_plain(values: torch.Tensor, level: float = 0.0,
                              origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0),
                              slab: int = 16):
    """Plain version of kernel M and the welding: the cubes in slabs of
    ``slab`` x-layers, each slab's triangles in emission order."""
    return weld(*mt_emit_plain(values, level, origin, spacing, slab))


# ---------------------------------------------------------------------------
# Kernel M on the card
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def _case_table(device):
    """(cube_tris [256] int32, cube_tri_corners [256 * 12 * 3] uint8) on
    ``device``, made once."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (torch.from_numpy(_CUBE_TRIS.astype(np.int32)).to(device),
                        torch.from_numpy(_CUBE_TRI_CORNERS.reshape(-1)).to(device))
    return _TABLES[key]


def _check_grid(values):
    if values.dtype != torch.float32 or values.dim() != 3 or not values.is_contiguous():
        raise ValueError("marching tetrahedra: values must be a contiguous [nx, ny, nz] "
                         "float32 tensor")
    if max(values.shape) >= 2 ** 31:
        raise ValueError("marching tetrahedra: grid dimensions must fit in int32")


def mt_count_cuda(values: torch.Tensor, level: float):
    """Kernel M1 launch: (word_tris [cube rows * words] int16, tile_tris
    [tiles] int32), as :func:`mt_count_plain`. Counts launches in
    ``mt_count_cuda.launches``."""
    _check_grid(values)
    nx, ny, nz = values.shape
    dev = values.device
    rows, words, tiles = _tiling(values.shape)
    word_tris = torch.empty((rows * words,), dtype=torch.int16, device=dev)
    tile_tris = torch.empty((tiles,), dtype=torch.int32, device=dev)
    cube_tris = _case_table(dev)[0]
    lib = kernels.load("marching_tets")
    err = lib.psdf_mt_count(kernels.ptr(values), nx, ny, nz, _f32(level), kernels.ptr(cube_tris),
                            kernels.ptr(word_tris), kernels.ptr(tile_tris),
                            kernels.current_stream(dev))
    kernels.check(lib, err, "marching tetrahedra count (kernel M1)")
    if tiles:
        mt_count_cuda.launches += 1
    return word_tris, tile_tris


mt_count_cuda.launches = 0


def table_slots(nr_tris: int) -> int:
    """M2's hash table size for ``nr_tris`` triangles: the power of two at
    or above two slots per emitted vertex, so at most half of it is used."""
    return 1 << max(6 * nr_tris - 1, 1).bit_length()


def mt_emit_cuda(values: torch.Tensor, level: float, word_tris: torch.Tensor,
                 tile_tris: torch.Tensor, tile_offsets: torch.Tensor, nr_tris: int, origin,
                 spacing):
    """Kernel M2 launch: the ``nr_tris`` triangles that M1 counted ->
    (world [3T, 3] float32, keys [3T, 3] int64, degenerate [T] bool, first
    [3T] int32, overflow [1] int32), in the C++ walk's emission order;
    ``first`` is each emission's first emission of its key
    (:func:`mt_first_plain`), read from the hash table of
    :func:`table_slots` int32 slots after M2. ``tile_offsets`` [tiles]
    int64 is the exclusive sum of M1's tile totals. ``overflow`` is set if
    a key found no slot; at two slots per emitted vertex a full turn of the
    table always finds one, and :func:`weld_first` reads the flag with its
    counts. Counts launches in ``mt_emit_cuda.launches``."""
    _check_grid(values)
    nx, ny, nz = values.shape
    dev = values.device
    if (word_tris.dtype != torch.int16 or tile_tris.dtype != torch.int32
            or tile_offsets.dtype != torch.int64):
        raise ValueError("marching tetrahedra: int16 word counts, int32 tile counts and "
                         "int64 tile offsets")
    E = 3 * nr_tris
    if E >= _EMPTY_SLOT:
        raise ValueError(f"marching tetrahedra: {nr_tris} triangles exceed the int32 "
                         "emission ids of the weld table")
    slots = table_slots(nr_tris)
    origin, spacing = _placement(origin, spacing)
    verts = torch.empty((E, 3), dtype=torch.float32, device=dev)
    keys = torch.empty((E, 3), dtype=torch.int64, device=dev)
    degenerate = torch.empty((nr_tris,), dtype=torch.uint8, device=dev)
    table = torch.full((slots,), _EMPTY_SLOT, dtype=torch.int32, device=dev)
    slot_of = torch.empty((E,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    cube_tris, cube_tri_corners = _case_table(dev)
    lib = kernels.load("marching_tets")
    err = lib.psdf_mt_emit(kernels.ptr(values), nx, ny, nz, _f32(level), kernels.ptr(cube_tris),
                           kernels.ptr(cube_tri_corners), kernels.ptr(word_tris),
                           kernels.ptr(tile_tris), kernels.ptr(tile_offsets), *origin, *spacing,
                           kernels.ptr(verts), kernels.ptr(keys), kernels.ptr(degenerate),
                           kernels.ptr(table), slots, kernels.ptr(slot_of),
                           kernels.ptr(overflow), kernels.current_stream(dev))
    kernels.check(lib, err, "marching tetrahedra emit (kernel M2)")
    mt_emit_cuda.launches += 1
    return verts, keys, degenerate.to(torch.bool), table.index_select(0, slot_of), overflow


mt_emit_cuda.launches = 0


def mt_offsets(tile_tris: torch.Tensor):
    """M1's tile totals -> (exclusive tile offsets [tiles] int64, the
    number of triangles). Reading the total synchronises with the host."""
    incl = torch.cumsum(tile_tris, 0, dtype=torch.int64)
    nr_tris = int(incl[-1]) if incl.numel() else 0
    return incl - tile_tris, nr_tris


def marching_tetrahedra_cuda(values: torch.Tensor, level: float = 0.0,
                             origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
    """Kernel M: M1, the tile offsets (a host read of the triangle total),
    M2 with the weld table, then the ranking of the first emissions
    (:func:`weld_first`, a second host read)."""
    values = values.to(torch.float32).contiguous()
    word_tris, tile_tris = mt_count_cuda(values, level)
    tile_offsets, nr_tris = mt_offsets(tile_tris)
    if nr_tris == 0:
        return _empty(values.device)
    world, _, degenerate, first, overflow = mt_emit_cuda(values, level, word_tris, tile_tris,
                                                         tile_offsets, nr_tris, origin, spacing)
    return weld_first(world, first, degenerate, overflow)


def marching_tetrahedra(values: torch.Tensor, level: float = 0.0,
                        origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
    """Extract the ``level`` isosurface of a dense scalar grid.

    Args:
      values: [Nx, Ny, Nz] scalar field (SDF convention: negative inside).
      origin / spacing: world placement of grid node (0,0,0) and node pitch.

    Returns:
      (vertices [V, 3] float32, faces [F, 3] int64) on the grid's device:
      welded, outward normals toward positive values.
    """
    fn = kernels.dispatch(values.device, marching_tetrahedra_cuda, marching_tetrahedra_plain)
    return fn(values, level, origin, spacing)


# ---------------------------------------------------------------------------
# The grid SDF and the extractor
# ---------------------------------------------------------------------------

def sdf_grid(sdf_fn: Callable[[torch.Tensor], torch.Tensor], nr_points_per_dim: int,
             min_val: float, max_val: float, block: int = 64, device=None) -> torch.Tensor:
    """The SDF at the grid's nodes, [n, n, n] float32 on ``device``.

    ``sdf_fn`` maps [N, 3] points -> [N, 1] (or [N]) SDF values and is
    called on ``block``-sized sub-grids under ``torch.no_grad``. Each block
    is clipped to +-0.25 (max - min), rounded to int16 at 32766 / clip and
    scaled back, as the JAX package does: the mesh is a function of that
    quantized grid."""
    device = resolve_device(device)
    n = nr_points_per_dim
    axis = torch.from_numpy(np.linspace(min_val, max_val, n, dtype=np.float32)).to(device)
    full = torch.empty((n, n, n), dtype=torch.float32, device=device)
    clip_r = 0.25 * (max_val - min_val)
    q_scale = 32766.0 / clip_r
    # a tensor divisor: a Python scalar one lets CUDA multiply by its reciprocal
    q_div = torch.tensor(_f32(q_scale), dtype=torch.float32, device=device)
    with torch.no_grad():
        for xi in range(0, n, block):
            xs = axis[xi:xi + block]
            for yi in range(0, n, block):
                ys = axis[yi:yi + block]
                for zi in range(0, n, block):
                    zs = axis[zi:zi + block]
                    pts = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"), dim=-1)
                    s = sdf_fn(pts.reshape(-1, 3)).reshape(-1)
                    q = torch.round(torch.clamp(s, -clip_r, clip_r) * q_scale).to(torch.int16)
                    full[xi:xi + len(xs), yi:yi + len(ys), zi:zi + len(zs)] = (
                        q.to(torch.float32) / q_div).reshape(len(xs), len(ys), len(zs))
    return full


def extract_mesh_from_sdf_fn(
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    nr_points_per_dim: int,
    min_val: float,
    max_val: float,
    threshold: float = 0.0,
    block: int = 64,
    device=None,
):
    """Chunked SDF evaluation (:func:`sdf_grid`) + isosurface extraction
    (:func:`marching_tetrahedra`), the grid kept on ``device`` (None means
    the GPU) -> (vertices [V, 3] float32, faces [F, 3] int64) there."""
    full = sdf_grid(sdf_fn, nr_points_per_dim, min_val, max_val, block, device)
    spacing = (max_val - min_val) / (nr_points_per_dim - 1.0)
    return marching_tetrahedra(full, level=threshold, origin=(min_val,) * 3,
                               spacing=(spacing,) * 3)
