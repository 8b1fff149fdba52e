"""Minimal mesh IO + surface sampling, numpy only (counterpart of
``permuto_sdf_tpu/datasets/mesh_io.py``, copied because importing that
module runs the JAX package's ``__init__``, which imports JAX).

Load/save OBJ, area-weighted surface sampling with interpolated normals
(the same ``np.random.Generator`` calls, so a seed gives the JAX package's
points), normalization into the bounding primitive, plus analytic test
meshes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    V: np.ndarray  # [n, 3] float32 vertices
    F: np.ndarray  # [m, 3] int64 faces
    NV: np.ndarray | None = None  # [n, 3] per-vertex normals

    def with_normals(self) -> "Mesh":
        if self.NV is None:
            self.NV = compute_vertex_normals(self.V, self.F)
        return self


def load_obj(path: str) -> Mesh:
    verts, faces, normals = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [tok.split("/")[0] for tok in line.split()[1:]]
                idx = [int(i) - 1 for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    V = np.asarray(verts, dtype=np.float32)
    F = np.asarray(faces, dtype=np.int64)
    NV = np.asarray(normals, dtype=np.float32) if len(normals) == len(verts) else None
    return Mesh(V, F, NV)


def save_obj(path: str, mesh: Mesh):
    with open(path, "w") as f:
        for v in mesh.V:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if mesh.NV is not None:
            for n in mesh.NV:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for face in mesh.F + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def compute_vertex_normals(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])  # area-weighted
    NV = np.zeros_like(V)
    for k in range(3):
        np.add.at(NV, F[:, k], fn)
    norm = np.linalg.norm(NV, axis=-1, keepdims=True)
    return (NV / np.where(norm < 1e-12, 1.0, norm)).astype(np.float32)


def sample_points_on_mesh(mesh: Mesh, nr_points: int, rng: np.random.Generator):
    """Area-weighted surface sampling -> (points [n,3], normals [n,3])."""
    mesh = mesh.with_normals()
    V, F, NV = mesh.V, mesh.F, mesh.NV
    e1 = V[F[:, 1]] - V[F[:, 0]]
    e2 = V[F[:, 2]] - V[F[:, 0]]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    probs = areas / areas.sum()
    fidx = rng.choice(len(F), size=nr_points, p=probs)
    u = rng.random(nr_points)
    v = rng.random(nr_points)
    flip = u + v > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    w = 1.0 - u - v
    bary = np.stack([w, u, v], axis=-1)[..., None]  # [n, 3, 1]
    pts = (V[F[fidx]] * bary).sum(1)
    normals = (NV[F[fidx]] * bary).sum(1)
    nrm = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.where(nrm < 1e-12, 1.0, nrm)
    return pts.astype(np.float32), normals.astype(np.float32)


def normalize_mesh_to_unit_sphere(mesh: Mesh, radius: float = 0.3) -> Mesh:
    """Center at origin and scale so the mesh fits a sphere of ``radius``
    (mirrors the reference's practice of keeping the scene inside the
    [-0.5, 0.5] bounding primitive)."""
    c = (mesh.V.max(0) + mesh.V.min(0)) / 2.0
    V = mesh.V - c
    scale = radius / np.abs(np.linalg.norm(V, axis=-1)).max()
    return Mesh((V * scale).astype(np.float32), mesh.F, mesh.NV)


def make_uv_sphere(radius: float = 0.3, n_lat: int = 32, n_lon: int = 64) -> Mesh:
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts, faces = [], []
    for i, th in enumerate(lat):
        for j, ph in enumerate(lon):
            verts.append(
                [
                    radius * np.sin(th) * np.cos(ph),
                    radius * np.sin(th) * np.sin(ph),
                    radius * np.cos(th),
                ]
            )

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            faces.append([a, b, c])
            faces.append([a, c, d])
    V = np.asarray(verts, dtype=np.float32)
    F = np.asarray(faces, dtype=np.int64)
    NV = V / np.linalg.norm(V, axis=-1, keepdims=True)
    return Mesh(V, F, NV.astype(np.float32))


def make_torus(R: float = 0.25, r: float = 0.1, n_u: int = 48, n_v: int = 24) -> Mesh:
    us = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    verts, normals, faces = [], [], []
    for i, u in enumerate(us):
        for j, v in enumerate(vs):
            cx, cy = R * np.cos(u), R * np.sin(u)
            verts.append(
                [
                    (R + r * np.cos(v)) * np.cos(u),
                    (R + r * np.cos(v)) * np.sin(u),
                    r * np.sin(v),
                ]
            )
            normals.append(
                [np.cos(v) * np.cos(u), np.cos(v) * np.sin(u), np.sin(v)]
            )

    def vid(i, j):
        return (i % n_u) * n_v + (j % n_v)

    for i in range(n_u):
        for j in range(n_v):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            faces.append([a, b, c])
            faces.append([a, c, d])
    return Mesh(
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int64),
        np.asarray(normals, np.float32),
    )
