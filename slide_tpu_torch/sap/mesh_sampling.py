"""Point sampling from triangle meshes on the host, in numpy (counterpart:
`slide_tpu/sap/mesh_sampling.py`): area-weighted triangle selection and
uniform barycentric coordinates, normals = face normals; plus the
dense-then-FPS "uniform" resampling variant."""

from __future__ import annotations

import numpy as np


def sample_points_from_mesh(verts: np.ndarray, faces: np.ndarray,
                            num_samples: int,
                            rng: np.random.Generator | None = None):
    """Returns (points (num_samples, 3), normals (num_samples, 3))."""
    rng = rng or np.random.default_rng()
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    probs = area / total
    sel = rng.choice(len(faces), size=num_samples, p=probs)
    # uniform barycentric sampling: u,v ~ U(0,1), fold the triangle
    u = rng.random(num_samples)
    v = rng.random(num_samples)
    over = u + v > 1.0
    u[over] = 1.0 - u[over]
    v[over] = 1.0 - v[over]
    w = 1.0 - u - v
    pts = (w[:, None] * v0[sel] + u[:, None] * v1[sel] + v[:, None] * v2[sel])
    n = cross[sel]
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.where(norm < 1e-12, 1.0, norm)
    return pts.astype(np.float32), n.astype(np.float32)


def fps_numpy(points: np.ndarray, k: int, start: int = 0) -> np.ndarray:
    """Host FPS for the uniform resampling path (the semantics of
    `ops/fps.py::furthest_point_sample`)."""
    n = points.shape[0]
    min_d = np.full((n,), np.inf)
    sel = np.empty(k, np.int64)
    sel[0] = start
    for i in range(1, k):
        d = np.sum((points - points[sel[i - 1]]) ** 2, axis=-1)
        np.minimum(min_d, d, out=min_d)
        sel[i] = int(np.argmax(min_d))
    return sel


def uniform_sample_points_from_mesh(verts, faces, num_samples: int,
                                    dense_factor: int = 10,
                                    rng: np.random.Generator | None = None):
    """Sample dense_factor * num_samples points, then FPS down to
    num_samples."""
    rng = rng or np.random.default_rng()
    dense_p, dense_n = sample_points_from_mesh(verts, faces,
                                               num_samples * dense_factor, rng)
    start = int(rng.integers(0, len(dense_p)))
    idx = fps_numpy(dense_p, num_samples, start=start)
    return dense_p[idx], dense_n[idx]
