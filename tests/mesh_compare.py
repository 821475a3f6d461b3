"""The gate that holds a mesh of the port's marching tetrahedra to the numpy
oracle's (`slide_tpu_torch/sap/marching.py::marching_tetrahedra_numpy`):
the same faces with the same winding, vertices within 1e-4 grid units and
unit normals within 1e-5.  It imports neither JAX nor the package, so the
CPU tests, the card tests and `chip_smoke.py` share it."""

import numpy as np

MESH_VERT_ATOL = 1e-4
MESH_NORMAL_ATOL = 1e-5


def oriented_faces(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """The faces as rows of their three corners' positions (rounded to 1e-4),
    each row rotated to its least rotation and the rows sorted: two meshes
    with the same faces give the same array, whatever their vertex order,
    and a face with its corners reversed gives another row."""
    corners = np.round(verts[faces], 4)                               # (F, 3, 3)
    _, rank = np.unique(corners.reshape(-1, 3), axis=0, return_inverse=True)
    rank = rank.reshape(-1, 3).astype(np.int64)
    m = int(rank.max()) + 1 if rank.size else 1
    rots = np.stack([np.roll(rank, -k, axis=1) for k in range(3)], axis=1)  # (F, 3, 3)
    key = (rots[..., 0] * m + rots[..., 1]) * m + rots[..., 2]
    first = np.argmin(key, axis=1)
    order = (first[:, None] + np.arange(3)) % 3
    rows = np.take_along_axis(corners, order[..., None], axis=1).reshape(len(faces), 9)
    return rows[np.lexsort(rows.T[::-1])]


def mesh_difference(got, want, scale: float = 1.0) -> dict:
    """How far the mesh `got` (its vertices times `scale`) lies from `want`,
    each (verts, faces, normals): whether they have the same sizes and the
    same oriented faces (`oriented_faces`), and the largest vertex and
    normal differences with both sorted by position."""
    (v2, f2, n2), (v1, f1, n1) = got, want
    v2 = v2 * scale
    if v1.shape != v2.shape or f1.shape != f2.shape:
        return {"same_sizes": False, "same_faces": False, "verts": [len(v2), len(v1)],
                "faces": [len(f2), len(f1)]}
    o1, o2 = np.lexsort(v1.T), np.lexsort(v2.T)
    return {"same_sizes": True,
            "same_faces": bool(np.array_equal(oriented_faces(v1, f1), oriented_faces(v2, f2))),
            "vert_err": float(np.abs(v2[o2] - v1[o1]).max()),
            "normal_err": float(np.abs(n2[o2] - n1[o1]).max()),
            "verts": len(v1), "faces": len(f1)}


def assert_same_mesh(got, want, scale=1.0):
    """`mesh_difference` within the gate: the same oriented faces, vertices
    (times `scale`, in grid units) within 1e-4 and normals within 1e-5."""
    diff = mesh_difference(got, want, scale)
    assert diff["same_sizes"] and diff["same_faces"], diff
    assert diff["vert_err"] <= MESH_VERT_ATOL and diff["normal_err"] <= MESH_NORMAL_ATOL, diff
