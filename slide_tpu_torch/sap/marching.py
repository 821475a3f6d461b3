"""Iso-surface extraction on the host, in numpy (counterpart:
`slide_tpu/sap/marching.py`): marching tetrahedra.  Each grid cube is split
into 6 tetrahedra; every tetrahedron contributes 0-2 triangles fixed by its
16 sign configurations.  Output: vertices on grid edges (deduplicated),
faces, and per-vertex normals from the negated field gradient.

`marching_tetrahedra_numpy` is the oracle that the card's extraction
(`marching_gpu.py`) is held to.  `marching_tetrahedra` runs the native
C++ pass (`native/marching.cpp`, a copy of the JAX package's, built with
g++ at first use by `_build.load_host_library`): the same content in
another vertex and face order.  It takes the numpy route only where the
native pass's dedup table (28 bytes a voxel) would pass 1 GiB, or where the
caller asks (`native=False`); a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from slide_tpu_torch import _build

# the native pass's perfect-dedup table: 28 bytes a voxel (59 MB at 128^3,
# 3.8 GB at 512^3); above this the numpy route runs
NATIVE_TABLE_LIMIT = 1 << 30

# cube corner offsets, standard numbering
_CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int64)

# 6-tetrahedra decomposition around the 0-6 diagonal
_TETS = np.array([
    (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
    (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)], np.int64)

# tetrahedron edges by local vertex pair
_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], np.int64)

# case table: inside-bitmask -> list of triangles, each a triple of edge ids.
# Winding is normalized afterwards against the field gradient.
_CASES: dict[int, list[tuple[int, int, int]]] = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 4, 3)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 5, 4)],
    0b1110: [(0, 2, 1)],
    0b1101: [(0, 3, 4)],
    0b1011: [(1, 5, 3)],
    0b0111: [(2, 4, 5)],
    0b0011: [(1, 3, 4), (1, 4, 2)],
    0b1100: [(1, 4, 3), (1, 2, 4)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b1010: [(0, 5, 3), (0, 2, 5)],
    0b0110: [(0, 4, 5), (0, 5, 1)],
    0b1001: [(0, 5, 4), (0, 1, 5)],
}


@functools.cache
def native_library() -> ctypes.CDLL:
    """The native pass, built at first use; raises when the build fails."""
    lib = _build.load_host_library("marching")
    p = ctypes.c_void_p
    lib.mt_run.restype = p
    lib.mt_run.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float]
    lib.mt_num_verts.restype = ctypes.c_int64
    lib.mt_num_verts.argtypes = [p]
    lib.mt_num_faces.restype = ctypes.c_int64
    lib.mt_num_faces.argtypes = [p]
    lib.mt_copy.restype = None
    lib.mt_copy.argtypes = [p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                            ctypes.POINTER(ctypes.c_float)]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [p]
    return lib


def marching_tetrahedra_native(vol: np.ndarray, level: float = 0.0):
    """The native pass (`marching_tetrahedra`'s contract)."""
    lib = native_library()
    vol = np.ascontiguousarray(vol, np.float32)
    r0, r1, r2 = vol.shape
    h = lib.mt_run(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), r0, r1, r2,
                   ctypes.c_float(level))
    if not h:
        raise ValueError("level surface is empty")
    try:
        nv, nf = lib.mt_num_verts(h), lib.mt_num_faces(h)
        verts = np.empty((nv, 3), np.float32)
        faces = np.empty((nf, 3), np.int64)
        normals = np.empty((nv, 3), np.float32)
        lib.mt_copy(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    normals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    finally:
        lib.mt_free(h)
    return verts, faces, normals


def _takes_native(n_voxels: int, native: bool) -> bool:
    return native and n_voxels * 28 <= NATIVE_TABLE_LIMIT


def marching_tetrahedra(vol: np.ndarray, level: float = 0.0, native: bool = True):
    """Extract the `level` iso-surface of a (r0, r1, r2) scalar field.

    Returns (verts (V, 3) in grid-index coordinates, faces (F, 3) int,
    normals (V, 3) unit, = -grad field).  Raises ValueError if the surface
    is empty.  The native pass runs unless `native` is False or its dedup
    table would pass NATIVE_TABLE_LIMIT; the numpy route gives the same
    content in another order."""
    if _takes_native(int(np.prod(np.shape(vol))), native):
        return marching_tetrahedra_native(vol, level)
    return marching_tetrahedra_numpy(vol, level)


def marching_tetrahedra_numpy(vol: np.ndarray, level: float = 0.0):
    """The numpy implementation (see the module docstring)."""
    vol = np.asarray(vol, np.float32)
    r0, r1, r2 = vol.shape
    # prefilter: only cubes whose corners straddle the level contribute
    # triangles (a ~100x reduction at 128^3 — without this the host pass takes
    # seconds per grid)
    inside_count = np.zeros((r0 - 1, r1 - 1, r2 - 1), np.int8)
    for dx, dy, dz in _CORNERS:
        inside_count += (vol[dx:r0 - 1 + dx, dy:r1 - 1 + dy,
                             dz:r2 - 1 + dz] > level)
    crossing = (inside_count > 0) & (inside_count < 8)
    bx, by, bz = np.nonzero(crossing)
    base = np.stack([bx, by, bz], axis=-1)                        # (C, 3)
    corner_idx = base[:, None, :] + _CORNERS[None, :, :]          # (C, 8, 3)
    lin = (corner_idx[..., 0] * (r1 * r2) + corner_idx[..., 1] * r2
           + corner_idx[..., 2])                                  # (C, 8)
    flat = vol.reshape(-1)

    tet_vid = lin[:, _TETS].reshape(-1, 4)                        # (T, 4)
    tet_val = flat[tet_vid]                                       # (T, 4)
    inside = tet_val > level
    case = (inside * np.array([1, 2, 4, 8])).sum(axis=1)          # (T,)

    tri_edge_v0 = []   # global vertex id of each triangle corner's edge start
    tri_edge_v1 = []
    for code, tris in _CASES.items():
        sel = np.nonzero(case == code)[0]
        if sel.size == 0:
            continue
        vids = tet_vid[sel]                                       # (S, 4)
        for tri in tris:
            e = _EDGES[list(tri)]                                 # (3, 2) local
            tri_edge_v0.append(vids[:, e[:, 0]])                  # (S, 3)
            tri_edge_v1.append(vids[:, e[:, 1]])
    if not tri_edge_v0:
        raise ValueError("level surface is empty")
    ev0 = np.concatenate(tri_edge_v0, axis=0)                     # (F, 3)
    ev1 = np.concatenate(tri_edge_v1, axis=0)

    # deduplicate edge-vertices: key = sorted global id pair
    lo = np.minimum(ev0, ev1).reshape(-1)
    hi = np.maximum(ev0, ev1).reshape(-1)
    keys = lo * (r0 * r1 * r2) + hi
    uniq, faces_flat = np.unique(keys, return_inverse=True)
    faces = faces_flat.reshape(-1, 3)
    u_lo = (uniq // (r0 * r1 * r2)).astype(np.int64)
    u_hi = (uniq % (r0 * r1 * r2)).astype(np.int64)

    def unflatten(ids):
        return np.stack([ids // (r1 * r2), (ids // r2) % r1, ids % r2], -1)

    p0 = unflatten(u_lo).astype(np.float32)
    p1 = unflatten(u_hi).astype(np.float32)
    v0 = flat[u_lo]
    v1 = flat[u_hi]
    t = (level - v0) / np.where(np.abs(v1 - v0) < 1e-12, 1e-12, v1 - v0)
    t = np.clip(t, 0.0, 1.0)
    verts = p0 + t[:, None] * (p1 - p0)                           # (V, 3)

    # drop degenerate faces (triangles with repeated vertices)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[good]

    # vertex normals: negated trilinear-interpolated central-difference gradient
    grad = np.stack(np.gradient(vol), axis=-1)                    # (r0,r1,r2,3)
    vi = np.clip(np.round(verts).astype(np.int64), 0,
                 [r0 - 1, r1 - 1, r2 - 1])
    normals = -grad[vi[:, 0], vi[:, 1], vi[:, 2]]
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(norm < 1e-12, 1.0, norm)

    # consistent winding: face normal should agree with the vertex normals
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    ref = (normals[faces[:, 0]] + normals[faces[:, 1]] + normals[faces[:, 2]])
    flip = np.sum(fn * ref, axis=1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    return verts, faces, normals


def mc_from_psr(psr_grid, real_scale: bool = False, zero_level: float = 0.0,
                num_threads: int = 0, native: bool = True):
    """Batch iso-surface extraction from a (B, r, r, r) PSR grid, vertices
    scaled to [0, 1) (or [0, 1] with real_scale).  Returns (list of verts,
    list of faces, list of normals); an empty surface yields empty arrays
    for that element when batched (a lone element still raises).
    num_threads > 1 extracts the batch's elements on a thread pool (the
    native pass and numpy's hot operations release the GIL)."""
    grid = np.asarray(psr_grid)
    s = grid.shape[-1]

    def one(i):
        try:
            v, f, n = marching_tetrahedra(grid[i], level=zero_level, native=native)
        except ValueError:
            if grid.shape[0] == 1:
                raise
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                    np.zeros((0, 3), np.float32))
        v = v / (s - 1) if real_scale else v / s
        return v.astype(np.float32), f, n.astype(np.float32)

    if num_threads > 1 and grid.shape[0] > 1:
        if _takes_native(grid[0].size, native):
            native_library()            # built once, before the workers start
        with ThreadPoolExecutor(num_threads) as pool:
            results = list(pool.map(one, range(grid.shape[0])))
    else:
        results = [one(i) for i in range(grid.shape[0])]
    return ([r[0] for r in results], [r[1] for r in results],
            [r[2] for r in results])
