"""Marching tetrahedra and mesh sampling on the card (counterpart:
`slide_tpu/sap/marching_tpu.py`): the same 6-tetrahedra decomposition, case
tables, vertex and normal arithmetic as the numpy oracle
`marching.py::marching_tetrahedra_numpy`, run on the grid's device (a CPU
tensor runs the same code on the CPU).

Design:
  - The active cells (corners straddling the level) and the emitted
    triangles are compacted with `torch.nonzero` at their true sizes, over
    the whole batch at once: cells and triangles come out sample by sample,
    in the oracle's order.
  - A cell's 6 tetrahedra look up their case (the inside-corner bitmask)
    in small indexed tables: the triangle count min(k, 4 - k), k the
    inside-corner count, and the canonical edge keys of each triangle.
  - Triangles carry per-corner geometry (position, unit normal) and a
    canonical edge key, (base grid vertex) * 7 + (positive offset class),
    so that the host's dedup (`mesh_to_host`) reproduces the oracle's
    vertex set exactly; sampling needs no dedup.

The one deliberate difference from the JAX interface: there are no budgets
(`f_max`, `c_max`, the bucket ladders), because PyTorch has no static shapes
to pad to.  So nothing overflows, `n_faces` and `n_cells` are the true
counts, and `extract_and_sample_device` returns the batch's mesh where the
JAX function returns its overflow flag.
"""

from __future__ import annotations

import numpy as np
import torch

from slide_tpu_torch.sap.marching import _CASES, _CORNERS, _EDGES, _TETS

# the 7 canonical positive edge-offset classes (axis x3, face diagonal x3, body)
_CLASS_OFFSETS = np.array([
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)], np.int64)


def _build_tables():
    """TRI[case, k, j]  local tet-edge id of corner j of the k-th triangle
                         (0 where the case has fewer triangles)
    EBASE[tet, edge]     local cube corner of the edge's canonical base
    ECLS[tet, edge]      its offset class (0..6)"""
    tri = np.zeros((16, 2, 3), np.int64)
    for case, tris in _CASES.items():
        for k, t in enumerate(tris):
            tri[case, k] = t
    ebase = np.zeros((6, 6), np.int64)
    ecls = np.zeros((6, 6), np.int64)
    cls_of = {tuple(o): i for i, o in enumerate(_CLASS_OFFSETS)}
    for t in range(6):
        for e in range(6):
            a, b = _TETS[t][_EDGES[e][0]], _TETS[t][_EDGES[e][1]]
            ca, cb = _CORNERS[a], _CORNERS[b]
            if np.all(cb - ca >= 0):
                base, off = a, tuple(cb - ca)
            else:                                  # every tet edge is one way or the other
                base, off = b, tuple(ca - cb)
            ebase[t, e] = base
            ecls[t, e] = cls_of[off]
    return tri, ebase, ecls


_TRI, _EBASE, _ECLS = _build_tables()


def _corner_lin(r1: int, r2: int, offsets: np.ndarray) -> np.ndarray:
    return offsets[:, 0] * (r1 * r2) + offsets[:, 1] * r2 + offsets[:, 2]


def _key_table(r1: int, r2: int) -> np.ndarray:
    """(6, 16, 2, 3) int64: KEY[tet, case, k, j] = D[base corner] * 7 + class
    of corner j of triangle k, D[c] the linear offset of cube corner c.  A
    triangle's canonical keys are its cell's base vertex * 7 plus these."""
    d = _corner_lin(r1, r2, _CORNERS)
    key = np.zeros((6, 16, 2, 3), np.int64)
    for t in range(6):
        key[t] = d[_EBASE[t][_TRI]] * 7 + _ECLS[t][_TRI]
    return key


def _corner_views(inside: torch.Tensor) -> list[torch.Tensor]:
    """The 8 corner masks of every cell: views of (..., r0, r1, r2) as
    (..., r0 - 1, r1 - 1, r2 - 1)."""
    r0, r1, r2 = inside.shape[-3:]
    return [inside[..., dx:r0 - 1 + dx, dy:r1 - 1 + dy, dz:r2 - 1 + dz]
            for dx, dy, dz in _CORNERS]


def _crossing(corners: list[torch.Tensor]) -> torch.Tensor:
    any_in = corners[0].clone()
    all_in = corners[0].clone()
    for c in corners[1:]:
        any_in |= c
        all_in &= c
    return any_in & ~all_in


def _batched(vol: torch.Tensor) -> torch.Tensor:
    if vol.ndim == 3:
        return vol[None]
    if vol.ndim != 4:
        raise ValueError(f"expected a (r0, r1, r2) or (B, r0, r1, r2) grid, got "
                         f"{tuple(vol.shape)}")
    return vol


def count_cells_and_faces(vol_b: torch.Tensor, level: float = 0.0):
    """(B, r0, r1, r2) -> (cells (B,), faces (B,)) int64: the active cells
    and the exact number of triangles the extraction emits, densely over
    the grid, each tetrahedron's count in the closed form min(k, 4 - k)
    with k its inside-corner count."""
    vol_b = _batched(vol_b)
    corners = _corner_views(vol_b.float() > level)
    b = vol_b.shape[0]
    cells = _crossing(corners).reshape(b, -1).sum(dim=1)
    ntri = torch.zeros(corners[0].shape, dtype=torch.int8, device=vol_b.device)
    for tet in _TETS:
        k = sum(corners[j].to(torch.int8) for j in tet)
        ntri += torch.minimum(k, 4 - k)
    return cells, ntri.reshape(b, -1).sum(dim=1, dtype=torch.int64)


def marching_tetrahedra_device(vol: torch.Tensor, level: float = 0.0) -> dict:
    """Extraction of a grid (r0, r1, r2), or of a batch (B, r0, r1, r2), on
    its device.  Returns the batch's triangle soup, sample after sample:
      corner_pos   (F, 3, 3) f32  triangle corner positions (grid coordinates)
      corner_nrm   (F, 3, 3) f32  unit -grad(vol) at each corner
      corner_key   (F, 3) int64   canonical edge key (base vertex * 7 + class);
                                  equal keys within a sample are one vertex
      face_offsets (B + 1,) int64 sample i owns faces [off[i], off[i + 1])
      n_faces, n_cells (B,) int64 the true counts
    The oracle's arithmetic (interpolation, normals, winding); the vertex
    dedup happens on the host (`mesh_to_host`)."""
    vol = _batched(vol).float()
    b, r0, r1, r2 = vol.shape
    dev = vol.device
    size = r0 * r1 * r2
    flat = vol.reshape(-1)
    inside = vol > level

    # ---- active cells, with their sample -----------------------------------
    cid = torch.nonzero(_crossing(_corner_views(inside)).reshape(-1)).squeeze(1)
    per_grid = (r0 - 1) * (r1 - 1) * (r2 - 1)
    csample, loc = cid // per_grid, cid % per_grid
    cx = loc // ((r1 - 1) * (r2 - 1))
    cy = (loc // (r2 - 1)) % (r1 - 1)
    cz = loc % (r2 - 1)
    vlin = cx * (r1 * r2) + cy * r2 + cz                       # base vertex
    d_off = torch.as_tensor(_corner_lin(r1, r2, _CORNERS), device=dev)
    corner_in = inside.reshape(-1)[(csample * size + vlin)[:, None] + d_off]   # (C, 8)

    # ---- triangles: (C, 6 tets, 2) candidates, compacted -------------------
    bits = corner_in[:, torch.as_tensor(_TETS, device=dev)].long()           # (C, 6, 4)
    case = (bits * torch.tensor([1, 2, 4, 8], device=dev)).sum(dim=-1)       # (C, 6)
    k = bits.sum(dim=-1)
    ntri = torch.minimum(k, 4 - k)
    exists = torch.arange(2, device=dev) < ntri[..., None]                   # (C, 6, 2)
    fslot = torch.nonzero(exists.reshape(-1)).squeeze(1)
    fcell, ftet, fk = fslot // 12, (fslot // 2) % 6, fslot % 2
    key_t = torch.as_tensor(_key_table(r1, r2), device=dev)
    keys = vlin[fcell, None] * 7 + key_t[ftet, case[fcell, ftet], fk]       # (F, 3)
    fsample = csample[fcell]

    # ---- per-corner geometry from the canonical keys -----------------------
    p, c = keys // 7, keys % 7
    q = p + torch.as_tensor(_corner_lin(r1, r2, _CLASS_OFFSETS), device=dev)[c]
    base = (fsample * size)[:, None]
    v0 = flat[base + p]
    v1 = flat[base + q]
    denom = v1 - v0
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    t = torch.clamp((level - v0) / denom, 0.0, 1.0)
    p0 = torch.stack([p // (r1 * r2), (p // r2) % r1, p % r2], dim=-1).float()
    off = torch.as_tensor(_CLASS_OFFSETS, dtype=torch.float32, device=dev)[c]
    pos = p0 + t[..., None] * off                                            # (F, 3, 3)

    # normals: -np.gradient(vol) at the rounded corner voxel (half to even),
    # central differences inside, one-sided at the borders
    dims = (r0, r1, r2)
    strides = (r1 * r2, r2, 1)
    vi = torch.round(pos).long()
    vi = torch.minimum(vi.clamp_min(0), torch.tensor([r0 - 1, r1 - 1, r2 - 1], device=dev))
    at = base + vi[..., 0] * strides[0] + vi[..., 1] * strides[1] + vi[..., 2]
    grads = []
    for ax in range(3):
        up = torch.clamp_max(vi[..., ax] + 1, dims[ax] - 1)
        dn = torch.clamp_min(vi[..., ax] - 1, 0)
        span = (up - dn).float()
        grads.append((flat[at + (up - vi[..., ax]) * strides[ax]]
                      - flat[at + (dn - vi[..., ax]) * strides[ax]])
                     / torch.where(span < 1.0, torch.ones_like(span), span))
    nrm = -torch.stack(grads, dim=-1)                                        # (F, 3, 3)
    norm = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.where(norm < 1e-12, torch.ones_like(norm), norm)

    # consistent winding: the face normal against the summed corner normals
    fn = torch.linalg.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    flip = torch.sum(fn * torch.sum(nrm, dim=1), dim=1) < 0
    swap = torch.tensor([0, 2, 1], device=dev)
    pos = torch.where(flip[:, None, None], pos[:, swap], pos)
    nrm = torch.where(flip[:, None, None], nrm[:, swap], nrm)
    keys = torch.where(flip[:, None], keys[:, swap], keys)

    n_faces = torch.bincount(fsample, minlength=b)
    return {"corner_pos": pos, "corner_nrm": nrm, "corner_key": keys,
            "face_offsets": torch.cat([n_faces.new_zeros(1), torch.cumsum(n_faces, 0)]),
            "n_faces": n_faces, "n_cells": torch.bincount(csample, minlength=b)}


def sample_points_from_mesh_device(mesh: dict, generator: torch.Generator,
                                   num_samples: int = 2048):
    """Area-weighted triangle choice and uniform barycentrics, for every
    sample of a batched mesh (`marching_tetrahedra_device`), drawn from
    `generator` (the face choice, then u, then v, each (B, num_samples)).
    Returns (points, normals), each (B, num_samples, 3), in the mesh's frame;
    normals are the faces' unit normals.  A sample with no face gets NaN.
    The running area sum is float64 over the batch, each sample's range
    taken from it."""
    pos = mesh["corner_pos"]
    off = mesh["face_offsets"]
    b = off.shape[0] - 1
    dev = pos.device
    v0, v1, v2 = pos[:, 0], pos[:, 1], pos[:, 2]
    cross = torch.linalg.cross(v1 - v0, v2 - v0)
    area = 0.5 * torch.linalg.vector_norm(cross, dim=1)
    cum = torch.cat([area.new_zeros(1, dtype=torch.float64),
                     torch.cumsum(area.double(), 0)])       # cum[i]: area before face i
    lo, hi = cum[off[:-1]], cum[off[1:]]
    shape = (b, num_samples)
    u01 = torch.rand(shape, generator=generator, device=generator.device).to(dev)
    target = lo[:, None] + u01.double() * (hi - lo)[:, None]
    sel = torch.searchsorted(cum[1:], target)               # first face whose end >= target
    sel = torch.minimum(torch.maximum(sel, off[:-1, None]),
                        torch.clamp_min(off[1:, None] - 1, 0))
    if pos.shape[0] == 0:
        sel = torch.zeros_like(sel)
        v0 = v1 = v2 = cross = torch.full((1, 3), float("nan"), device=dev)
    u = torch.rand(shape, generator=generator, device=generator.device).to(dev)
    v = torch.rand(shape, generator=generator, device=generator.device).to(dev)
    over = u + v > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    w = 1.0 - u - v
    pts = w[..., None] * v0[sel] + u[..., None] * v1[sel] + v[..., None] * v2[sel]
    n = cross[sel]
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    empty = (mesh["n_faces"] == 0)[:, None, None]
    nan = torch.full_like(pts, float("nan"))
    return torch.where(empty, nan, pts), torch.where(empty, nan, n)


def extract_and_sample_device(psr_grid: torch.Tensor, generator: torch.Generator,
                              num_samples: int = 2048):
    """Batched grid (B, r, r, r) -> sampled surface clouds of its level-0
    surface, on the grid's device.  Corner positions are divided by r
    (into [0, 1)) before sampling, as `marching.py::mc_from_psr` scales its
    vertices by default.

    Returns (points (B, S, 3), normals (B, S, 3), n_faces (B,), n_cells (B,),
    mesh): the true counts, and the scaled mesh for `mesh_to_host`.  The
    JAX function returns an overflow flag where this returns the mesh: with
    no budgets nothing overflows (module docstring)."""
    s = psr_grid.shape[-1]
    mesh = marching_tetrahedra_device(psr_grid)
    mesh["corner_pos"] = mesh["corner_pos"] / float(s)
    pts, nrm = sample_points_from_mesh_device(mesh, generator, num_samples)
    return pts, nrm, mesh["n_faces"], mesh["n_cells"], mesh


def mesh_to_host(mesh: dict, index: int):
    """One sample of a batched mesh as (verts (V, 3), faces (F, 3) int64,
    normals (V, 3)) numpy arrays: its faces copied to the host, corners
    unified by canonical edge key, degenerate faces dropped; the content of
    the numpy oracle's mesh (counterpart: `device_mesh_to_host`).  Raises
    ValueError on an empty surface."""
    lo, hi = (int(x) for x in mesh["face_offsets"][index:index + 2].tolist())
    if hi == lo:
        raise ValueError("level surface is empty")
    keys = mesh["corner_key"][lo:hi].cpu().numpy()
    pos = mesh["corner_pos"][lo:hi].cpu().numpy()
    nrm = mesh["corner_nrm"][lo:hi].cpu().numpy()
    uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int64)
    verts = np.zeros((len(uniq), 3), np.float32)
    normals = np.zeros((len(uniq), 3), np.float32)
    verts[inv] = pos.reshape(-1, 3)
    normals[inv] = nrm.reshape(-1, 3)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return verts, faces[good], normals
