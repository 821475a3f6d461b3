"""ASCII PLY writers (counterpart: `slide_tpu/vis/ply.py`, a numpy copy):
meshes with optional vertex normals, point clouds with optional normals
and colours, the mirror indicator coloured as there (real points green,
mirrored red)."""

from __future__ import annotations

import os

import numpy as np


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                  normals: np.ndarray | None = None):
    """ASCII PLY triangle mesh with optional per-vertex normals."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    has_n = normals is not None
    if has_n:
        normals = np.asarray(normals, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_n:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if has_n:
            for v, n in zip(verts, normals):
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                        f"{n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        else:
            for v in verts:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def save_pcd_ply(path: str, points: np.ndarray,
                 normals: np.ndarray | None = None,
                 colors: np.ndarray | None = None,
                 indicator: np.ndarray | None = None):
    """ASCII PLY point cloud; `indicator` (+1 real / -1 mirrored) colours the
    points green / red."""
    points = np.asarray(points, np.float32)
    if indicator is not None and colors is None:
        colors = np.zeros((len(points), 3), np.uint8)
        colors[np.asarray(indicator) > 0] = (0, 255, 0)
        colors[np.asarray(indicator) <= 0] = (255, 0, 0)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(points):
            row = f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            if normals is not None:
                n = normals[i]
                row += f" {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")


def batch_save_pcd(save_dir: str, prefix: str, points, batch_info=None,
                   normals=None, indicator=None, start_idx: int = 0):
    """One PLY per shape of a (B, N, 3) batch, named
    <batch_info[i] or prefix>_<start_idx + i, 5 digits>.ply."""
    os.makedirs(save_dir, exist_ok=True)
    points = np.asarray(points)
    for i in range(points.shape[0]):
        tag = batch_info[i] if batch_info is not None else prefix
        name = os.path.join(save_dir, f"{tag}_{str(start_idx + i).zfill(5)}.ply")
        save_pcd_ply(
            name, points[i],
            normals=None if normals is None else np.asarray(normals)[i],
            indicator=None if indicator is None else np.asarray(indicator)[i])
