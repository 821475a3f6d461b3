"""npz -> .xyz visualization dumps (counterpart: `slide_tpu/vis/pcd.py`,
a copy: the same files, byte for byte)."""

from __future__ import annotations

import os
import pickle

import numpy as np


def visualize_pcd(pcd_file: str, include_idx_to_save_name: bool = True) -> str:
    """Dump each shape of a generated-data npz into per-shape .xyz files under
    `<file>_visualization/`, with its keypoints and gt_points where the npz
    has them.  Returns that directory."""
    file_path, file_name = os.path.split(pcd_file)
    file_name = os.path.splitext(file_name)[0]
    save_dir = os.path.join(file_path, file_name + "_visualization")
    os.makedirs(save_dir, exist_ok=True)

    with np.load(pcd_file) as data:
        points = data["points"]
        if "normals" in data.files:
            points = np.concatenate([points, data["normals"]], axis=2)
        label = data["label"] if "label" in data.files else -np.ones(points.shape[0])
        category_name = data["category_name"] if "category_name" in data.files else None
        extras = {k: data[k] for k in ("keypoint", "gt_points") if k in data.files}

    for idx in range(points.shape[0]):
        name = category_name[idx] if category_name is not None else "shape"

        def fname(suffix=""):
            if include_idx_to_save_name:
                return os.path.join(save_dir, "pcd_%s_label_%s_%s%s.xyz" % (
                    str(idx).zfill(3), str(label[idx]).zfill(2), name, suffix))
            return os.path.join(save_dir, "label_%s_%s%s.xyz" % (
                str(label[idx]).zfill(2), name, suffix))
        np.savetxt(fname(), points[idx], delimiter=" ")
        for key, arr in extras.items():
            np.savetxt(fname("_" + key), arr[idx], delimiter=" ")
    return save_dir


def visualize_hierarchical_pcd(pickle_file: str, offset: float = 1.5) -> str:
    """Dump the autoencoder's per-level reconstruction pickle (a list of
    (B, N_l, C) arrays, coarse to fine, or a dict holding it under "l_xyz")
    into one .xyz file a shape, each level moved `offset` further along x.
    Returns the directory."""
    file_path, file_name = os.path.split(pickle_file)
    file_name = os.path.splitext(file_name)[0]
    save_dir = os.path.join(file_path, file_name + "_visualization")
    os.makedirs(save_dir, exist_ok=True)
    with open(pickle_file, "rb") as f:
        payload = pickle.load(f)
    levels = payload["l_xyz"] if isinstance(payload, dict) else payload
    b = levels[0].shape[0]
    for idx in range(b):
        rows = []
        for li, lvl in enumerate(levels):
            pts = np.asarray(lvl[idx][:, :3], np.float64).copy()
            pts[:, 0] += offset * li
            rows.append(pts)
        np.savetxt(os.path.join(save_dir, f"hierarchy_{str(idx).zfill(3)}.xyz"),
                   np.concatenate(rows, axis=0), delimiter=" ")
    return save_dir
