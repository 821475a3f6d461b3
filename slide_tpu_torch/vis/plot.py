"""Matplotlib point-cloud renders (counterpart: `slide_tpu/vis/plot.py`).
matplotlib is imported inside the functions, where it is used."""

from __future__ import annotations

import os

import numpy as np


def plot_pcd(points: np.ndarray, out_png: str, *, elev: float = 20,
             azim: float = -70, size: float = 2.0, color=None,
             title: str | None = None) -> str:
    """Render one (N, 3+) cloud to a PNG (the first 3 channels are xyz)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)[:, :3]
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(pts[:, 0], pts[:, 2], pts[:, 1], s=size,
               c="#1f77b4" if color is None else color, depthshade=True)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    lim = np.abs(pts).max() * 1.05
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim, lim)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_npz(npz_path: str, out_dir: str | None = None, max_shapes: int = 16):
    """Render up to `max_shapes` shapes of a generated-data npz to PNGs."""
    out_dir = out_dir or os.path.splitext(npz_path)[0] + "_renders"
    os.makedirs(out_dir, exist_ok=True)
    with np.load(npz_path) as d:
        points = d["points"]
        names = d["category_name"] if "category_name" in d.files else None
    outs = []
    for i in range(min(points.shape[0], max_shapes)):
        name = names[i] if names is not None else "shape"
        outs.append(plot_pcd(points[i], os.path.join(out_dir, f"{name}_{i:03d}.png"),
                             title=str(name)))
    return outs
