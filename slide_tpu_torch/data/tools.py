"""Dataset helper tools (counterpart: `slide_tpu/data/tools.py`): bounding
boxes, the label remap of generated npz files, the reference-format export
of a split, the loader's throughput and the per-split model counts.  Numpy
and the port's data layer only."""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np

from slide_tpu_torch.data.loader import BatchLoader
from slide_tpu_torch.data.shapenet_psr import ShapesPSRDataset, load_metadata


def get_bounding_box(points) -> dict:
    """Axis-aligned bounding box of (B, N, 3) or (N, 3) points: max, min,
    center, length and centroid, reduced over the point axis."""
    pts = np.asarray(points)
    if pts.ndim == 3:
        axis = 1
    elif pts.ndim == 2:
        axis = 0
    else:
        raise ValueError(f"points must be (B, N, C) or (N, C), got {pts.shape}")
    minn = pts.min(axis=axis)
    maxx = pts.max(axis=axis)
    return {"max": maxx, "min": minn, "center": (maxx + minn) / 2,
            "length": maxx - minn, "centroid": pts.mean(axis=axis)}


def remap_labels_to_sorted(npz_file: str, dataset_folder: str,
                           out_file: Optional[str] = None) -> str:
    """Remap a generated npz's labels from the dataset folder's
    `os.listdir` order to the sorted-category order; written next to the
    input as <name>_corrected.npz unless `out_file` is given."""
    categories = [c for c in os.listdir(dataset_folder)
                  if os.path.isdir(os.path.join(dataset_folder, c))]
    order = {c: i for i, c in enumerate(sorted(categories))}
    with np.load(npz_file) as d:
        data = {k: d[k] for k in d.files}
    data["label"] = np.array([order[categories[int(l)]] for l in data["label"]])
    if out_file is None:
        root, ext = os.path.splitext(npz_file)
        out_file = root + "_corrected" + (ext or ".npz")
    np.savez(out_file, **data)
    return out_file


def save_reference_data(data_dir: str, out_npz: str, split: str = "val",
                        categories: Optional[Sequence[str]] = None,
                        npoints: int = 2048, scale: float = 1,
                        num_samples: Optional[int] = None, seed: int = 0) -> str:
    """Export a split as a reference-format npz (points, normals, label,
    category, category_name): the validation sets the evaluations read."""
    ds = ShapesPSRDataset(data_dir, split=split, categories=categories, scale=scale,
                          num_gt_points=npoints, centered_to_centroid=False, seed=seed,
                          random_subsample=num_samples is not None,
                          num_samples=num_samples or 0)
    acc = {"points": [], "normals": [], "label": [], "category": [], "category_name": []}
    for i in range(len(ds)):
        d = ds[i]
        for k in acc:
            acc[k].append(d[k])
    np.savez(out_npz, points=np.stack(acc["points"]), normals=np.stack(acc["normals"]),
             label=np.asarray(acc["label"]), category=np.asarray(acc["category"]),
             category_name=np.asarray(acc["category_name"]))
    return out_npz


def dataset_throughput(dataset, batch_size: int = 32, n_batches: int = 10,
                       seed: int = 0) -> dict:
    """Samples per second of a shuffled loader over `dataset`, for
    `n_batches` batches."""
    loader = BatchLoader(dataset, batch_size, shuffle=True, seed=seed)
    t0 = time.perf_counter()
    n = 0
    for i, batch in enumerate(loader):
        n += len(batch["label"])
        if i + 1 >= n_batches:
            break
    dt = time.perf_counter() - t0
    return {"samples": n, "seconds": dt, "samples_per_sec": n / dt}


def count_samples(data_dir: str, categories: Optional[Sequence[str]] = None) -> dict:
    """Per category, the models of each split and their total."""
    metadata = load_metadata(data_dir)
    categories = list(categories) if categories else sorted(metadata.keys())
    out = {}
    for c in categories:
        counts = {}
        for split in ("train", "val", "test"):
            path = os.path.join(data_dir, c, split + ".lst")
            if os.path.isfile(path):
                with open(path) as f:
                    counts[split] = len([m for m in f.read().split("\n") if m])
            else:
                counts[split] = 0
        counts["total"] = sum(counts.values())
        out[c] = counts
    return out
