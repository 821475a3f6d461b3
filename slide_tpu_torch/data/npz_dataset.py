"""npz-backed datasets (counterpart: `slide_tpu/data/npz_dataset.py`, a
copy): any stage's npz output drives the next stage's input.  Same seeds,
same noise and the same split over ranks as the JAX package."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


class ShapeNpzDataset:
    """points (B, N, 6) + label npz; splits xyz and normals, adds per-item
    gaussian noise, rescales by `scale`."""

    def __init__(self, data_dir: str, scale: float = 1,
                 noise_magnitude: float = 0.025, rank: int = 0,
                 world_size: int = 1, seed: Optional[int] = None):
        with np.load(data_dir) as data:
            input_data = data["points"]
            self.labels = data["label"]
        self.noise_magnitude = noise_magnitude
        self.scale = scale
        self._nprng = np.random.default_rng(seed)
        if world_size > 1:
            per = int(np.ceil(input_data.shape[0] / world_size))
            input_data = input_data[rank * per:(rank + 1) * per]
            self.labels = self.labels[rank * per:(rank + 1) * per]
            self.num_samples_per_rank = per
        else:
            self.num_samples_per_rank = input_data.shape[0]
        self.points = input_data[:, :, 0:3] / 2 / scale
        self.normals = input_data[:, :, 3:]

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, index):
        points = self.points[index]
        normals = self.normals[index]
        if self.noise_magnitude > 0:
            points = points + self.noise_magnitude * \
                self._nprng.standard_normal(points.shape).astype(np.float32)
            normals = normals + self.noise_magnitude * \
                self._nprng.standard_normal(normals.shape).astype(np.float32)
        points = points * self.scale * 2
        return {"points": points, "normals": normals, "label": self.labels[index]}


class GeneralNpzDataset:
    """Arbitrary-key npz dataset with optional last-dim splitting of the main
    key, e.g. points (..., 6) -> points + normals."""

    NEED_SCALE = ("points",)
    NEED_NOISE = ("points", "normals")

    def __init__(self, data_dir: str, scale: float = 1,
                 noise_magnitude: float = 0.025, rank: int = 0,
                 world_size: int = 1, data_key: str = "points",
                 data_key_split_names: Optional[Sequence[str]] = None,
                 data_key_split_dims: Optional[Sequence[int]] = None,
                 seed: Optional[int] = None):
        with np.load(data_dir) as data:
            self.data_dict = {name: data[name] for name in data.files}
        if data_key in self.data_dict and data_key_split_names is not None:
            # split independent of npz key ORDER: real keys always win over
            # split-derived slices, and slices beyond the stored width are
            # dropped rather than materialized as zero-width arrays (e.g.
            # points(…,3) + a real 'normals' key under split_dims [0,3,6])
            src = self.data_dict.pop(data_key)
            width = src.shape[-1]
            for i, split_name in enumerate(data_key_split_names):
                s, e = data_key_split_dims[i], data_key_split_dims[i + 1]
                if split_name in self.data_dict or s >= width:
                    continue
                self.data_dict[split_name] = src[..., s:min(e, width)]
            data_key = data_key_split_names[0]
        self.noise_magnitude = noise_magnitude
        self.scale = scale
        self._nprng = np.random.default_rng(seed)

        n = self.data_dict[data_key].shape[0]
        if world_size > 1:
            per = int(np.ceil(n / world_size))
            for k in self.data_dict:
                self.data_dict[k] = self.data_dict[k][rank * per:(rank + 1) * per]
            self.num_samples_per_rank = per
        else:
            self.num_samples_per_rank = n
        for k in self.NEED_SCALE:
            if k in self.data_dict:
                self.data_dict[k] = self.data_dict[k] * scale
        self._len = self.data_dict[data_key].shape[0]

    def __len__(self):
        return self._len

    def __getitem__(self, index):
        out = {k: v[index] for k, v in self.data_dict.items()}
        if self.noise_magnitude > 0:
            for k in self.NEED_NOISE:
                if k in out:
                    out[k] = out[k] + self.noise_magnitude * \
                        self._nprng.standard_normal(out[k].shape).astype(out[k].dtype)
        return out
