"""ShapeNet-PSR dataset (counterpart: `slide_tpu/data/shapenet_psr.py`, a
copy with numpy and `random` only; `metadata.yaml` is read without PyYAML,
by `synthetic.parse_metadata`).  Same seeds, same samples.

Layout on disk (same as the reference):
  <root>/metadata.yaml                          category -> {id, name}
  <root>/<synset>/{train,val,test}.lst          model ids, one per line
  <root>/<synset>/<model>/pointcloud.npz        points (100k, 3), normals
  <root>/<synset>/<model>/psr.npz               psr (128, 128, 128)  [optional]

Semantics preserved: stable 13-class label indices from the SORTED metadata
keys; per-epoch random 2048-point subsample; optional centroid centering;
augmentation (mirror-z / noise / translation / scale); final x2*scale scaling;
`repeat_dataset`; manual rank sharding with shuffle-before-split and
append-to-last-rank (`shapenet_psr_dataset.py:96-127`).
"""

from __future__ import annotations

import os
import random
from typing import Optional, Sequence

import numpy as np

from slide_tpu_torch.data.synthetic import parse_metadata


def load_metadata(dataset_folder: str) -> dict:
    """metadata.yaml with stable label indices assigned over SORTED category
    ids (`shapenet_psr_dataset.py:54-67`)."""
    with open(os.path.join(dataset_folder, "metadata.yaml")) as f:
        metadata = parse_metadata(f.read())
    for idx, c in enumerate(sorted(metadata.keys())):
        metadata[c]["idx"] = idx
    return metadata


def augment_points_with_normal(points: np.ndarray, normals: np.ndarray,
                               augmentation, rng: random.Random | None = None,
                               nprng: np.random.Generator | None = None):
    """Training augmentation (`shapenet_psr_dataset.py:192-216`): mirror about
    the z axis through the centroid with prob `mirror_prob`, gaussian noise on
    points+normals, global translation, uniform scale in [1/s, s]."""
    rng = rng or random
    nprng = nprng or np.random.default_rng()
    if isinstance(augmentation, dict):
        if augmentation.get("mirror_prob", 0) > 0 and rng.random() < augmentation["mirror_prob"]:
            axis = 2
            center = np.mean(points, axis=0, keepdims=True)
            points = points - center
            points[:, axis] = -points[:, axis]
            points = points + center
            normals = normals.copy()
            normals[:, axis] = -normals[:, axis]
        nm = augmentation.get("noise_magnitude", 0)
        if nm > 0:
            points = points + nm * nprng.standard_normal(points.shape).astype(points.dtype)
            normals = normals + nm * nprng.standard_normal(normals.shape).astype(normals.dtype)
        tm = augmentation.get("translation_magnitude", 0)
        if tm > 0:
            points = points + (tm * nprng.standard_normal((1, 3))).astype(points.dtype)
        sc = augmentation.get("augm_scale", 0)
        if sc > 1:
            points = points * rng.uniform(1.0 / sc, sc)
    return points, normals


class ShapesPSRDataset:
    def __init__(self, dataset_folder: str, split: Optional[str] = None,
                 categories: Optional[Sequence[str]] = None, scale: float = 1,
                 num_gt_points: int = 2048, rank: int = 0, world_size: int = 1,
                 append_samples_to_last_rank: bool = True,
                 shuffle_before_rank_split: bool = True, load_psr: bool = False,
                 augmentation=False, random_subsample: bool = False,
                 num_samples: int = 1000, repeat_dataset: int = 1,
                 centered_to_centroid: bool = True,
                 seed: Optional[int] = None):
        if split not in (None, "train", "val", "test"):
            raise ValueError(f"split {split} not supported")
        if repeat_dataset > 1:
            if split != "train":
                raise ValueError("repeat_dataset only for the train split")
            if random_subsample:
                repeat_dataset = 1
        self.dataset_folder = dataset_folder
        self.num_gt_points = num_gt_points
        self.scale = scale
        self.load_psr = load_psr
        self.augmentation = augmentation
        self.centered_to_centroid = centered_to_centroid
        self._rng = random.Random(seed)
        self._nprng = np.random.default_rng(seed)

        self.metadata = load_metadata(dataset_folder)
        split_list = [split] if isinstance(split, str) else ["train", "val", "test"]

        if categories is None:
            categories = sorted(self.metadata.keys())
        self.models = []
        for c in categories:
            for sp in split_list:
                with open(os.path.join(dataset_folder, c, sp + ".lst")) as f:
                    names = [m for m in f.read().split("\n") if m]
                self.models += [{"category": c, "model": m} for m in names]

        if repeat_dataset > 1:
            self.models = self.models * repeat_dataset

        if random_subsample:
            self.models = self._rng.sample(self.models, num_samples)

        total = len(self.models)
        if world_size > 1:
            if shuffle_before_rank_split:
                self._rng.shuffle(self.models)
            per_rank = int(np.ceil(total / world_size))
            start, end = rank * per_rank, (rank + 1) * per_rank
            if rank == world_size - 1:
                idx = list(range(start, total))
                missing = end - total
                if missing > 0 and append_samples_to_last_rank:
                    idx += self._rng.sample(range(total), missing)
            else:
                idx = list(range(start, end))
            self.models = [self.models[i] for i in idx]
            self.num_samples_per_rank = per_rank
        else:
            self.num_samples_per_rank = total

    def __len__(self):
        return len(self.models)

    def __getitem__(self, idx: int) -> dict:
        category = self.models[idx]["category"]
        model = self.models[idx]["model"]
        meta = self.metadata[category]
        model_path = os.path.join(self.dataset_folder, category, model)

        with np.load(os.path.join(model_path, "pointcloud.npz")) as d:
            points = d["points"].astype(np.float32)
            normals = d["normals"].astype(np.float32)

        sel = self._nprng.choice(points.shape[0], self.num_gt_points, replace=False)
        points, normals = points[sel], normals[sel]
        if self.centered_to_centroid:
            points = points - points.mean(axis=0, keepdims=True)
        points, normals = augment_points_with_normal(points, normals,
                                                     self.augmentation,
                                                     self._rng, self._nprng)
        points = points * self.scale * 2     # roughly [-scale, scale]

        data = {
            "points": points, "normals": normals, "label": meta["idx"],
            "category": category,
            "category_name": meta["name"].split(",")[0], "model": model,
        }
        if self.load_psr:
            with np.load(os.path.join(model_path, "psr.npz")) as d:
                data["psr"] = d["psr"].astype(np.float32)
        return data
